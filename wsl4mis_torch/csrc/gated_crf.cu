// Gated CRF neighbourhood contraction, for Hopper (sm_90a). Replaces
// _gcrf_kernel (wsl4mis_tpu/ops/pallas/gated_crf_pallas.py:37).
//
// For every pixel x of every image and every non-centre offset o of the
// (2r+1) x (2r+1) window:
//   k(x, o)   = sum_d w_d * exp(-0.5 * ||f_d(x+o) - f_d(x)||^2)
//   prod_c(x) = sum_o k(x, o) * p_c(x+o)
//   ksum      = sum_{x, o} k(x, o)
// with descriptor d's features f_d = [x / s_d, y / s_d] (when it has an xy
// sigma s_d) followed by its stored channels (those whose desc_of entry is
// d), and the features and probabilities p ZERO outside the image. The zero
// padding is part of the function: a border pixel's kernel against an
// outside neighbour is w * exp(-0.5 * ||f(x)||^2), which adds to ksum and
// nothing to prod. So outside offsets are not skipped, and the distance is
// always taken between feature values as they would be stored.
//
// The TPU kernel holds one whole zero-padded image in VMEM per program and
// unrolls the offsets statically as shifted windows; none of that is carried
// over. Here a block owns one 32 x 32 tile of one image and stages the tile
// plus its r-halo of the probabilities (one float4 per pixel and 4 classes)
// and of the stored feature channels in shared memory, zero outside the
// image, with coalesced loads. The xy features are never read: each is
// __fdiv_rn(coordinate, s_d), IEEE division as torch.arange(w) / s does it,
// built once per block into a row and a column table.
//
// What bounds it on the H100: arithmetic. Per pixel and offset it does about
// 15 f32 instructions on the default descriptor (two differences and
// squares, the exp, 4 multiply-adds for prod, one add for sum k) on data it
// has staged; it moves only 4 (2 C + F) bytes per pixel in all. The design
// spends shared-memory traffic and issue slots on that arithmetic only:
// - Register blocking: each thread owns P = 4 horizontally adjacent pixels
//   and slides its neighbour values across dx, so one neighbour load (a
//   float4 of probabilities and one feature word) serves up to 4
//   pixel-offsets. The y part of the distance is the same for the 4 pixels
//   and is formed once per window row.
// - Bank conflicts: a warp covers 8 rows x 4 pixel groups (8 columns
//   apart); the float4 plane has an odd pitch and the feature planes a
//   pitch of 1 mod 8 words, so both loads are conflict-free.
// - The default descriptor list (xy and the image, 4 classes) at the
//   training radius 5 is compiled for that radius: its staging issues
//   every load before any store, its neighbour loops unroll with static
//   bounds, the thread's neighbour x features stay in registers, a window
//   row of zero padding costs one exp per pixel, and the weight multiplies
//   the sums once. Its exp is exp2f(d^2 * (-0.5 log2 e)): one rounding more
//   than expf(-0.5 d^2), within every check's limit. Any other list or
//   radius takes the general instantiation, with expf.
// - Waves: 256 threads and at most 85 registers a thread on the default
//   path, so 3 blocks fit an SM; a batch-6 256 x 256 call is 384 blocks,
//   one wave on 132 SMs.
// The block's sum of k is reduced in a fixed order into one f32 partial per
// block; a second kernel of the same entry point folds each image's
// partials in f64 in a fixed order: no atomics, deterministic.
//
// No fast-math anywhere: the loss is a difference of large sums.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TW = 32;             // tile width
constexpr int TH = 32;             // tile height
constexpr int P = 4;               // adjacent pixels per thread
constexpr int NT = TW * TH / P;    // threads per block
constexpr int MAX_C = 8;           // classes
constexpr int MAX_F = 8;           // stored feature channels
constexpr int MAX_D = 4;           // descriptors
constexpr size_t MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int FOLD_THREADS = 128;
constexpr int DEFAULT_R = 5;       // the pce_gatedcrf radius, compiled in

struct Desc {
  int nd;
  float w[MAX_D];
  float xy[MAX_D];     // sigma of the xy features, 0: none
  int desc_of[MAX_F];  // descriptor of each stored feature channel
};

// Shared-memory geometry at radius r: planes of (TH + 2r) rows; the float4
// probability planes have an odd row pitch, the feature planes one of
// 1 mod 8 words (conflict-free for a warp's 8 rows x 4 groups 8 apart).
struct Geom {
  int ph, pw, pwp, pwf;
  __host__ __device__ explicit Geom(int r)
      : ph(TH + 2 * r),
        pw(TW + 2 * r),
        pwp((TW + 2 * r) | 1),
        pwf(((TW + 2 * r + 6) & ~7) + 1) {}
  // bytes for `ncp` (padded) classes, nf feature planes, nd descriptors
  __host__ __device__ size_t bytes(int ncp, int nf, int nd) const {
    return sizeof(float) * ((size_t)ncp * ph * pwp + (size_t)nf * ph * pwf +
                            (size_t)nd * (pw + ph));
  }
};

// The offset loop of the general case: nf stored channels and nd
// descriptors, each with or without xy, the radius r at run time. gx0, gy0:
// the image column and row of the thread's first neighbour (offset -r, -r
// of its first pixel). Adds to acc (k * p) and ks (k) of the P pixels.
template <int NCP, int NF, int ND>
__device__ __forceinline__ void general_offsets(
    const float4* s_p, const float* s_f, const float* s_x, const float* s_y,
    const Geom& g, int gx0, int gy0, int ty, int tx, int H, int W, int nf,
    int r, const Desc& desc, float (&acc)[P][NCP], float (&ks)[P]) {
  constexpr int NQ = NCP / 4;
  const int nd = desc.nd;
  bool has_xy[ND];
  float w[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    has_xy[d] = d < nd && desc.xy[d] != 0.f;
    w[d] = d < nd ? desc.w[d] : 0.f;
  }
  float fc[P][NF];  // centre features
  float xc[ND][P];  // centre x features
  float yc[ND];     // centre y feature (one row)
#pragma unroll
  for (int k = 0; k < P; ++k) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      fc[k][f] = f < nf ? s_f[(f * g.ph + ty + r) * g.pwf + tx + k + r] : 0.f;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    yc[d] = has_xy[d] ? s_y[d * g.ph + ty + r] : 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k)
      xc[d][k] = has_xy[d] ? s_x[d * g.pw + tx + k + r] : 0.f;
  }

  const int span = 2 * r;
  for (int dy = 0; dy <= span; ++dy) {
    const int srow = ty + dy;
    const bool rin = (unsigned)(gy0 + dy) < (unsigned)H;
    // y part of the distance, the same for the P pixels: against an
    // in-image neighbour and against the zero padding
    float y_in[ND], y_out[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float t = has_xy[d] ? s_y[d * g.ph + srow] - yc[d] : 0.f;
      y_in[d] = t * t;
      y_out[d] = yc[d] * yc[d];
    }
    const float4* prow = s_p + srow * g.pwp + tx;
    const float* frow = s_f + srow * g.pwf + tx;
    for (int m = 0; m < span + P; ++m) {
      const bool nin = rin && (unsigned)(gx0 + m) < (unsigned)W;
      float pn[NCP];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 v = prow[q * g.ph * g.pwp + m];
        pn[4 * q] = v.x;
        pn[4 * q + 1] = v.y;
        pn[4 * q + 2] = v.z;
        pn[4 * q + 3] = v.w;
      }
      float fn[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f)
        fn[f] = f < nf ? frow[f * g.ph * g.pwf + m] : 0.f;
      float xn[ND], yd[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        xn[d] = has_xy[d] && rin ? s_x[d * g.pw + tx + m] : 0.f;
        yd[d] = nin ? y_in[d] : y_out[d];
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int dx = m - k;
        if (dx < 0 || dx > span || (dy == r && dx == r)) continue;
        float sq[ND];
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const float t = xn[d] - xc[d][k];
          sq[d] = has_xy[d] ? fmaf(t, t, yd[d]) : 0.f;
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          if (f < nf) {
            const float t = fn[f] - fc[k][f];
#pragma unroll
            for (int d = 0; d < ND; ++d)
              if (desc.desc_of[f] == d) sq[d] = fmaf(t, t, sq[d]);
          }
        }
        float kk = 0.f;
#pragma unroll
        for (int d = 0; d < ND; ++d)
          if (d < nd) kk = fmaf(w[d], expf(-0.5f * sq[d]), kk);
        ks[k] += kk;
#pragma unroll
        for (int c = 0; c < NCP; ++c) acc[k][c] = fmaf(kk, pn[c], acc[k][c]);
      }
    }
  }
}

// The offset loop of the default descriptor list (xy and one stored
// channel, 4 classes) at the compile-time radius R: every neighbour load
// and bound is static, the thread's 2R + P neighbour x features stay in
// registers, and a window row of zero padding (above or below the image)
// is one exp per pixel. Adds exp(-0.5 d^2) UNWEIGHTED to acc and ks, as
// exp2f(d^2 * (-0.5 log2 e)).
template <int R>
__device__ __forceinline__ void default_offsets(
    const float4* s_p, const float* s_f, const float* s_x, const float* s_y,
    const Geom& g, int gx0, int gy0, int ty, int tx, int H, int W,
    float (&acc)[P][4], float (&ks)[P]) {
  constexpr int SPAN = 2 * R;
  constexpr int NM = SPAN + P;  // neighbour columns of the P pixels
  constexpr float C2 = -0.72134752044448170368f;  // -0.5 * log2(e)
  float xn[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) xn[m] = s_x[tx + m];
  float xc[P], fc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    xc[k] = xn[k + R];
    fc[k] = s_f[(ty + R) * g.pwf + tx + k + R];
  }
  const float yc = s_y[ty + R];
  const float y_out = yc * yc;

  for (int dy = 0; dy <= SPAN; ++dy) {
    const int srow = ty + dy;
    if ((unsigned)(gy0 + dy) >= (unsigned)H) {
      // a row of zero padding: the same kernel value at every dx
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float sq = fmaf(fc[k], fc[k], fmaf(xc[k], xc[k], y_out));
        const float e = exp2f(sq * C2);
#pragma unroll
        for (int dx = 0; dx <= SPAN; ++dx) ks[k] += e;
      }
      continue;
    }
    const float t = s_y[srow] - yc;
    const float y_in = t * t;
    const float4* prow = s_p + srow * g.pwp + tx;
    const float* frow = s_f + srow * g.pwf + tx;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float4 pv = prow[m];
      const float fn = frow[m];
      const float yd = (unsigned)(gx0 + m) < (unsigned)W ? y_in : y_out;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int dx = m - k;
        if (dx < 0 || dx > SPAN) continue;
        if (dx == R && dy == R) continue;  // the centre
        const float xd = xn[m] - xc[k];
        const float fd = fn - fc[k];
        const float e = exp2f(fmaf(fd, fd, fmaf(xd, xd, yd)) * C2);
        ks[k] += e;
        acc[k][0] = fmaf(e, pv.x, acc[k][0]);
        acc[k][1] = fmaf(e, pv.y, acc[k][1]);
        acc[k][2] = fmaf(e, pv.z, acc[k][2]);
        acc[k][3] = fmaf(e, pv.w, acc[k][3]);
      }
    }
  }
}

// NCP: classes padded to 4 or 8. R >= 0: the default descriptor list (one
// descriptor with xy and one stored channel), C == 4 and radius R, with
// compile-time sizes; R < 0: NF, ND are upper bounds and the sizes and the
// radius come from the arguments.
template <int NCP, int NF, int ND, int R>
__global__ void __launch_bounds__(NT, R >= 0 ? 3 : 1)
    gated_crf_kernel(const float* __restrict__ probs,
                     const float* __restrict__ feats,
                     float* __restrict__ prod, float* __restrict__ ksum_part,
                     int H, int W, int C, int F, int r, Desc desc) {
  extern __shared__ float4 smem4[];
  __shared__ float s_red[NT / 32];

  constexpr bool DEF = R >= 0;
  if (DEF) r = R;  // the geometry becomes compile-time
  constexpr int NQ = NCP / 4;  // float4 probability planes
  const int nc = DEF ? 4 : C;
  const int nf = DEF ? 1 : F;
  const int nd = DEF ? 1 : desc.nd;
  const Geom g(r);
  float4* s_p = smem4;                                        // [NQ][ph][pwp]
  float* s_f = reinterpret_cast<float*>(s_p + NQ * g.ph * g.pwp);  // [nf][ph][pwf]
  float* s_x = s_f + nf * g.ph * g.pwf;                       // [nd][pw]
  float* s_y = s_x + nd * g.pw;                               // [nd][ph]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const size_t img_px = (size_t)H * W;
  const float* pb = probs + (size_t)b * img_px * nc;
  const float* fb = feats + (size_t)b * img_px * nf;

  // ---- stage the tile + halo ----
  if constexpr (DEF) {
    // every load first, then every store: a block waits for memory once
    constexpr int NPIX = (TH + 2 * R) * (TW + 2 * R);
    constexpr int NIT = (NPIX + NT - 1) / NT;
    float4 pv[NIT];
    float fv[NIT];
#pragma unroll
    for (int n = 0; n < NIT; ++n) {
      const int i = tid + n * NT;
      const int row = i / (TW + 2 * R);
      const int gy = y0 + row - R;
      const int gx = x0 + i - row * (TW + 2 * R) - R;
      const bool in = i < NPIX && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t at = (size_t)gy * W + gx;
      pv[n] = in ? __ldg(reinterpret_cast<const float4*>(pb) + at)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      fv[n] = in ? __ldg(fb + at) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NIT; ++n) {
      const int i = tid + n * NT;
      const int row = i / (TW + 2 * R);
      const int col = i - row * (TW + 2 * R);
      if (i < NPIX) {
        s_p[row * g.pwp + col] = pv[n];
        s_f[row * g.pwf + col] = fv[n];
      }
    }
  } else {
    // a warp per row, lanes along it
    for (int row = warp; row < g.ph; row += NT / 32) {
      const int gy = y0 + row - r;
      const bool rin = gy >= 0 && gy < H;
      for (int col = lane; col < g.pw; col += 32) {
        const int gx = x0 + col - r;
        const bool in = rin && gx >= 0 && gx < W;
        const size_t at = (size_t)gy * W + gx;
        float v[NCP];
#pragma unroll
        for (int c = 0; c < NCP; ++c)
          v[c] = in && c < nc ? __ldg(pb + at * nc + c) : 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          s_p[(q * g.ph + row) * g.pwp + col] =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        for (int f = 0; f < nf; ++f)
          s_f[(f * g.ph + row) * g.pwf + col] =
              in ? __ldg(fb + at * nf + f) : 0.f;
      }
    }
  }
  // the xy tables: coordinate / sigma inside the image, 0 outside
  for (int d = 0; d < nd; ++d) {
    const float sg = desc.xy[d];
    if (sg == 0.f) continue;
    for (int col = tid; col < g.pw; col += NT) {
      const int gx = x0 + col - r;
      s_x[d * g.pw + col] = gx >= 0 && gx < W ? __fdiv_rn((float)gx, sg) : 0.f;
    }
    for (int row = tid; row < g.ph; row += NT) {
      const int gy = y0 + row - r;
      s_y[d * g.ph + row] = gy >= 0 && gy < H ? __fdiv_rn((float)gy, sg) : 0.f;
    }
  }
  __syncthreads();

  // ---- a thread's P pixels: tile row ty, tile columns tx .. tx + P-1 ----
  const int tr = lane & 7;
  const int tc = lane >> 3;
  const int ty = (warp & 3) * 8 + tr;
  const int tx = (2 * tc + (warp >> 2)) * P;

  float acc[P][NCP];
  float ks[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    ks[k] = 0.f;
#pragma unroll
    for (int c = 0; c < NCP; ++c) acc[k][c] = 0.f;
  }
  if constexpr (R >= 0) {
    default_offsets<R>(s_p, s_f, s_x, s_y, g, x0 - R + tx, y0 - R + ty, ty,
                       tx, H, W, acc, ks);
    // default_offsets sums exp(...) unweighted: apply the one weight
#pragma unroll
    for (int k = 0; k < P; ++k) {
      ks[k] *= desc.w[0];
#pragma unroll
      for (int c = 0; c < NCP; ++c) acc[k][c] *= desc.w[0];
    }
  } else {
    general_offsets<NCP, NF, ND>(s_p, s_f, s_x, s_y, g, x0 + tx - r,
                                 y0 + ty - r, ty, tx, H, W, nf, r, desc, acc,
                                 ks);
  }

  // ---- store prod, sum k over this thread's in-image pixels ----
  const int gy = y0 + ty;
  float ksum = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int gx = x0 + tx + k;
    if (gy < H && gx < W) {
      const size_t at = ((size_t)b * H + gy) * W + gx;
      if (DEF) {
        reinterpret_cast<float4*>(prod)[at] =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      } else {
#pragma unroll
        for (int c = 0; c < NCP; ++c)
          if (c < nc) prod[at * nc + c] = acc[k][c];
      }
      ksum += ks[k];
    }
  }

  // block sum of k: shuffles within each warp, then across the warps
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    ksum += __shfl_down_sync(0xffffffffu, ksum, s);
  if (lane == 0) s_red[warp] = ksum;
  __syncthreads();
  if (tid < 32) {
    float v = tid < NT / 32 ? s_red[tid] : 0.f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, s);
    if (tid == 0)
      ksum_part[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x +
                blockIdx.x] = v;
  }
}

// ksum[b] = the f64 sum of image b's nb partials, in a fixed order.
__global__ void __launch_bounds__(FOLD_THREADS)
    gated_crf_fold_kernel(const float* __restrict__ part,
                          double* __restrict__ ksum, int nb) {
  __shared__ double s[FOLD_THREADS];
  const int b = blockIdx.x;
  double v = 0.0;
  for (int i = threadIdx.x; i < nb; i += FOLD_THREADS)
    v += (double)part[(size_t)b * nb + i];
  s[threadIdx.x] = v;
  __syncthreads();
  const int t = threadIdx.x;
#pragma unroll
  for (int h = FOLD_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) s[t] += s[t + h];
    __syncthreads();
  }
  if (t == 0) ksum[b] = s[0];
}

template <int NCP, int NF, int ND, int R>
int launch(const void* probs, const void* feats, void* prod, void* part,
           void* ksum, int B, int H, int W, int C, int F, int r,
           const Desc& desc, cudaStream_t stream) {
  const size_t bytes = Geom(r).bytes(NCP, F, desc.nd);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = gated_crf_kernel<NCP, NF, ND, R>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(probs), static_cast<const float*>(feats),
      static_cast<float*>(prod), static_cast<float*>(part), H, W, C, F, r,
      desc);
  gated_crf_fold_kernel<<<B, FOLD_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<double*>(ksum),
      (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// probs (B,H,W,C) f32, feats (B,H,W,F) f32 (the stored channels; F may be
// 0) -> prod (B,H,W,C) f32 and ksum (B,) f64; part: f32 scratch of
// B * ceil(H / 32) * ceil(W / 32) words. weights, xy: host float[nd] (xy[d]
// the sigma of descriptor d's xy features, 0 for none); desc_of: host
// int[F], the descriptor (0..nd-1) of each stored channel. Limits: C <= 8,
// F <= 8, nd <= 4, and the shared memory of Geom(radius).bytes(C <= 4 ? 4 :
// 8, F, nd) <= 232448 bytes.
int gated_crf_products(const void* probs, const void* feats, void* prod,
                       void* part, void* ksum, int B, int H, int W, int C,
                       int F, int radius, int nd, const void* weights,
                       const void* xy, const void* desc_of, void* stream) {
  if (C < 1 || C > MAX_C || F < 0 || F > MAX_F || nd < 1 || nd > MAX_D ||
      radius < 0 || B < 1 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Desc desc{};
  desc.nd = nd;
  for (int d = 0; d < nd; ++d) {
    desc.w[d] = static_cast<const float*>(weights)[d];
    desc.xy[d] = static_cast<const float*>(xy)[d];
    if (!(desc.xy[d] >= 0.f)) return (int)cudaErrorInvalidValue;
  }
  for (int f = 0; f < F; ++f) {
    const int d = static_cast<const int*>(desc_of)[f];
    if (d < 0 || d >= nd) return (int)cudaErrorInvalidValue;
    desc.desc_of[f] = d;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nd == 1 && F == 1 && desc.xy[0] > 0.f && C == 4 &&
      radius == DEFAULT_R && aligned16(probs) && aligned16(prod))
    return launch<4, 1, 1, DEFAULT_R>(probs, feats, prod, part, ksum, B, H, W,
                                      C, F, radius, desc, s);
  if (C <= 4)
    return launch<4, MAX_F, MAX_D, -1>(probs, feats, prod, part, ksum, B, H,
                                       W, C, F, radius, desc, s);
  return launch<8, MAX_F, MAX_D, -1>(probs, feats, prod, part, ksum, B, H, W,
                                     C, F, radius, desc, s);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
