// 3x3 SAME stride-1 convolution on NHWC activations and HWIO weights, for
// Hopper (sm_90a): the forward, the forward with per-channel output moments,
// and the weight gradient. The input gradient is the forward applied to the
// output gradient with the spatially rotated, in/out-swapped weights.
//
// Replaces (wsl4mis_tpu/ops/pallas/banded_conv_pallas.py):
//   _fwd_kernel        (:329) -> conv3x3_fwd_mma_kernel<BN, false> (bf16),
//                                conv3x3_fwd_kernel<float, false>   (f32)
//   _fwd_stats_kernel  (:340) -> conv3x3_fwd_mma_kernel<BN, true>  (bf16),
//                                conv3x3_fwd_kernel<float, true>    (f32)
//   _wgrad_kernel      (:377) -> conv3x3_wgrad_mma_kernel<BN>       (bf16),
//                                conv3x3_wgrad_kernel<float, TC, TO> (f32)
// The TPU kernels pack W*C into 128-lane bands so that the MXU sees dense
// tiles; that layout exists for the TPU's matrix unit and is not carried
// over. These kernels compute the same function directly on NHWC.
//
// What bounds a launch on the H100 (bf16 at 989 TFLOP/s, 3.35 TB/s): a conv
// does 18*C*O flops per pixel on 2*(C+O) bytes, so at the U-Net's 256x256
// and 128x128 levels (C, O <= 32, most of the pixels) the bound is bytes,
// and at the 128-256-channel levels it is operations.
//
// bf16 (the training path): implicit GEMMs on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands fed by ldmatrix
// from shared memory that cp.async fills 16 bytes at a time, in a ring of
// stages (the next stages' copies are in flight while this one's MMAs
// run). mma.sync rather than wgmma: a warp's tile here is 16 pixels of one
// image row by 16 channels, a shifted view of a halo; wgmma wants 64-row
// tiles in its own shared-memory layout, which the 9 shifted views of one
// halo are not.
// - Forward, Y[p, o] = sum_(tap, c) X_tap[p, c] W[tap, c, o]: persistent
//   blocks, as many as can be resident, each owning BN output channels
//   (BN = 16, 32, 64 or 128, the least >= O; 128 drops to 64 when there
//   would be fewer than two tiles an SM) and walking TH x 16 pixel tiles
//   (TH = 16 for BN <= 32, else 8). A step is one tile's 16-channel slice:
//   the (TH+2) x 18 x 16 input halo and the 9 x 16 x BN weight slice, in a
//   2-stage ring, so the next tile's copies overlap this tile's MMAs and
//   epilogue. All 9 taps run from one halo as shifted ldmatrix views, so
//   the halo is read once per BN outputs (16 times less than the SIMT
//   kernel's 16-output blocks at O = 256). Each warp holds MT m16 tiles
//   (tile rows) by up to 64 outputs of f32 accumulators. Halo rows are 32
//   bytes (16 channels) with the two 16-byte halves swapped on bit 2 of
//   the pixel index, and weight rows are padded by 16 bytes, so that every
//   ldmatrix phase touches all 32 banks once. The epilogue adds the f32
//   bias, rounds once to bf16, stages the tile in shared memory and stores
//   16 bytes a thread; with STATS it sums y and y*y of the rounded values
//   from the accumulator fragments (shuffles over the fragment rows), adds
//   them to the block's shared sums in tile order, and writes one partial
//   row per block.
// - Weight gradient, dK[(tap, c), o] = sum_p X_tap[p, c] G[p, o] with the
//   pixels as the reduction: a block owns 16 input channels, BN = 16, 32 or
//   64 outputs, all 9 taps, and a range of 16 x 16 pixel tiles. A step is
//   one tile's 18 x 18 x 16 halo and its 256 x BN slice of g, each read
//   once, in a 3-stage ring (2 at BN = 64); the 9 taps are shifted views
//   (ldmatrix.trans, since both operands are pixel-major). Six warps: three
//   tap rows (ky) times two pixel-row groups; the groups are summed in
//   shared memory in a fixed order, and the blocks' ranges go to f32
//   partials that the caller sums with a torch reduction. The split count
//   fills one wave of resident blocks where there are tiles for it, but
//   writes no more partial bytes than x and g hold.
// - Ragged shapes: channels past C and outputs past O are zero-filled (the
//   stem's C = 1 pads K to 9 x 16 with zero channels, the head's O = 4 to
//   16 outputs); a C or O that is not a multiple of 8 (or an unaligned
//   base) cannot use 16-byte copies, so those operands are loaded 8
//   elements at a time through registers into the same shared layout;
//   pixels outside the image are zero-filled and never stored or counted.
//
// f32 (compute_dtype="float32" and the card-vs-CPU reference check): the
// SIMT kernels below, f32 FMAs on the CUDA cores. TF32 tensor cores would
// keep 10 mantissa bits and break the f32 check's 1e-4 limit and the
// gradient check's argument (PERF.md), so f32 stays off the tensor cores.
//
// Numerics: products accumulate in f32, the bias is added in f32 and the
// sum is rounded once to the output dtype. The moments are taken over the
// rounded stored values, as the TPU kernel does. Every cross-block sum goes
// through a partials tensor that the caller folds with a torch reduction:
// no atomics, and two calls give bit-equal results.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ---- f32 SIMT kernels (compute_dtype="float32") ---------------------------

// ---- forward tiling ------------------------------------------------------
constexpr int TW = 16;          // tile width in pixels: one thread per column
constexpr int TY = 8;           // thread rows
constexpr int PY = 2;           // output rows per thread
constexpr int TH = TY * PY;     // tile height in pixels
constexpr int OT = 16;          // output channels per block
constexpr int CC = 16;          // input channels per shared-memory chunk
constexpr int HS = TH + 2;      // halo rows
constexpr int HW_ = TW + 2;     // halo columns
constexpr int WS = 24;          // halo row stride: PY*WS = 48 puts thread rows
                                // ty and ty+1 of a warp 16 banks apart
constexpr int NT = TW * TY;     // threads per block

// ---- weight-gradient tiling ----------------------------------------------
constexpr int WG_THREADS = 256;  // 16 (output-channel lanes) x 16 (input)
constexpr int WG_PP = 32;        // pixels staged per shared-memory chunk
constexpr int WG_TARGET_BLOCKS = 2112;  // ~16 blocks per SM on 132 SMs

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// One block: image n = blockIdx.z, a TH x TW pixel tile (blockIdx.x), and
// OT output channels (blockIdx.y). With STATS, it also writes the sums of
// y and y*y over its valid pixels to partial[(n*tiles + tile), {0,1}, o].
// (The explicit minimum of one block an SM keeps ptxas from spilling the
// STATS instantiation.)
template <typename T, bool STATS>
__global__ void __launch_bounds__(NT, 1)
    conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y,
                       float* __restrict__ partial, int H, int W, int C,
                       int O, int tiles_x) {
  __shared__ float s_in[CC][HS][WS];
  __shared__ __align__(16) float s_w[CC][9][OT];

  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const int o0 = blockIdx.y * OT;
  const int n = blockIdx.z;
  const T* xn = x + (size_t)n * H * W * C;

  float acc[PY][OT];
#pragma unroll
  for (int r = 0; r < PY; ++r)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[r][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cn = min(CC, C - c0);
    // input halo of the tile, zero outside the image (SAME padding)
    for (int i = tid; i < HS * HW_ * CC; i += NT) {
      const int c = i % CC;
      const int p = i / CC;
      const int hx = p % HW_;
      const int hy = p / HW_;
      const int gy = y0 + hy - 1;
      const int gx = x0 + hx - 1;
      float v = 0.f;
      if (c < cn && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(xn[((size_t)gy * W + gx) * C + c0 + c]);
      s_in[c][hy][hx] = v;
    }
    // weights w[ky][kx][c][o] of this chunk and channel tile
    for (int i = tid; i < 9 * CC * OT; i += NT) {
      const int o = i % OT;
      const int rest = i / OT;
      const int c = rest % CC;
      const int tap = rest / CC;
      float v = 0.f;
      if (c < cn && o0 + o < O)
        v = to_f32(w[((size_t)tap * C + c0 + c) * O + o0 + o]);
      s_w[c][tap][o] = v;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float col[PY + 2];
#pragma unroll
        for (int r = 0; r < PY + 2; ++r) col[r] = s_in[c][ty * PY + r][tx + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[c][ky * 3 + kx][0]);
#pragma unroll
          for (int q = 0; q < OT / 4; ++q) {
            const float4 wv = wp[q];
#pragma unroll
            for (int r = 0; r < PY; ++r) {
              const float xv = col[r + ky];
              acc[r][4 * q + 0] = fmaf(xv, wv.x, acc[r][4 * q + 0]);
              acc[r][4 * q + 1] = fmaf(xv, wv.y, acc[r][4 * q + 1]);
              acc[r][4 * q + 2] = fmaf(xv, wv.z, acc[r][4 * q + 2]);
              acc[r][4 * q + 3] = fmaf(xv, wv.w, acc[r][4 * q + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias in f32, one rounding to T, store; moments of the rounded
  // y, one output channel at a time
  const int ox = x0 + tx;
  __shared__ float s_red[NT / 32][2][OT];
  const int lane = tid % 32;
  const int warp = tid / 32;
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    float s1 = 0.f, s2 = 0.f;
    const float bias = b != nullptr && o0 + o < O ? to_f32(b[o0 + o]) : 0.f;
#pragma unroll
    for (int r = 0; r < PY; ++r) {
      const int oy = y0 + ty * PY + r;
      if (oy < H && ox < W && o0 + o < O) {
        const T v = from_f32<T>(acc[r][o] + bias);
        y[(((size_t)n * H + oy) * W + ox) * O + o0 + o] = v;
        if (STATS) {
          const float vf = to_f32(v);
          s1 += vf;
          s2 += vf * vf;
        }
      }
    }
    if (STATS) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (lane == 0) {
        s_red[warp][0][o] = s1;
        s_red[warp][1][o] = s2;
      }
    }
  }
  if (STATS) {
    __syncthreads();
    if (tid < 2 * OT) {
      const int k = tid / OT;
      const int o = tid % OT;
      if (o0 + o < O) {
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < NT / 32; ++wi) s += s_red[wi][k][o];
        const size_t blk = (size_t)n * gridDim.x + tile;
        partial[(blk * 2 + k) * O + o0 + o] = s;
      }
    }
  }
}

// One block: one tap (ky, kx), CT = 16*TC input channels and OTL = 16*TO
// output channels, over pixels [split*per_split, (split+1)*per_split) of the
// flattened N*H*W range. Writes partial[split][tap][c][o] for its tile; the
// caller sums over splits.
template <typename T, int TC, int TO>
__global__ void __launch_bounds__(WG_THREADS)
    conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         float* __restrict__ partial, int H, int W, int C,
                         int O, int c_tiles, int o_tiles, long long M,
                         long long per_split) {
  constexpr int CT = 16 * TC;
  constexpr int OTL = 16 * TO;
  __shared__ float s_x[WG_PP][CT];
  __shared__ float s_g[WG_PP][OTL];

  int bid = blockIdx.x;
  const int ot = bid % o_tiles;
  bid /= o_tiles;
  const int ct = bid % c_tiles;
  const int tap = bid / c_tiles;
  const int ky = tap / 3;
  const int kx = tap % 3;
  const int c0 = ct * CT;
  const int o0 = ot * OTL;
  const int split = blockIdx.y;
  const long long m_begin = (long long)split * per_split;
  const long long m_end = min(M, m_begin + per_split);
  const int tx = threadIdx.x % 16;  // output-channel lane
  const int ty = threadIdx.x / 16;  // input-channel lane
  const int hw = H * W;

  float acc[TC][TO];
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;

  for (long long m0 = m_begin; m0 < m_end; m0 += WG_PP) {
    for (int i = threadIdx.x; i < WG_PP * CT; i += WG_THREADS) {
      const int c = i % CT;
      const int p = i / CT;
      const long long m = m0 + p;
      float v = 0.f;
      if (m < m_end && c0 + c < C) {
        const int nn = (int)(m / hw);
        const int rem = (int)(m - (long long)nn * hw);
        const int sy = rem / W + ky - 1;
        const int sx = rem % W + kx - 1;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W)
          v = to_f32(x[(((size_t)nn * H + sy) * W + sx) * C + c0 + c]);
      }
      s_x[p][c] = v;
    }
    for (int i = threadIdx.x; i < WG_PP * OTL; i += WG_THREADS) {
      const int o = i % OTL;
      const int p = i / OTL;
      const long long m = m0 + p;
      float v = 0.f;
      if (m < m_end && o0 + o < O) v = to_f32(g[(size_t)m * O + o0 + o]);
      s_g[p][o] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < WG_PP; ++p) {
      float xv[TC], gv[TO];
#pragma unroll
      for (int i = 0; i < TC; ++i) xv[i] = s_x[p][ty * TC + i];
#pragma unroll
      for (int j = 0; j < TO; ++j) gv[j] = s_g[p][tx * TO + j];
#pragma unroll
      for (int i = 0; i < TC; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TC; ++i) {
    const int c = c0 + ty * TC + i;
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const int o = o0 + tx * TO + j;
      if (c < C && o < O)
        partial[(((size_t)split * 9 + tap) * C + c) * O + o] = acc[i][j];
    }
  }
}

template <typename T, bool STATS>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               void* partial, int N, int H, int W, int C, int O,
               void* stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (O + OT - 1) / OT, N);
  conv3x3_fwd_kernel<T, STATS><<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(partial), H, W, C, O, tiles_x);
  return (int)cudaGetLastError();
}

int wgrad_tile(int ch) { return ch >= 64 ? 4 : (ch >= 32 ? 2 : 1); }

long long wgrad_per_split(int N, int H, int W, int C, int O) {
  const long long M = (long long)N * H * W;
  const int c_tiles = (C + 16 * wgrad_tile(C) - 1) / (16 * wgrad_tile(C));
  const int o_tiles = (O + 16 * wgrad_tile(O) - 1) / (16 * wgrad_tile(O));
  const long long base = 9LL * c_tiles * o_tiles;
  long long splits = (WG_TARGET_BLOCKS + base - 1) / base;
  const long long most = (M + 255) / 256;  // keep >= 256 pixels per split
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  long long per = (M + splits - 1) / splits;
  per = (per + WG_PP - 1) / WG_PP * WG_PP;
  return per;
}

template <typename T, int TC, int TO>
int launch_wgrad_tiled(const void* x, const void* g, void* partial, int N,
                       int H, int W, int C, int O, int splits,
                       long long per_split, void* stream) {
  const int c_tiles = (C + 16 * TC - 1) / (16 * TC);
  const int o_tiles = (O + 16 * TO - 1) / (16 * TO);
  const dim3 grid(9 * c_tiles * o_tiles, splits);
  conv3x3_wgrad_kernel<T, TC, TO><<<grid, WG_THREADS, 0,
                                    (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(partial), H, W, C, O, c_tiles, o_tiles,
      (long long)N * H * W, per_split);
  return (int)cudaGetLastError();
}

template <typename T, int TC>
int launch_wgrad_o(const void* x, const void* g, void* partial, int N, int H,
                   int W, int C, int O, int splits, long long per,
                   void* stream) {
  switch (wgrad_tile(O)) {
    case 4:
      return launch_wgrad_tiled<T, TC, 4>(x, g, partial, N, H, W, C, O,
                                          splits, per, stream);
    case 2:
      return launch_wgrad_tiled<T, TC, 2>(x, g, partial, N, H, W, C, O,
                                          splits, per, stream);
    default:
      return launch_wgrad_tiled<T, TC, 1>(x, g, partial, N, H, W, C, O,
                                          splits, per, stream);
  }
}

template <typename T>
int launch_wgrad(const void* x, const void* g, void* partial, int N, int H,
                 int W, int C, int O, int splits, void* stream) {
  const long long per = wgrad_per_split(N, H, W, C, O);
  switch (wgrad_tile(C)) {
    case 4:
      return launch_wgrad_o<T, 4>(x, g, partial, N, H, W, C, O, splits, per,
                                  stream);
    case 2:
      return launch_wgrad_o<T, 2>(x, g, partial, N, H, W, C, O, splits, per,
                                  stream);
    default:
      return launch_wgrad_o<T, 1>(x, g, partial, N, H, W, C, O, splits, per,
                                  stream);
  }
}


// ---- bf16 tensor-core kernels ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kSms = 132;  // H100 SXM; only sizes the grids

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight bf16 values from src[0..valid), zeros after: the 16-byte row piece
// of an operand whose channel count is no multiple of 8 (or whose base is
// not 16-byte aligned), loaded element by element.
__device__ __forceinline__ uint4 load8(const bf16* src, int valid) {
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < valid)
      u[k >> 1] |= (uint32_t)__bfloat16_as_ushort(src[k]) << (16 * (k & 1));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Copy one 16-byte piece of a shared-memory row: asynchronously where
// vec, else through registers. valid = how many of its 8 elements exist.
__device__ __forceinline__ void stage16(uint8_t* dst, const bf16* src,
                                        int valid, bool vec) {
  if (vec)
    cp_async16(smem_u32(dst), src, valid > 0);
  else
    *reinterpret_cast<uint4*>(dst) = load8(src, valid);
}

__device__ __forceinline__ int clamp8(int v) { return v < 0 ? 0 : v > 8 ? 8 : v; }

// Halo layout: pixel q of a (rows x 18) halo holds 16 channels in 32 bytes;
// its two 16-byte halves swap when bit 2 of q is set, so that any 8
// consecutive pixels' same half fall on 8 distinct 16-byte bank groups.
constexpr int HALO_W = 18;
__device__ __forceinline__ uint32_t halo_off(int q, int h) {
  return q * 32 + ((h ^ ((q >> 2) & 1)) << 4);
}

// Stage the (TH+2) x 18 halo around the TH x 16 pixel tile at (y0, x0) of
// one image, channels c0..c0+15; zero outside the image and past C. vec:
// C % 8 == 0 and an aligned base, so each half is one 16-byte copy.
template <int TH>
__device__ __forceinline__ void load_halo(uint8_t* s, const bf16* xn, int H,
                                          int W, int C, int c0, int y0,
                                          int x0, bool vec, int tid,
                                          int nthreads) {
  constexpr int NPIX = (TH + 2) * HALO_W;
  for (int i = tid; i < NPIX * 2; i += nthreads) {
    const int q = i >> 1, h = i & 1;
    const int gy = y0 + q / HALO_W - 1, gx = x0 + q % HALO_W - 1;
    const int c = c0 + 8 * h;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int valid = in ? clamp8(C - c) : 0;
    stage16(s + halo_off(q, h),
            valid > 0 ? xn + ((size_t)gy * W + gx) * C + c : xn, valid, vec);
  }
}

// Forward tiling for BN output channels per block.
template <int BN>
struct FwdTile {
  static constexpr int WARPS_N = BN > 64 ? BN / 64 : 1;
  static constexpr int WN = BN / WARPS_N;  // outputs per warp: 16..64
  static constexpr int NT8 = WN / 8;       // n8 tiles per warp
  static constexpr int WARPS_M = 4;
  static constexpr int MT = BN <= 32 ? 4 : 2;  // m16 tiles (tile rows) per warp
  static constexpr int TH = WARPS_M * MT;      // tile rows (16 columns each)
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int NST = 2;  // pipeline stages
  // resident blocks an SM (registers and shared memory allow them; at 3,
  // the BN = 32 kernel would spill)
  static constexpr int PER_SM = BN == 16 ? 4 : BN == 64 ? 3 : BN == 32 ? 2 : 1;
  static constexpr int HALO = (TH + 2) * HALO_W * 32;
  static constexpr int WROW = BN * 2 + 16;  // padded weight row, bytes
  static constexpr int STAGE = HALO + 9 * 16 * WROW;
  static constexpr int OROW = BN * 2 + 16;  // padded output row, bytes
  static constexpr int OUT = TH * 16 * OROW;
  static constexpr int RED = WARPS_M * BN * 2 * 4;
  // the stages, the output tile, the moment sums, the bias
  static constexpr int SMEM = NST * STAGE + OUT + RED + BN * 4;
};

// A persistent block: output channels BN*blockIdx.y + [0, BN), and the
// TH x 16 pixel tiles t = blockIdx.x + k*gridDim.x of the N*tiles_per_img
// tiles. Its steps (tile, 16-channel slice) run through one 2-stage
// pipeline, so the next tile's copies overlap this tile's MMAs and
// epilogue. With STATS it writes the sums of y and y*y over its valid
// pixels to partial[blockIdx.x, {0,1}, o].
template <int BN, bool STATS>
__global__ void __launch_bounds__(FwdTile<BN>::THREADS, FwdTile<BN>::PER_SM)
    conv3x3_fwd_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const bf16* __restrict__ b, bf16* __restrict__ y,
                           float* __restrict__ partial, int H, int W, int C,
                           int O, int tiles_x, int tiles_per_img, int tiles,
                           int vec_x, int vec_o) {
  using T = FwdTile<BN>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_out = smem + T::NST * T::STAGE;
  float* s_red = reinterpret_cast<float*>(s_out + T::OUT);
  float* s_bias = s_red + T::RED / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % T::WARPS_M, warp_n = warp / T::WARPS_M;
  const int o0 = blockIdx.y * BN;
  const int chunks = (C + 15) / 16;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int steps = my_tiles * chunks;

  for (int i = tid; i < T::RED / 4; i += T::THREADS) s_red[i] = 0.f;
  for (int i = tid; i < BN; i += T::THREADS)
    s_bias[i] = b != nullptr && o0 + i < O ? __bfloat162float(b[o0 + i]) : 0.f;

  // step s: tile blockIdx.x + (s / chunks) * gridDim.x, channels
  // 16 * (s % chunks) + [0, 16): its halo and the weights
  // w[tap][c][o0..o0+BN) as rows (tap*16 + c) of BN outputs
  auto load = [&](int stage, int s) {
    const int t = blockIdx.x + (s / chunks) * gridDim.x;
    const int c0 = 16 * (s % chunks);
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    uint8_t* st = smem + stage * T::STAGE;
    load_halo<T::TH>(st, x + (size_t)n * H * W * C, H, W, C, c0,
                     (rem / tiles_x) * T::TH, (rem % tiles_x) * 16, vec_x,
                     tid, T::THREADS);
    if (chunks == 1 && s >= T::NST) return;  // the stage holds them already
    for (int i = tid; i < 144 * (BN / 8); i += T::THREADS) {
      const int j = i % (BN / 8), r = i / (BN / 8);
      const int c = c0 + (r & 15), o = o0 + 8 * j;
      const int valid = c < C ? clamp8(O - o) : 0;
      stage16(st + T::HALO + r * T::WROW + j * 16,
              valid > 0 ? w + ((size_t)(r >> 4) * C + c) * O + o : w, valid,
              vec_o);
    }
  };

  float acc[T::MT][T::NT8][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < T::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // ldmatrix lane roles: lane supplies row (lane & 7) of matrix (lane >> 3)
  const int lm = lane >> 3, lr = lane & 7;
  const int a_col = lr + 8 * (lm & 1), a_half = lm >> 1;  // A: pixel, half
  const int b_row = lr + 8 * (lm & 1), b_chunk = lm >> 1;  // B: k row, n8
  const int fr = lane >> 2, fc = (lane & 3) * 2;  // accumulator row, column

  for (int s = 0; s < T::NST - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // refill the stage that step s-1 read (the barrier below step s-1's
    // MMAs has passed), then wait for step s's own copies
    if (s + T::NST - 1 < steps)
      load((s + T::NST - 1) % T::NST, s + T::NST - 1);
    cp_async_commit();
    cp_async_wait<T::NST - 1>();
    __syncthreads();
    const uint32_t hb = smem_u32(smem + (s % T::NST) * T::STAGE);
    const uint32_t wb = hb + T::HALO;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t bfr[T::NT8][2];
#pragma unroll
      for (int jj = 0; jj < T::NT8 / 2; ++jj)
        ldsm_x4_trans(wb + (tap * 16 + b_row) * T::WROW +
                          (warp_n * T::WN + (2 * jj + b_chunk) * 8) * 2,
                      bfr[2 * jj][0], bfr[2 * jj][1], bfr[2 * jj + 1][0],
                      bfr[2 * jj + 1][1]);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int q = (warp_m * T::MT + mt + ky) * HALO_W + a_col + kx;
        uint32_t a[4];
        ldsm_x4(hb + halo_off(q, a_half), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int j = 0; j < T::NT8; ++j) mma_bf16(acc[mt][j], a, bfr[j]);
      }
    }
    __syncthreads();
    if (s % chunks != chunks - 1) continue;

    // epilogue of the tile: bias in f32, one rounding, the tile staged in
    // shared memory; moments of the rounded values from the fragments
    const int t = blockIdx.x + (s / chunks) * gridDim.x;
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    const int y0 = (rem / tiles_x) * T::TH, x0 = (rem % tiles_x) * 16;
#pragma unroll
    for (int j = 0; j < T::NT8; ++j) {
      const int ol = warp_n * T::WN + j * 8 + fc;
      const float b0 = s_bias[ol], b1 = s_bias[ol + 1];
      float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int r = warp_m * T::MT + mt;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = fr + 8 * hh;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mt][j][2 * hh] + b0, acc[mt][j][2 * hh + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(
              s_out + (r * 16 + col) * T::OROW + ol * 2) = v;
          acc[mt][j][2 * hh] = acc[mt][j][2 * hh + 1] = 0.f;
          if (STATS && y0 + r < H && x0 + col < W) {
            const float2 f = __bfloat1622float2(v);
            s1a += f.x;
            s2a += f.x * f.x;
            s1b += f.y;
            s2b += f.y * f.y;
          }
        }
      }
      if (STATS) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1a += __shfl_xor_sync(0xffffffffu, s1a, off);
          s1b += __shfl_xor_sync(0xffffffffu, s1b, off);
          s2a += __shfl_xor_sync(0xffffffffu, s2a, off);
          s2b += __shfl_xor_sync(0xffffffffu, s2b, off);
        }
        if (fr == 0) {  // this lane alone owns these four sums
          float* rp = s_red + (warp_m * BN + ol) * 2;
          rp[0] += s1a;
          rp[1] += s2a;
          rp[2] += s1b;
          rp[3] += s2b;
        }
      }
    }
    __syncthreads();
    bf16* yn = y + (size_t)n * H * W * O;
    for (int i = tid; i < T::TH * 16 * (BN / 8); i += T::THREADS) {
      const int jc = i % (BN / 8), p = i / (BN / 8);
      const int oy = y0 + p / 16, ox = x0 + p % 16, o = o0 + 8 * jc;
      if (oy >= H || ox >= W || o >= O) continue;
      const uint8_t* src = s_out + p * T::OROW + jc * 16;
      bf16* dst = yn + ((size_t)oy * W + ox) * O + o;
      if (vec_o) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const int valid = clamp8(O - o);
        for (int k = 0; k < valid; ++k)
          dst[k] = reinterpret_cast<const bf16*>(src)[k];
      }
    }
    // the next write of s_out follows at least one more __syncthreads
  }

  if (!STATS) return;
  __syncthreads();
  if (tid < 2 * BN) {
    const int kk = tid / BN, ol = tid % BN;
    if (o0 + ol < O) {
      float sum = 0.f;
#pragma unroll
      for (int wm = 0; wm < T::WARPS_M; ++wm)
        sum += s_red[(wm * BN + ol) * 2 + kk];
      partial[((size_t)blockIdx.x * 2 + kk) * O + o0 + ol] = sum;
    }
  }
}

// Weight-gradient tiling for BN output channels per block.
template <int BN>
struct WgradTile {
  static constexpr int TH = 16;  // pixel tile: 16 x 16
  static constexpr int WK = 2;   // pixel-row groups (warps per tap row)
  static constexpr int THREADS = 32 * 3 * WK;
  static constexpr int NST = BN <= 32 ? 3 : 2;  // pipeline stages
  static constexpr int PER_SM = BN == 16 ? 3 : 2;  // resident blocks an SM
  static constexpr int NT8 = BN / 8;
  static constexpr int HALO = (TH + 2) * HALO_W * 32;
  static constexpr int GROW = BN * 2 + 16;  // padded g row, bytes
  static constexpr int STAGE = HALO + TH * 16 * GROW;
  static constexpr int RED = 9 * 16 * BN * 4;
  static constexpr int SMEM = NST * STAGE > RED ? NST * STAGE : RED;
};

// One block: input channels 16*(blockIdx.x / o_tiles) + [0, 16), outputs
// BN*(blockIdx.x % o_tiles) + [0, BN), all 9 taps, pixel tiles
// [blockIdx.y * per_split, ...) of the N * tiles_per_img 16 x 16 tiles.
// Writes partial[blockIdx.y][tap][c][o] for its (c, o) range.
template <int BN>
__global__ void __launch_bounds__(WgradTile<BN>::THREADS,
                                  WgradTile<BN>::PER_SM)
    conv3x3_wgrad_mma_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ g,
                             float* __restrict__ partial, int H, int W, int C,
                             int O, int o_tiles, int tiles_x,
                             int tiles_per_img, int tiles, int per_split,
                             int vec_x, int vec_o) {
  using T = WgradTile<BN>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ky = warp % 3, grp = warp / 3;
  const int c0 = (blockIdx.x / o_tiles) * 16;
  const int o0 = (blockIdx.x % o_tiles) * BN;
  const int t_begin = blockIdx.y * per_split;
  const int t_end = min(tiles, t_begin + per_split);

  // one stage: tile t's halo (channels c0..c0+15) and its 256 x BN slice
  // of g as rows of BN outputs
  auto load = [&](int stage, int t) {
    uint8_t* s = smem + stage * T::STAGE;
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    const int y0 = (rem / tiles_x) * T::TH, x0 = (rem % tiles_x) * 16;
    load_halo<T::TH>(s, x + (size_t)n * H * W * C, H, W, C, c0, y0, x0,
                     vec_x, tid, T::THREADS);
    const bf16* gn = g + (size_t)n * H * W * O;
    for (int i = tid; i < T::TH * 16 * (BN / 8); i += T::THREADS) {
      const int j = i % (BN / 8), p = i / (BN / 8);
      const int gy = y0 + p / 16, gx = x0 + p % 16, o = o0 + 8 * j;
      const int valid = gy < H && gx < W ? clamp8(O - o) : 0;
      stage16(s + T::HALO + p * T::GROW + j * 16,
              valid > 0 ? gn + ((size_t)gy * W + gx) * O + o : gn, valid,
              vec_o);
    }
  };

  float acc[3][T::NT8][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < T::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kx][j][e] = 0.f;

  // ldmatrix.trans lane roles. A (16 channels x 16 pixels) from the
  // pixel-major halo: matrices (pixels 0-7, ch 0-7), (0-7, 8-15),
  // (8-15, 0-7), (8-15, 8-15). B (16 pixels x BN) from the g rows.
  const int lm = lane >> 3, lr = lane & 7;
  const int a_pix = lr + 8 * (lm >> 1), a_half = lm & 1;
  const int b_row = lr + 8 * (lm & 1), b_chunk = lm >> 1;

  for (int k = 0; k < T::NST - 1; ++k) {
    if (t_begin + k < t_end) load(k, t_begin + k);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int k = t - t_begin;
    if (t + T::NST - 1 < t_end)
      load((k + T::NST - 1) % T::NST, t + T::NST - 1);
    cp_async_commit();
    cp_async_wait<T::NST - 1>();
    __syncthreads();
    const uint32_t hb = smem_u32(smem + (k % T::NST) * T::STAGE);
    const uint32_t gb = hb + T::HALO;
#pragma unroll 1
    for (int r = grp; r < T::TH; r += T::WK) {
      uint32_t bfr[T::NT8][2];
#pragma unroll
      for (int jj = 0; jj < T::NT8 / 2; ++jj)
        ldsm_x4_trans(gb + (r * 16 + b_row) * T::GROW + (2 * jj + b_chunk) * 16,
                      bfr[2 * jj][0], bfr[2 * jj][1], bfr[2 * jj + 1][0],
                      bfr[2 * jj + 1][1]);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int q = (r + ky) * HALO_W + a_pix + kx;
        uint32_t a[4];
        ldsm_x4_trans(hb + halo_off(q, a_half), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int j = 0; j < T::NT8; ++j) mma_bf16(acc[kx][j], a, bfr[j]);
      }
    }
    __syncthreads();
  }

  // sum the pixel-row groups in shared memory, group 0 first
  float* red = reinterpret_cast<float*>(smem);  // [tap][16][BN]
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  for (int s = 0; s < T::WK; ++s) {
    if (grp == s) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int j = 0; j < T::NT8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = fr + 8 * (e >> 1), o = j * 8 + fc + (e & 1);
            float* p = red + ((ky * 3 + kx) * 16 + c) * BN + o;
            *p = s == 0 ? acc[kx][j][e] : *p + acc[kx][j][e];
          }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.y * 9 * C * O;
  for (int i = tid; i < 9 * 16 * BN; i += T::THREADS) {
    const int o = i % BN, c = (i / BN) % 16, tap = i / (16 * BN);
    if (c0 + c < C && o0 + o < O)
      out[((size_t)tap * C + c0 + c) * O + o0 + o] = red[i];
  }
}

// ---- bf16 launchers --------------------------------------------------------

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Raise a kernel's dynamic shared-memory limit once per device; `done` is
// the calling instantiation's own record.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  done[dev] = err == cudaSuccess;
  return err;
}

// Whether rows of `ch` bf16 channels from p can be copied 16 bytes at a
// time: 8-channel groups, and a 16-byte aligned base.
bool vec16(const void* p, int ch) {
  return ch % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Output channels per forward block: the least of 16/32/64/128 that covers
// O; 128 drops to 64 when there would be fewer than two tiles an SM.
int fwd_bn(int N, int H, int W, int O) {
  const int bn = O <= 16 ? 16 : O <= 32 ? 32 : O <= 64 ? 64 : 128;
  if (bn == 128 &&
      (long long)N * cdiv(H, FwdTile<128>::TH) * cdiv(W, 16) * cdiv(O, 128) <
          2 * kSms)
    return 64;
  return bn;
}

// The forward's pixel tiles, and its persistent grid: as many blocks as
// can be resident (PER_SM on each SM), never more than there are tiles.
struct FwdPlan {
  int bn, tiles_x, tiles_per_img, tiles, blocks;
};

template <int BN>
FwdPlan fwd_plan_bn(int N, int H, int W) {
  using T = FwdTile<BN>;
  FwdPlan p;
  p.bn = BN;
  p.tiles_x = (int)cdiv(W, 16);
  p.tiles_per_img = p.tiles_x * (int)cdiv(H, T::TH);
  p.tiles = N * p.tiles_per_img;
  p.blocks = p.tiles < T::PER_SM * kSms ? p.tiles : T::PER_SM * kSms;
  return p;
}

FwdPlan fwd_plan(int N, int H, int W, int O) {
  switch (fwd_bn(N, H, W, O)) {
    case 16:
      return fwd_plan_bn<16>(N, H, W);
    case 32:
      return fwd_plan_bn<32>(N, H, W);
    case 64:
      return fwd_plan_bn<64>(N, H, W);
    default:
      return fwd_plan_bn<128>(N, H, W);
  }
}

template <int BN, bool STATS>
int launch_fwd_mma(const void* x, const void* w, const void* b, void* y,
                   void* partial, int N, int H, int W, int C, int O,
                   void* stream) {
  using T = FwdTile<BN>;
  auto kernel = conv3x3_fwd_mma_kernel<BN, STATS>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kernel, T::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const FwdPlan p = fwd_plan_bn<BN>(N, H, W);
  const dim3 grid(p.blocks, (int)cdiv(O, BN));
  kernel<<<grid, T::THREADS, T::SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(y),
      static_cast<float*>(partial), H, W, C, O, p.tiles_x, p.tiles_per_img,
      p.tiles, vec16(x, C), vec16(w, O) && vec16(y, O));
  return (int)cudaGetLastError();
}

template <bool STATS>
int launch_fwd_bf16(const void* x, const void* w, const void* b, void* y,
                    void* partial, int N, int H, int W, int C, int O,
                    void* stream) {
  switch (fwd_bn(N, H, W, O)) {
    case 16:
      return launch_fwd_mma<16, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                       stream);
    case 32:
      return launch_fwd_mma<32, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                       stream);
    case 64:
      return launch_fwd_mma<64, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                       stream);
    default:
      return launch_fwd_mma<128, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                        stream);
  }
}

int wgrad_bn(int O) { return O <= 16 ? 16 : O <= 32 ? 32 : 64; }

// How the weight gradient splits the N * tiles_per_img pixel tiles: one
// wave of resident blocks where there are tiles for it, but no more
// partial bytes (splits * 9*C*O f32) than the bytes of x and g.
struct WgradPlan {
  int tiles_x, tiles_per_img, tiles, per_split, splits;
};

WgradPlan wgrad_plan(int N, int H, int W, int C, int O) {
  WgradPlan p;
  p.tiles_x = (int)cdiv(W, 16);
  p.tiles_per_img = p.tiles_x * (int)cdiv(H, WgradTile<16>::TH);
  p.tiles = N * p.tiles_per_img;
  const int bn = wgrad_bn(O);
  const int per_sm = bn == 16 ? WgradTile<16>::PER_SM
                     : bn == 32 ? WgradTile<32>::PER_SM : WgradTile<64>::PER_SM;
  const long long base = cdiv(C, 16) * cdiv(O, bn);
  long long splits = per_sm * kSms / base;
  const long long most = (long long)N * H * W * (C + O) * 2 / (9LL * C * O * 4);
  if (splits > most) splits = most;
  if (splits > p.tiles) splits = p.tiles;
  if (splits < 1) splits = 1;
  p.per_split = (int)cdiv(p.tiles, splits);
  p.splits = (int)cdiv(p.tiles, p.per_split);
  return p;
}

template <int BN>
int launch_wgrad_mma(const void* x, const void* g, void* partial, int N, int H,
                     int W, int C, int O, void* stream) {
  using T = WgradTile<BN>;
  auto kernel = conv3x3_wgrad_mma_kernel<BN>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kernel, T::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const WgradPlan p = wgrad_plan(N, H, W, C, O);
  const int o_tiles = (int)cdiv(O, BN);
  const dim3 grid((int)cdiv(C, 16) * o_tiles, p.splits);
  kernel<<<grid, T::THREADS, T::SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<float*>(partial), H, W, C, O, o_tiles, p.tiles_x,
      p.tiles_per_img, p.tiles, p.per_split, vec16(x, C), vec16(g, O));
  return (int)cudaGetLastError();
}

int launch_wgrad_bf16(const void* x, const void* g, void* partial, int N,
                      int H, int W, int C, int O, void* stream) {
  switch (wgrad_bn(O)) {
    case 16:
      return launch_wgrad_mma<16>(x, g, partial, N, H, W, C, O, stream);
    case 32:
      return launch_wgrad_mma<32>(x, g, partial, N, H, W, C, O, stream);
    default:
      return launch_wgrad_mma<64>(x, g, partial, N, H, W, C, O, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor-core kernels);
// x, w, b and y all of that type. b may be null (no bias).
int conv3x3_fwd(const void* x, const void* w, const void* b, void* y, int N,
                int H, int W, int C, int O, int dtype, void* stream) {
  if (dtype == 1)
    return launch_fwd_bf16<false>(x, w, b, y, nullptr, N, H, W, C, O, stream);
  return launch_fwd<float, false>(x, w, b, y, nullptr, N, H, W, C, O, stream);
}

// Rows of the (rows, 2, O) f32 partials tensor conv3x3_fwd_stats writes:
// one per block (bf16) or per block's pixel tile (f32).
int conv3x3_stats_rows(int N, int H, int W, int O, int dtype) {
  if (dtype == 1) return fwd_plan(N, H, W, O).blocks;
  return N * ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

int conv3x3_fwd_stats(const void* x, const void* w, const void* b, void* y,
                      void* partial, int N, int H, int W, int C, int O,
                      int dtype, void* stream) {
  if (dtype == 1)
    return launch_fwd_bf16<true>(x, w, b, y, partial, N, H, W, C, O, stream);
  return launch_fwd<float, true>(x, w, b, y, partial, N, H, W, C, O, stream);
}

// Number of pixel-range splits S of the (S, 3, 3, C, O) f32 partials
// tensor conv3x3_wgrad writes.
int conv3x3_wgrad_splits(int N, int H, int W, int C, int O, int dtype) {
  if (dtype == 1) return wgrad_plan(N, H, W, C, O).splits;
  const long long M = (long long)N * H * W;
  const long long per = wgrad_per_split(N, H, W, C, O);
  return (int)((M + per - 1) / per);
}

int conv3x3_wgrad(const void* x, const void* g, void* partial, int N, int H,
                  int W, int C, int O, int dtype, void* stream) {
  if (dtype == 1)
    return launch_wgrad_bf16(x, g, partial, N, H, W, C, O, stream);
  return launch_wgrad<float>(x, g, partial, N, H, W, C, O,
                             conv3x3_wgrad_splits(N, H, W, C, O, 0), stream);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
