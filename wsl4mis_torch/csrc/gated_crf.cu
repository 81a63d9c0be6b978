// Gated CRF neighbourhood contraction, for Hopper (sm_90a). Replaces
// _gcrf_kernel (wsl4mis_tpu/ops/pallas/gated_crf_pallas.py:37).
//
// For every pixel x of every image and every non-centre offset o of the
// (2r+1) x (2r+1) window:
//   k(x, o)   = sum_d w_d * exp(-0.5 * ||f_d(x+o) - f_d(x)||^2)
//   prod_c(x) = sum_o k(x, o) * p_c(x+o)
//   ksum      = sum_{x, o} k(x, o)
// with the feature map f = [f_0 | f_1 | ...] (descriptor d owns the feature
// channels whose desc_of entry is d) and the probabilities p ZERO outside
// the image. The zero padding is part of the function: a border pixel's
// kernel against an outside neighbour is w * exp(-0.5 * ||f(x)||^2), which
// adds to ksum and nothing to prod. So outside offsets are not skipped, and
// the distance is always taken between stored feature values.
//
// The TPU kernel holds one whole zero-padded image in VMEM per program and
// unrolls the offsets statically as shifted windows accumulated through its
// output refs, because Mosaic wants static slices; none of that is carried
// over. Here a block owns one TH x TW tile of one image: it stages the tile
// plus its r-halo of the F feature and C probability planes in shared
// memory (zero outside the image), and each thread owns one pixel, keeps its
// centre features and its C prod sums in registers and loops the offsets.
// The block's sum of k is reduced by warp shuffles and written as one f32
// partial per block, which the caller folds: no atomics, deterministic.
//
// What bounds it on the H100: arithmetic. Per pixel and offset it does
// about 3 F + 2 C + 5 f32 operations, one exp per descriptor among them, on
// shared memory, and moves only 4 (2 C + F) bytes per pixel in all, so it is far
// over the card's flop/byte line; the CUDA cores' f32 rate is the limit,
// not the memory. The shared-memory planes are pixel-contiguous, so a
// warp's 32 threads read 32 consecutive words at every offset.
//
// exp is expf (no fast-math): the loss is a difference of large sums.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TW = 32;           // tile width: one warp per tile row
constexpr int TH = 16;           // tile height
constexpr int NT = TW * TH;      // threads per block, one per pixel
constexpr int MAX_C = 8;         // classes
constexpr int MAX_F = 8;         // feature channels over all descriptors
constexpr int MAX_D = 4;         // descriptors
constexpr size_t MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct Desc {
  int nd;
  float w[MAX_D];
  int desc_of[MAX_F];  // descriptor of each feature channel
};

// EXACT: C == NC, F == NF, one descriptor owning every feature (the sizes
// are compile-time constants); else NC, NF, ND are upper bounds.
template <int NC, int NF, int ND, bool EXACT>
__global__ void __launch_bounds__(NT)
    gated_crf_kernel(const float* __restrict__ probs,
                     const float* __restrict__ feats,
                     float* __restrict__ prod, float* __restrict__ ksum_part,
                     int H, int W, int C, int F, int r, Desc desc) {
  extern __shared__ float smem[];
  __shared__ float s_red[NT / 32];

  const int nc = EXACT ? NC : C;
  const int nf = EXACT ? NF : F;
  const int nd = EXACT ? 1 : desc.nd;
  const int PW = TW + 2 * r;
  const int PH = TH + 2 * r;
  const int plane = PH * PW;
  float* s_f = smem;               // [nf][PH][PW]
  float* s_p = smem + nf * plane;  // [nc][PH][PW]

  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const float* fb = feats + (size_t)b * H * W * nf;
  const float* pb = probs + (size_t)b * H * W * nc;

  // tile + halo, channel fastest in global memory, zero outside the image
  for (int i = tid; i < plane * nf; i += NT) {
    const int ch = i % nf;
    const int pos = i / nf;
    const int gy = y0 + pos / PW - r;
    const int gx = x0 + pos % PW - r;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = fb[((size_t)gy * W + gx) * nf + ch];
    s_f[ch * plane + pos] = v;
  }
  for (int i = tid; i < plane * nc; i += NT) {
    const int ch = i % nc;
    const int pos = i / nc;
    const int gy = y0 + pos / PW - r;
    const int gx = x0 + pos % PW - r;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = pb[((size_t)gy * W + gx) * nc + ch];
    s_p[ch * plane + pos] = v;
  }
  __syncthreads();

  const int gx = x0 + tx;
  const int gy = y0 + ty;
  float ksum = 0.f;
  if (gx < W && gy < H) {
    float fc[NF];
    float acc[NC];
    const int cpos = (ty + r) * PW + tx + r;
#pragma unroll
    for (int f = 0; f < NF; ++f) fc[f] = f < nf ? s_f[f * plane + cpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;

    for (int dy = 0; dy <= 2 * r; ++dy) {
      for (int dx = 0; dx <= 2 * r; ++dx) {
        if (dy == r && dx == r) continue;
        const int npos = (ty + dy) * PW + tx + dx;
        float sq[ND];
#pragma unroll
        for (int d = 0; d < ND; ++d) sq[d] = 0.f;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          if (f < nf) {
            const float diff = s_f[f * plane + npos] - fc[f];
            const float d2 = diff * diff;
#pragma unroll
            for (int d = 0; d < ND; ++d)
              if (EXACT || desc.desc_of[f] == d) sq[d] += d2;
          }
        }
        float k = 0.f;
#pragma unroll
        for (int d = 0; d < ND; ++d)
          if (d < nd) k += desc.w[d] * expf(-0.5f * sq[d]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (c < nc) acc[c] += k * s_p[c * plane + npos];
        ksum += k;
      }
    }
    float* out = prod + (((size_t)b * H + gy) * W + gx) * nc;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) out[c] = acc[c];
  }

  // block sum of k: shuffles within each warp, then across the warps
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    ksum += __shfl_down_sync(0xffffffffu, ksum, s);
  if ((tid & 31) == 0) s_red[tid >> 5] = ksum;
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

template <int NC, int NF, int ND, bool EXACT>
int launch(const void* probs, const void* feats, void* prod, void* part,
           int B, int H, int W, int C, int F, int r, const Desc& desc,
           void* stream) {
  const size_t plane = (size_t)(TH + 2 * r) * (TW + 2 * r);
  const size_t bytes = (size_t)(C + F) * plane * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = gated_crf_kernel<NC, NF, ND, EXACT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(probs), static_cast<const float*>(feats),
      static_cast<float*>(prod), static_cast<float*>(part), H, W, C, F, r,
      desc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per image: the (B, blocks) f32 partials tensor of ksum.
int gated_crf_blocks(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

// probs (B,H,W,C) f32, feats (B,H,W,F) f32 -> prod (B,H,W,C) f32 and
// ksum_part (B, gated_crf_blocks(H, W)) f32. weights: host float[nd];
// desc_of: host int[F], the descriptor (0..nd-1) of each feature channel.
// Limits: C <= 8, F <= 8, nd <= 4, and (C + F) * (16 + 2 radius) *
// (32 + 2 radius) * 4 bytes of shared memory <= 232448.
int gated_crf_products(const void* probs, const void* feats, void* prod,
                       void* ksum_part, int B, int H, int W, int C, int F,
                       int radius, int nd, const void* weights,
                       const void* desc_of, void* stream) {
  if (C < 1 || C > MAX_C || F < 1 || F > MAX_F || nd < 1 || nd > MAX_D ||
      radius < 0 || B < 1 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Desc desc{};
  desc.nd = nd;
  for (int d = 0; d < nd; ++d)
    desc.w[d] = static_cast<const float*>(weights)[d];
  for (int f = 0; f < F; ++f) {
    const int d = static_cast<const int*>(desc_of)[f];
    if (d < 0 || d >= nd) return (int)cudaErrorInvalidValue;
    desc.desc_of[f] = d;
  }
  if (nd == 1 && C == 4 && F == 3)
    return launch<4, 3, 1, true>(probs, feats, prod, ksum_part, B, H, W, C, F,
                                 radius, desc, stream);
  return launch<MAX_C, MAX_F, MAX_D, false>(probs, feats, prod, ksum_part, B,
                                            H, W, C, F, radius, desc, stream);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
