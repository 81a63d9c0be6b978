// 3x3 SAME stride-1 convolution on NHWC activations and HWIO weights, for
// Hopper (sm_90a): the forward, the forward with per-channel output moments,
// and the weight gradient. The input gradient is the forward applied to the
// output gradient with the spatially rotated, in/out-swapped weights.
//
// Replaces (wsl4mis_tpu/ops/pallas/banded_conv_pallas.py):
//   _fwd_kernel        (:329) -> conv3x3_fwd_kernel<T, false>
//   _fwd_stats_kernel  (:340) -> conv3x3_fwd_kernel<T, true>
//   _wgrad_kernel      (:377) -> conv3x3_wgrad_kernel<T, TC, TO>
// The TPU kernels pack W*C into 128-lane bands so that the MXU sees dense
// tiles; that layout exists for the TPU's matrix unit and is not carried
// over. These kernels compute the same function directly on NHWC.
//
// What bounds them on the H100: at the U-Net's widths (C, O in 1..256) a
// 3x3 conv does 18*C*O flops per pixel on 2*(C+O) bytes (bf16), so for
// C, O >= 16 it is over the card's flop/byte line and the bound is
// arithmetic. These kernels do the arithmetic as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16), so they
// sit well above the bound; that is the simple first version. The design
// keeps the FMA units fed from registers and shared memory: the forward
// stages one input halo and one weight slab per 16-channel chunk in shared
// memory and gives every thread a 2-pixel x 16-channel register tile, so each
// shared-memory load feeds 8 to 16 FMAs. Tensor-core (wgmma) tiles and
// TMA pipelining are later work.
//
// Numerics: inputs are widened to f32, products accumulate in f32, the bias
// (in the input dtype) is added in f32 and the sum is rounded once to the
// output dtype. The moments are taken over the rounded stored values, as the
// TPU kernel does. Every cross-block sum goes through a partials tensor that
// the caller folds with a torch reduction: no atomics, deterministic.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One block: image n = blockIdx.z, a TH x TW pixel tile (blockIdx.x), and
// OT output channels (blockIdx.y). With STATS, it also writes the sums of
// y and y*y over its valid pixels to partial[(n*tiles + tile), {0,1}, o].
template <typename T, bool STATS>
__global__ void __launch_bounds__(NT)
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

  // epilogue: bias in f32, one rounding to T, store; moments of the rounded y
  const int ox = x0 + tx;
  float s1[OT], s2[OT];
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    s1[o] = 0.f;
    s2[o] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < PY; ++r) {
    const int oy = y0 + ty * PY + r;
    const bool valid = oy < H && ox < W;
    T* yp = y + (((size_t)n * H + oy) * W + ox) * O + o0;
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      if (valid && o0 + o < O) {
        const float bias = b != nullptr ? to_f32(b[o0 + o]) : 0.f;
        const T v = from_f32<T>(acc[r][o] + bias);
        yp[o] = v;
        if (STATS) {
          const float vf = to_f32(v);
          s1[o] += vf;
          s2[o] += vf * vf;
        }
      }
    }
  }
  if (STATS) {
    __shared__ float s_red[NT / 32][2][OT];
    const int lane = tid % 32;
    const int warp = tid / 32;
#pragma unroll
    for (int o = 0; o < OT; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1[o] += __shfl_xor_sync(0xffffffffu, s1[o], off);
        s2[o] += __shfl_xor_sync(0xffffffffu, s2[o], off);
      }
      if (lane == 0) {
        s_red[warp][0][o] = s1[o];
        s_red[warp][1][o] = s2[o];
      }
    }
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y all of that type).
// b may be null (no bias).
int conv3x3_fwd(const void* x, const void* w, const void* b, void* y, int N,
                int H, int W, int C, int O, int dtype, void* stream) {
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, false>(x, w, b, y, nullptr, N, H, W, C,
                                            O, stream);
  return launch_fwd<float, false>(x, w, b, y, nullptr, N, H, W, C, O, stream);
}

// Rows of the (rows, 2, O) f32 partials tensor conv3x3_fwd_stats writes.
int conv3x3_stats_rows(int N, int H, int W) {
  return N * ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

int conv3x3_fwd_stats(const void* x, const void* w, const void* b, void* y,
                      void* partial, int N, int H, int W, int C, int O,
                      int dtype, void* stream) {
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, true>(x, w, b, y, partial, N, H, W, C, O,
                                           stream);
  return launch_fwd<float, true>(x, w, b, y, partial, N, H, W, C, O, stream);
}

// Number of pixel-range splits S of the (S, 3, 3, C, O) f32 partials
// tensor conv3x3_wgrad writes.
int conv3x3_wgrad_splits(int N, int H, int W, int C, int O) {
  const long long M = (long long)N * H * W;
  const long long per = wgrad_per_split(N, H, W, C, O);
  return (int)((M + per - 1) / per);
}

int conv3x3_wgrad(const void* x, const void* g, void* partial, int N, int H,
                  int W, int C, int O, int splits, int dtype, void* stream) {
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, g, partial, N, H, W, C, O, splits,
                                       stream);
  return launch_wgrad<float>(x, g, partial, N, H, W, C, O, splits, stream);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
