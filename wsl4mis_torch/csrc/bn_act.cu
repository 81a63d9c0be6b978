// The U-Net ConvBlock's BatchNorm apply, LeakyReLU(0.01) and dropout, and
// their backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package leaves BN
// (wsl4mis_tpu/models/norm.py FusedBatchNorm), the LeakyReLU and the
// dropout (models/unet.py ConvBlock) to XLA, which fuses them into its own
// loops. Eager PyTorch ran them as some eighty small kernels a conv + BN
// layer: the statistics and their casts, the apply, the activation, the
// dropout's compare, cast and multiply, their autograd (whose per-channel
// sums round to bf16), the conv backward's fold of the moments' cotangent
// into the output cotangent, and the bias gradient's f32 reduction.
//
// What bounds them on the H100: bytes. Each element takes a few operations,
// far below the ridge, so each pass reads and writes every element once,
// 16 bytes a thread, and the passes are as few as the data flow allows:
//
//   bn_act_fwd_kernel   y (+ the dropout's uniform draw) -> the activation
//                       (+ a 1-byte keep mask). Each block forms the
//                       per-channel mul and add from the moments (train) or
//                       the running statistics (eval) in shared memory;
//                       block 0 also writes them for the backward (eval
//                       mode too, where a backward follows) and folds the
//                       batch into the running statistics. 4 bytes an
//                       element in bf16, 9 with dropout, where the eager
//                       chain made about a dozen passes.
//   bn_act_sums_kernel  backward pass 1: g, y (+ mask) -> per-block f32
//                       partials of sum g' and sum g' y per channel (g' the
//                       cotangent at the BN output, the activation's slope
//                       and the dropout's scale recomputed from y and the
//                       mask); the last block folds them and forms the scale
//                       and bias gradients and the moments' cotangents.
//   bn_act_bwd_kernel   pass 2: g, y (+ mask) -> the conv-output cotangent
//                       round(f32(round(g' mul)) + gs1 + 2 f32(y) gs2) and
//                       per-block partials of its rounded values, which the
//                       last block folds into the conv's bias gradient.
//
// The backward needs the per-channel sums of pass 1 before any element of
// pass 2, so it reads g and y twice (8-10 bytes an element in bf16, 14-16 in
// all with pass 2's write) where the eager chain's backward made about six
// full-size passes for the fold alone, two of them f32 writes.
//
// Rounding. The forward is the eager chain's arithmetic op for op, so its
// output is bit-equal to it: mean = s1 * (1/n) (PyTorch's CUDA division by a
// host scalar multiplies by the f32 reciprocal), the variance clamped at 0,
// rsqrtf, mul and add in f32 rounded to the compute dtype, then y * mul and
// + add each rounded to it, the LeakyReLU's product rounded, the dropout
// scale 1/keep rounded to the compute dtype and the product rounded. The
// library builds with -fmad=false: a contracted multiply-add would round
// once where the eager chain's separate kernels round twice. The backward's
// sums are f32 (the eager chain's rounded to bf16), folded in a fixed order.
//
// Determinism, capture. No atomics touch a sum. A block's partials fold in a
// fixed tree; the grid's partials fold in block order. The grid depends on
// the shape and the card's SM count alone. The last block of a backward
// pass is found with a ticket: a counter of that layer call's own, two
// words after its (5, C) saved values, which the forward zeroes and each
// backward pass's last block returns to 0. So two layer calls never share
// a ticket, on any stream. Every entry point launches on the given stream,
// allocates nothing, syncs nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int FWD_THREADS = 256;   // the forward's threads a block, at least
constexpr int BWD_THREADS = 1024;  // the backward's: one block an SM
constexpr int MAX_C = 512;         // channels a launch takes
constexpr int MAX_V = 8;           // channels a thread (16 bytes of bf16)
constexpr float SLOPE = 0.01f;     // the LeakyReLU's, float(0.01)

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

// v rounded to T, as f32: what an eager op of dtype T stores
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// A thread's V keep bytes as one word, stored and loaded at once
template <int V>
struct MaskWord;
template <>
struct MaskWord<8> {
  using type = unsigned long long;
};
template <>
struct MaskWord<4> {
  using type = unsigned int;
};
template <>
struct MaskWord<1> {
  using type = unsigned char;
};

template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&o)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(p)[j];
      o[4 * j] = q.x;
      o[4 * j + 1] = q.y;
      o[4 * j + 2] = q.z;
      o[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = p[k];
  }
}

// z = round(round(y * mul) + add), the BN apply in the compute dtype T
template <typename T>
__device__ __forceinline__ float bn_apply(float y, float mul_t, float add_t) {
  return rnd<T>(rnd<T>(y * mul_t) + add_t);
}

struct FwdArgs {
  const void* y;
  const float* s1;  // the moments, train mode
  const float* s2;
  const float* scale;
  const float* shift;
  float* mean;  // running statistics
  float* var;
  const float* u;  // the dropout's uniform draw, or null
  void* out;
  uint8_t* mask;  // with u
  float* fac;     // or null: (5, C) mean, unclamped var, r, mul, add, then
                  // the two backward passes' tickets
  int P, C, R;    // pixels, channels, pixel rows a block
  float inv_n, eps, m, m1, keep, dscale;
  int update;
};

template <typename T, int V, bool TRAIN, bool DROP>
__global__ void __launch_bounds__(2 * FWD_THREADS)
    bn_act_fwd_kernel(const FwdArgs a) {
  __shared__ float fmul[MAX_C], fadd[MAX_C];
  const int CV = a.C / V;
  const int cv = threadIdx.x % CV, pr = threadIdx.x / CV;
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    float mean, var, vun;
    if (TRAIN) {
      mean = a.s1[c] * a.inv_n;
      const float mean2 = a.s2[c] * a.inv_n;
      vun = mean2 - mean * mean;
      var = isnan(vun) ? vun : fmaxf(vun, 0.f);
    } else {
      mean = a.mean[c];
      vun = var = a.var[c];
    }
    const float r = rsqrtf(var + a.eps);
    const float mul = a.scale[c] * r;
    const float add = a.shift[c] - mean * mul;
    if (blockIdx.x == 0) {
      if (TRAIN && a.update) {
        a.mean[c] = a.m * a.mean[c] + a.m1 * mean;
        a.var[c] = a.m * a.var[c] + a.m1 * var;
      }
      if (a.fac) {
        float* f = a.fac + c;
        f[0] = mean;
        f[a.C] = vun;
        f[2 * a.C] = r;
        f[3 * a.C] = mul;
        f[4 * a.C] = add;
      }
    }
    fmul[c] = rnd<T>(mul);
    fadd[c] = rnd<T>(add);
  }
  if (blockIdx.x == 0 && a.fac && threadIdx.x < 2)  // a block: >= 256 threads
    reinterpret_cast<unsigned int*>(a.fac + 5 * a.C)[threadIdx.x] = 0u;
  __syncthreads();
  float mul_t[V], add_t[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mul_t[k] = fmul[cv * V + k];
    add_t[k] = fadd[cv * V + k];
  }
  const T* __restrict__ y = static_cast<const T*>(a.y);
  T* __restrict__ out = static_cast<T*>(a.out);
  for (long long p = (long long)blockIdx.x * a.R + pr; p < a.P;
       p += (long long)gridDim.x * a.R) {
    const size_t e = (size_t)p * a.C + (size_t)cv * V;
    const Pack<T, V> yv = *reinterpret_cast<const Pack<T, V>*>(y + e);
    float uv[V];
    if (DROP) load_f32<V>(a.u + e, uv);
    using M = typename MaskWord<V>::type;
    Pack<T, V> ov;
    M mw = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float z = bn_apply<T>(to_f32(yv.v[k]), mul_t[k], add_t[k]);
      float o = z > 0.f ? z : rnd<T>(z * SLOPE);
      if (DROP) {
        const bool keep = uv[k] < a.keep;
        o = rnd<T>(o * (keep ? a.dscale : 0.f));
        mw |= (M)keep << (8 * k);
      }
      ov.v[k] = from_f32<T>(o);
    }
    *reinterpret_cast<Pack<T, V>*>(out + e) = ov;
    if (DROP) *reinterpret_cast<M*>(a.mask + e) = mw;
  }
}

struct BwdArgs {
  const void* g;
  const void* y;
  const uint8_t* mask;  // or null
  const float* fac;      // the forward's (5, C), then the tickets
  unsigned int* ticket;  // this pass's: fac + 5 C (pass 1), + 1 (pass 2)
  const float* scale;    // pass 1
  const float* gs1;      // pass 2: the moments' cotangents
  const float* gs2;
  float* part;  // (gridDim.x, J) partials
  float* out;   // pass 1: (4, C) d scale, d shift, gs1, gs2 (this rank's)
  void* gout;   // pass 2: the conv-output cotangent
  void* db;     // pass 2: the conv's bias gradient (C,)
  int P, C, R;
  float inv_n, dscale;
};

// g' at one thread's V channels of pixel p, and f32(y) there
template <typename T, int V, bool DROP>
__device__ __forceinline__ void grad_at(const BwdArgs& a, long long p, int cv,
                                        const float* mul_t,
                                        const float* add_t, float (&gp)[V],
                                        float (&yf)[V]) {
  const size_t e = (size_t)p * a.C + (size_t)cv * V;
  const Pack<T, V> gv =
      *reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(a.g) + e);
  const Pack<T, V> yv =
      *reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(a.y) + e);
  using M = typename MaskWord<V>::type;
  M mw = 0;
  if (DROP) mw = *reinterpret_cast<const M*>(a.mask + e);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = cv * V + k;
    yf[k] = to_f32(yv.v[k]);
    const float z = bn_apply<T>(yf[k], mul_t[c], add_t[c]);
    float ga = to_f32(gv.v[k]);
    if (DROP) ga = rnd<T>(ga * (((mw >> (8 * k)) & 0xff) ? a.dscale : 0.f));
    gp[k] = z > 0.f ? ga : rnd<T>(ga * SLOPE);
  }
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The block's per-channel sums of acc over its pixel rows: a fixed tree
// over the rows in red (blockDim.x * V floats, laid out [k][thread] so that
// a warp's accesses fall in distinct banks). Channel cv * V + k's sum ends
// in red[k * blockDim.x + cv].
template <int V>
__device__ void block_rows_sum(const float (&acc)[V], float* red, int R,
                               int CV) {
  const int t = threadIdx.x, n = blockDim.x;
#pragma unroll
  for (int k = 0; k < V; ++k) red[k * n + t] = acc[k];
  __syncthreads();
  const int pr = t / CV;
  for (int h = pow2_ceil(R) / 2; h > 0; h >>= 1) {
    if (pr < h && pr + h < R) {
#pragma unroll
      for (int k = 0; k < V; ++k) red[k * n + t] += red[k * n + t + h * CV];
    }
    __syncthreads();
  }
}

// Channel c's block sum after block_rows_sum
template <int V>
__device__ __forceinline__ float block_sum_of(const float* red, int c) {
  return red[(c % V) * blockDim.x + c / V];
}

// Whether this block is the grid's last to get here; the other blocks'
// writes before their call are visible to it after.
__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// In the last block: red[j] = sum over b of part[b * J + j], J <= blockDim.x,
// folded in a fixed order (segment s takes rows s, s + S, ... in turn, then
// a tree over the segments).
__device__ void fold_rows(const float* part, int B, int J, float* red) {
  const int S = blockDim.x / J;
  const int t = threadIdx.x, j = t % J, s = t / J;
  float acc = 0.f;
  if (s < S) {
#pragma unroll 4
    for (int b = s; b < B; b += S) acc += __ldcg(part + (size_t)b * J + j);
  }
  __syncthreads();  // red may still be read by the caller's partial write
  red[t] = acc;
  __syncthreads();
  for (int h = pow2_ceil(S) / 2; h > 0; h >>= 1) {
    if (s < h && s + h < S) red[t] += red[t + h * J];
    __syncthreads();
  }
}

template <typename T, int V, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS)
    bn_act_sums_kernel(const BwdArgs a) {
  __shared__ float mul_t[MAX_C], add_t[MAX_C];
  __shared__ float red[BWD_THREADS * MAX_V];
  const int C = a.C, CV = C / V;
  const int t = threadIdx.x, cv = t % CV, pr = t / CV;
  for (int c = t; c < C; c += blockDim.x) {
    mul_t[c] = rnd<T>(a.fac[3 * C + c]);
    add_t[c] = rnd<T>(a.fac[4 * C + c]);
  }
  __syncthreads();
  float s1[V] = {}, s2[V] = {};
  for (long long p = (long long)blockIdx.x * a.R + pr; p < a.P;
       p += (long long)gridDim.x * a.R) {
    float gp[V], yf[V];
    grad_at<T, V, DROP>(a, p, cv, mul_t, add_t, gp, yf);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1[k] += gp[k];
      s2[k] += gp[k] * yf[k];
    }
  }
  float* part = a.part + (size_t)blockIdx.x * 2 * C;
  block_rows_sum<V>(s1, red, a.R, CV);
  for (int c = t; c < C; c += blockDim.x) part[c] = block_sum_of<V>(red, c);
  __syncthreads();
  block_rows_sum<V>(s2, red, a.R, CV);
  for (int c = t; c < C; c += blockDim.x)
    part[C + c] = block_sum_of<V>(red, c);
  if (!last_block(a.ticket)) return;
  fold_rows(a.part, gridDim.x, 2 * C, red);
  // The eager chain's autograd, per channel, from the sums of g' (the
  // shift's gradient) and of g' y (the rounded mul's)
  for (int c = t; c < C; c += blockDim.x) {
    const float G1 = red[c], G2 = red[C + c];
    const float mean = a.fac[c], vun = a.fac[C + c], r = a.fac[2 * C + c],
                mul = a.fac[3 * C + c];
    const float gmul = G2 - G1 * mean;  // add = shift - mean * mul
    const float gr = gmul * a.scale[c];
    float gvar = -0.5f * gr * (r * r * r);  // d rsqrt(v) = -r^3 / 2
    if (!(vun >= 0.f)) gvar = 0.f;          // the clamp at 0
    const float gmean = -(G1 * mul) - 2.f * gvar * mean;
    a.out[c] = gmul * r;
    a.out[C + c] = G1;
    a.out[2 * C + c] = gmean * a.inv_n;
    a.out[3 * C + c] = gvar * a.inv_n;
  }
  if (t == 0) *a.ticket = 0u;
}

template <typename T, int V, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS)
    bn_act_bwd_kernel(const BwdArgs a) {
  __shared__ float mul_t[MAX_C], add_t[MAX_C], gs1[MAX_C], gs2[MAX_C];
  __shared__ float red[BWD_THREADS * MAX_V];
  const int C = a.C, CV = C / V;
  const int t = threadIdx.x, cv = t % CV, pr = t / CV;
  for (int c = t; c < C; c += blockDim.x) {
    mul_t[c] = rnd<T>(a.fac[3 * C + c]);
    add_t[c] = rnd<T>(a.fac[4 * C + c]);
    gs1[c] = a.gs1[c];
    gs2[c] = a.gs2[c];
  }
  __syncthreads();
  T* __restrict__ gout = static_cast<T*>(a.gout);
  float sum[V] = {};
  for (long long p = (long long)blockIdx.x * a.R + pr; p < a.P;
       p += (long long)gridDim.x * a.R) {
    float gp[V], yf[V];
    grad_at<T, V, DROP>(a, p, cv, mul_t, add_t, gp, yf);
    Pack<T, V> ov;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = cv * V + k;
      const float gy = rnd<T>(gp[k] * mul_t[c]);
      const float v = rnd<T>((gy + gs1[c]) + (2.f * yf[k]) * gs2[c]);
      ov.v[k] = from_f32<T>(v);
      sum[k] += v;
    }
    *reinterpret_cast<Pack<T, V>*>(gout + (size_t)p * C + (size_t)cv * V) =
        ov;
  }
  block_rows_sum<V>(sum, red, a.R, CV);
  float* part = a.part + (size_t)blockIdx.x * C;
  for (int c = t; c < C; c += blockDim.x) part[c] = block_sum_of<V>(red, c);
  if (!last_block(a.ticket)) return;
  fold_rows(a.part, gridDim.x, C, red);
  T* db = static_cast<T*>(a.db);
  for (int c = t; c < C; c += blockDim.x) db[c] = from_f32<T>(red[c]);
  if (t == 0) *a.ticket = 0u;
}

// Channels a thread: 16 bytes' worth when C is a multiple of it, else 1.
template <typename T>
constexpr int vec_width() {
  return 16 / (int)sizeof(T);
}

int sm_count() {
  static int memo[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (!memo[dev])
    cudaDeviceGetAttribute(&memo[dev], cudaDevAttrMultiProcessorCount, dev);
  return memo[dev] > 0 ? memo[dev] : 132;
}

// A block's pixel rows R (its threads are R x C/V) and the grid: the forward
// four pixels a thread, up to 16 blocks an SM, over a grid-stride loop; the
// backward one block of BWD_THREADS an SM (its partials fold in one block).
struct Plan {
  int R, threads, blocks;
};

Plan plan(int P, int C, int V, bool backward) {
  const int CV = C / V;
  const int want = backward ? BWD_THREADS : FWD_THREADS;
  const int R = CV >= want ? 1 : want / CV;
  const long long per = backward ? R : 4LL * R;
  const long long rows = ((long long)P + per - 1) / per;
  const long long cap = backward ? sm_count() : 16LL * sm_count();
  const long long blocks = rows < 1 ? 1 : (rows < cap ? rows : cap);
  return {R, R * CV, (int)blocks};
}

template <typename T, int V>
int launch_fwd(FwdArgs a, bool train, cudaStream_t stream) {
  const Plan pl = plan(a.P, a.C, V, false);
  a.R = pl.R;
  if (train && a.u)
    bn_act_fwd_kernel<T, V, true, true>
        <<<pl.blocks, pl.threads, 0, stream>>>(a);
  else if (train)
    bn_act_fwd_kernel<T, V, true, false>
        <<<pl.blocks, pl.threads, 0, stream>>>(a);
  else
    bn_act_fwd_kernel<T, V, false, false>
        <<<pl.blocks, pl.threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(BwdArgs a, bool sums, cudaStream_t stream) {
  const Plan pl = plan(a.P, a.C, V, true);
  a.R = pl.R;
  if (sums) {
    if (a.mask)
      bn_act_sums_kernel<T, V, true><<<pl.blocks, pl.threads, 0, stream>>>(a);
    else
      bn_act_sums_kernel<T, V, false><<<pl.blocks, pl.threads, 0, stream>>>(a);
  } else {
    if (a.mask)
      bn_act_bwd_kernel<T, V, true><<<pl.blocks, pl.threads, 0, stream>>>(a);
    else
      bn_act_bwd_kernel<T, V, false><<<pl.blocks, pl.threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int width(int C) {
  return C % vec_width<T>() == 0 ? vec_width<T>() : 1;
}

bool bad_shape(int P, int C) { return P < 0 || C < 1 || C > MAX_C; }

// A backward pass's ticket: word `pass` after fac's 5 C values
unsigned int* ticket_of(const void* fac, int C, int pass) {
  return reinterpret_cast<unsigned int*>(
             const_cast<float*>(static_cast<const float*>(fac)) + 5 * C) +
         pass;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (y, out, g, the cotangent and db; every
// other float array is f32). Tensors are contiguous, (P, C) with P = N*H*W
// pixels, C <= 512 channels, and 16-byte aligned at element 0 (u too). train:
// s1, s2 the batch's moments (sum y, sum y^2, of the global batch under a
// process group); eval: the running statistics, s1 = s2 = u = null. fac: 5 C
// + 2 words for the backward (the per-channel values, then its tickets,
// zeroed here), or null (eval mode without a backward); train mode needs it.
// u (P, C) f32 or null; mask (P, C) bytes with it. update: fold the batch
// into mean and var (momentum m, m1 = 1 - m as f32). keep: the dropout's
// keep probability as f32; dscale: 1/keep rounded to the compute dtype.
int bn_act_fwd(const void* y, const void* s1, const void* s2,
               const void* scale, const void* shift, void* mean, void* var,
               const void* u, void* out, void* mask, void* fac, int P, int C,
               float inv_n, float eps, float m, float m1, float keep,
               float dscale, int train, int update, int dtype,
               void* stream) {
  if (bad_shape(P, C) || (u && !(train && mask)) || (train && !fac))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{y,   (const float*)s1, (const float*)s2, (const float*)scale,
            (const float*)shift, (float*)mean, (float*)var, (const float*)u,
            out, (uint8_t*)mask, (float*)fac, P, C, 0, inv_n, eps, m, m1,
            keep, dscale, update};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return width<__nv_bfloat16>(C) == 8
               ? launch_fwd<__nv_bfloat16, 8>(a, train, st)
               : launch_fwd<__nv_bfloat16, 1>(a, train, st);
  return width<float>(C) == 4 ? launch_fwd<float, 4>(a, train, st)
                              : launch_fwd<float, 1>(a, train, st);
}

// Rows of the backward passes' partials (their blocks): pass 1 writes
// (rows, 2, C) f32, pass 2 (rows, C).
int bn_act_blocks(int P, int C, int dtype) {
  if (bad_shape(P, C)) return 0;
  const int V = dtype == 1 ? width<__nv_bfloat16>(C) : width<float>(C);
  return plan(P, C, V, true).blocks;
}

// Backward pass 1: g (the cotangent of the activation), y, mask (or null),
// the forward's fac (with its tickets) and the BN scale -> out (4, C) f32:
// the scale's and the shift's gradients and the cotangents of this rank's
// moments s1, s2 (eval mode: not used, the moments fed nothing).
int bn_act_sums(const void* g, const void* y, const void* mask,
                const void* fac, const void* scale, void* part, void* out,
                int P, int C, float inv_n, float dscale, int dtype,
                void* stream) {
  if (bad_shape(P, C) || !fac) return (int)cudaErrorInvalidValue;
  BwdArgs a{g,       y,       (const uint8_t*)mask, (const float*)fac,
            ticket_of(fac, C, 0), (const float*)scale, nullptr, nullptr,
            (float*)part, (float*)out, nullptr, nullptr, P, C, 0, inv_n,
            dscale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return width<__nv_bfloat16>(C) == 8
               ? launch_bwd<__nv_bfloat16, 8>(a, true, st)
               : launch_bwd<__nv_bfloat16, 1>(a, true, st);
  return width<float>(C) == 4 ? launch_bwd<float, 4>(a, true, st)
                              : launch_bwd<float, 1>(a, true, st);
}

// Backward pass 2: g, y, mask, fac and the moments' cotangents gs1, gs2 (f32,
// summed over the ranks) -> gout (P, C), the conv-output cotangent, and db
// (C,), its sum: the conv's bias gradient, both in the compute dtype.
int bn_act_bwd(const void* g, const void* y, const void* mask,
               const void* fac, const void* gs1, const void* gs2, void* gout,
               void* part, void* db, int P, int C, float dscale, int dtype,
               void* stream) {
  if (bad_shape(P, C) || !fac) return (int)cudaErrorInvalidValue;
  BwdArgs a{g,       y,         (const uint8_t*)mask, (const float*)fac,
            ticket_of(fac, C, 1), nullptr, (const float*)gs1,
            (const float*)gs2, (float*)part, nullptr, gout, db, P, C, 0, 0.f,
            dscale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return width<__nv_bfloat16>(C) == 8
               ? launch_bwd<__nv_bfloat16, 8>(a, false, st)
               : launch_bwd<__nv_bfloat16, 1>(a, false, st);
  return width<float>(C) == 4 ? launch_bwd<float, 4>(a, false, st)
                              : launch_bwd<float, 1>(a, false, st);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
