// 2x2 stride-2 max pool on NHWC activations and its first-max backward, for
// Hopper (sm_90a).
//
// Replaces (wsl4mis_tpu/ops/pallas/maxpool_pallas.py):
//   _fwd_kernel (:70) -> maxpool_fwd_kernel<T, V>
//   _bwd_kernel (:92) -> maxpool_bwd_kernel<T, V>
// The TPU backward takes y and g upsampled to full resolution and finds the
// first max with unit shifts and parity masks, because Mosaic compiles no
// strided access; here a thread simply reads the four taps of its window.
//
// Forward: y[n,i,j,c] = max of x[n,2i+a,2j+b,c] over a, b in {0, 1}. A NaN in
// the window gives NaN (the comparison below propagates it, fmaxf would drop
// it). Backward: the window's g goes to the first tap, in the order (0,0),
// (0,1), (1,0), (1,1), that equals the window's max, and 0 to the other
// three; the max is recomputed from x, so y is not read. In a window that
// holds a NaN no tap equals the max, and g falls through to tap (1,1), as in
// the plain version's masks. Every dx element is written exactly once: no
// zero fill, no atomics. Values are compared as f32; bf16 -> f32 is exact, so
// ties are the stored values' ties.
//
// What bounds them on the H100: memory. The forward reads x once and writes
// a quarter of it; the backward reads x and g and writes dx; there are three
// comparisons per element. One thread owns one window and V consecutive
// channels (16 bytes when C allows it, else one channel), with the channel
// vector fastest across threads, so a warp's loads and stores are contiguous
// runs of the NHWC rows.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// max(m, b) that keeps a NaN from either side
__device__ __forceinline__ float nan_max(float m, float b) {
  return (b > m || b != b) ? b : m;
}

// Element offset of x[n, 2i, 2j, cv*V] for the window and channel vector of
// flat index idx; `row` is one input row (W*C elements).
template <typename T, int V>
__device__ __forceinline__ size_t window_base(long long idx, int H2, int W2,
                                              int CV, int& cv, size_t& row) {
  cv = (int)(idx % CV);
  long long p = idx / CV;
  const int j = (int)(p % W2);
  p /= W2;
  const int i = (int)(p % H2);
  const long long n = p / H2;
  row = (size_t)2 * W2 * CV * V;
  return ((size_t)n * 2 * H2 + 2 * i) * row + ((size_t)2 * j * CV + cv) * V;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long total, int H2, int W2, int CV) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  int cv;
  size_t row;
  const size_t base = window_base<T, V>(idx, H2, W2, CV, cv, row);
  const size_t px = (size_t)CV * V;  // one pixel
  using P = Pack<T, V>;
  const P t00 = *reinterpret_cast<const P*>(x + base);
  const P t01 = *reinterpret_cast<const P*>(x + base + px);
  const P t10 = *reinterpret_cast<const P*>(x + base + row);
  const P t11 = *reinterpret_cast<const P*>(x + base + row + px);
  P out;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float m = to_f32(t00.v[k]);
    T best = t00.v[k];
    float b = to_f32(t01.v[k]);
    if (b > m || b != b) { m = b; best = t01.v[k]; }
    b = to_f32(t10.v[k]);
    if (b > m || b != b) { m = b; best = t10.v[k]; }
    b = to_f32(t11.v[k]);
    if (b > m || b != b) { m = b; best = t11.v[k]; }
    out.v[k] = best;
  }
  *reinterpret_cast<P*>(y + (size_t)idx * V) = out;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ dx, long long total, int H2, int W2,
                       int CV) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  int cv;
  size_t row;
  const size_t base = window_base<T, V>(idx, H2, W2, CV, cv, row);
  const size_t px = (size_t)CV * V;
  using P = Pack<T, V>;
  const P t00 = *reinterpret_cast<const P*>(x + base);
  const P t01 = *reinterpret_cast<const P*>(x + base + px);
  const P t10 = *reinterpret_cast<const P*>(x + base + row);
  const P t11 = *reinterpret_cast<const P*>(x + base + row + px);
  const P gv = *reinterpret_cast<const P*>(g + (size_t)idx * V);
  P d00, d01, d10, d11;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float a = to_f32(t00.v[k]);
    const float b = to_f32(t01.v[k]);
    const float c = to_f32(t10.v[k]);
    const float d = to_f32(t11.v[k]);
    const float m = nan_max(nan_max(nan_max(a, b), c), d);
    int first = 3;
    if (c == m) first = 2;
    if (b == m) first = 1;
    if (a == m) first = 0;
    const T zero = zero_of<T>();
    d00.v[k] = first == 0 ? gv.v[k] : zero;
    d01.v[k] = first == 1 ? gv.v[k] : zero;
    d10.v[k] = first == 2 ? gv.v[k] : zero;
    d11.v[k] = first == 3 ? gv.v[k] : zero;
  }
  *reinterpret_cast<P*>(dx + base) = d00;
  *reinterpret_cast<P*>(dx + base + px) = d01;
  *reinterpret_cast<P*>(dx + base + row) = d10;
  *reinterpret_cast<P*>(dx + base + row + px) = d11;
}

// Channels per thread: 16 bytes' worth when C is a multiple of it, else 1.
template <typename T>
constexpr int vec_width() {
  return 16 / (int)sizeof(T);
}

template <typename T, int V>
int launch(const void* x, const void* g, void* out, int N, int H, int W,
           int C, bool backward, void* stream) {
  const int H2 = H / 2, W2 = W / 2, CV = C / V;
  const long long total = (long long)N * H2 * W2 * CV;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (backward)
    maxpool_bwd_kernel<T, V><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<T*>(out), total, H2, W2, CV);
  else
    maxpool_fwd_kernel<T, V><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), total, H2, W2, CV);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* g, void* out, int N, int H, int W,
             int C, bool backward, void* stream) {
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  if (C % vec_width<T>() == 0)
    return launch<T, vec_width<T>()>(x, g, out, N, H, W, C, backward, stream);
  return launch<T, 1>(x, g, out, N, H, W, C, backward, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (N,H,W,C) -> y (N,H/2,W/2,C); H and W
// even; tensors contiguous and 16-byte aligned at element 0.
int maxpool_fwd(const void* x, void* y, int N, int H, int W, int C,
                int dtype, void* stream) {
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, nullptr, y, N, H, W, C, false, stream);
  return dispatch<float>(x, nullptr, y, N, H, W, C, false, stream);
}

// x (N,H,W,C), g (N,H/2,W/2,C) -> dx (N,H,W,C), all of one dtype.
int maxpool_bwd(const void* x, const void* g, void* dx, int N, int H, int W,
                int C, int dtype, void* stream) {
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, g, dx, N, H, W, C, true, stream);
  return dispatch<float>(x, g, dx, N, H, W, C, true, stream);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
