// 3x3 SAME stride-1 convolution on NHWC activations and HWIO weights, for
// Hopper (sm_90a): the forward, the forward with per-channel output moments,
// and the weight gradient. The input gradient is the forward applied to the
// output gradient with the spatially rotated, in/out-swapped weights.
//
// Replaces (wsl4mis_tpu/ops/pallas/banded_conv_pallas.py):
//   _fwd_kernel        (:329) -> conv3x3_fwd_mma_kernel<BN, false> (bf16),
//                                conv3x3_fwd_kernel<BO, false>      (f32)
//   _fwd_stats_kernel  (:340) -> conv3x3_fwd_mma_kernel<BN, true>  (bf16),
//                                conv3x3_fwd_kernel<BO, true>       (f32)
//   _wgrad_kernel      (:377) -> conv3x3_wgrad_mma_kernel<BN>       (bf16),
//                                conv3x3_wgrad_kernel<BO>           (f32)
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
//   the halo is read once per BN outputs (16 times less than 16-output
//   blocks would at O = 256). Each warp holds MT m16 tiles
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
// f32 (compute_dtype="float32" and the card-vs-CPU reference check): exact
// f32 FFMA on the CUDA cores, no tensor-core operation. TF32 would keep 10
// mantissa bits and break the f32 check's 1e-4 limit and the gradient
// check's argument (PERF.md); only the order of summation differs from the
// plain version. At 67 TFLOP/s of FFMA against 3.35 TB/s, a conv's 18*C*O
// flops per pixel on 4*(C+O) bytes make every U-Net level bound by
// operations but the stem (C = 1) and the head (O = 4): a fully_supervised
// b24 step's forward, input and weight gradients are 419 GFLOP, 6.26 ms.
// So the design keeps the FMA pipes fed from registers:
// - Forward (and the input gradient), Y[p, o] = sum_(tap, c) X_tap[p, c]
//   W[tap, c, o]: persistent blocks of 256 threads, each block owning BO
//   outputs (the least of 16..128 >= O) and walking (1024/BO) x 16 pixel
//   tiles, so the halo is read once per BO outputs. A thread holds the
//   outer product of 8 pixels (8 columns of one tile row) by 8 outputs
//   (4j..4j+3 and BO/2+4j..: a warp's float4 weight loads are contiguous):
//   per 4 channels and tap row, 10 float4 halo loads and 24 float4 weight
//   loads feed 768 FFMA. A step is one tile's 8-channel slice, the halo
//   (pixel-major, rows padded to 20 mod 32 floats: a warp's rows fall on
//   distinct banks) and the 9 x 8 x BO weights, copied by 16-byte cp.async
//   in a 2-stage ring, so the next step's copies overlap this one's FMAs.
//   The epilogue adds the f32 bias, stores each value once (float4 where
//   O allows) and, with the moments, sums y and y*y of the stored values:
//   over a thread's pixels, by shuffles over the warp's rows, into the
//   warp's shared sums in tile order, and per block in warp order.
// - Weight gradient, dK[(tap, c), o] = sum_p X_tap[p, c] G[p, o]: a block
//   owns 16 input channels, BO = 16, 32 or 64 outputs and all 9 taps, over
//   a range of 8 x 16 pixel tiles; each tile's 10 x 18 x 16 halo and its
//   128 x BO slice of g are read once (cp.async ring) and the 9 taps are
//   shifted views. A thread owns a tap row ky, a quad of channels and 8
//   outputs (96 accumulators) and walks tile rows keeping a 3-pixel window
//   of the halo row in registers: a float4 of x and two of g a pixel feed
//   96 FFMA. Pixel coordinates come from the tile. The block's row groups
//   are summed in shared memory in a fixed order, the blocks' ranges go to
//   f32 partials (as many splits as fill one wave of resident blocks, no
//   more partial bytes than x and g hold).
// - Ragged shapes: a C or O that is no multiple of 4 (or an unaligned
//   base) is staged 4 floats at a time through registers into the same
//   layout; channels past C, outputs past O and pixels outside the image
//   are zero-filled and never stored or counted.
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

// ---- helpers of both precisions ---------------------------------------------

constexpr int kSms = 132;  // H100 SXM; sizes the bf16 grids

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

// ---- f32 kernels on the CUDA cores ------------------------------------------

constexpr int F32_THREADS = 256;  // forward block
constexpr int F32_CC = 8;         // input channels of a forward step

__device__ __forceinline__ int clamp4(int v) {
  return v < 0 ? 0 : v > 4 ? 4 : v;
}

// Four floats from src[0..valid), zeros after, into a 16-byte shared slot:
// one cp.async where vec (then valid is 0 or 4), else through registers.
__device__ __forceinline__ void stage4f(float* dst, const float* src,
                                        int valid, bool vec) {
  if (vec) {
    cp_async16(smem_u32(dst), src, valid > 0);
    return;
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = src[0];
  if (valid > 1) v.y = src[1];
  if (valid > 2) v.z = src[2];
  if (valid > 3) v.w = src[3];
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[0..3] += a * lo, acc[4..7] += a * hi
__device__ __forceinline__ void fma8(float (&acc)[8], float a,
                                     const float4& lo, const float4& hi) {
  acc[0] = fmaf(a, lo.x, acc[0]);
  acc[1] = fmaf(a, lo.y, acc[1]);
  acc[2] = fmaf(a, lo.z, acc[2]);
  acc[3] = fmaf(a, lo.w, acc[3]);
  acc[4] = fmaf(a, hi.x, acc[4]);
  acc[5] = fmaf(a, hi.y, acc[5]);
  acc[6] = fmaf(a, hi.z, acc[6]);
  acc[7] = fmaf(a, hi.w, acc[7]);
}

// Whether rows of `ch` f32 channels from p can be copied 16 bytes at a
// time: 4-channel groups, and a 16-byte aligned base.
bool vec16f(const void* p, int ch) {
  return ch % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Resident blocks an SM and SMs of the current device for a kernel with
// `smem` bytes of dynamic shared memory. Each device's first answer is
// kept (memo), so that a partials tensor sized from it and the launch that
// fills it agree, given both are asked on one current device (the Python
// wrappers size and launch inside one `on_device`); if the runtime cannot
// answer, one block an SM.
struct Residency {
  int per_sm, sms;
};

template <typename K>
Residency residency(K kernel, int threads, int smem, Residency (&memo)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return {1, kSms};
  Residency& r = memo[dev];
  if (r.per_sm > 0) return r;
  int per_sm = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      per_sm < 1 || sms < 1) {
    cudaGetLastError();  // the launch reports what fails
    per_sm = 1;
    sms = kSms;
  }
  r = {per_sm, sms};
  return r;
}

// Forward tiling for BO output channels per block: 256 threads, each
// 8 pixels (one tile row, 8 columns) x 8 outputs (4*j + [0, 4) and
// BO/2 + 4*j + [0, 4)). A warp holds BO/8 output groups x 256/BO tile rows
// at one 8-column half, so the tile is 1024/BO rows x 16 columns.
template <int BO>
struct Fwd32Tile {
  static constexpr int OG = BO / 8;           // output groups
  static constexpr int RPW = 32 / OG;         // tile rows a warp
  static constexpr int TH = 4 * RPW;          // tile rows
  static constexpr int TW = 16;               // tile columns
  static constexpr int HC = TW + 2;           // halo columns
  // halo row stride in floats: 20 mod 32, so the float4 loads of 8
  // consecutive rows fall on 8 distinct 4-bank groups
  static constexpr int RS = HC * F32_CC + 4;
  static constexpr int HALO = (TH + 2) * RS;  // floats
  static constexpr int WGT = 9 * F32_CC * BO;  // rows (tap, c) of BO
  static constexpr int STAGE = HALO + WGT;
  static constexpr int NST = 2;               // pipeline stages
  static constexpr int RED = 8 * 2 * BO;      // moment sums: warp x 2 x BO
  static constexpr int SMEM = (NST * STAGE + RED + BO) * 4;
};

// A persistent block: output channels BO*blockIdx.y + [0, BO), and the
// TH x 16 pixel tiles t = blockIdx.x + k*gridDim.x of the N*tiles_per_img
// tiles. A step is one tile's 8-channel slice: its (TH+2) x 18 x 8 halo
// (pixel-major, 8 channels a pixel) and the 9 x 8 x BO weight slice, in a
// 2-stage cp.async ring, so the next step's copies overlap this one's
// FMAs. With STATS it writes the sums of y and y*y over its valid pixels to
// partial[blockIdx.x, {0,1}, o].
template <int BO, bool STATS>
__global__ void __launch_bounds__(F32_THREADS, 1)
    conv3x3_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ y,
                       float* __restrict__ partial, int H, int W, int C, int O,
                       int tiles_x, int tiles_per_img, int tiles, int vec_x,
                       int vec_o) {
  using T = Fwd32Tile<BO>;
  extern __shared__ __align__(16) float fsm[];
  float* s_red = fsm + T::NST * T::STAGE;
  float* s_bias = s_red + T::RED;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane % T::OG;                           // output group
  const int row = (warp >> 1) * T::RPW + lane / T::OG;  // tile row
  const int col = (warp & 1) * 8;                       // first tile column
  const int o0 = blockIdx.y * BO;
  const int chunks = (C + F32_CC - 1) / F32_CC;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int steps = my_tiles * chunks;

  for (int i = tid; i < T::RED; i += F32_THREADS) s_red[i] = 0.f;
  for (int i = tid; i < BO; i += F32_THREADS)
    s_bias[i] = b != nullptr && o0 + i < O ? b[o0 + i] : 0.f;

  // step s: tile blockIdx.x + (s / chunks) * gridDim.x, channels
  // 8 * (s % chunks) + [0, 8): its halo and the weights w[tap][c][o0..o0+BO)
  // as rows (tap*8 + c) of BO outputs
  auto load = [&](int stage, int s) {
    const int t = blockIdx.x + (s / chunks) * gridDim.x;
    const int c0 = F32_CC * (s % chunks);
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    const int y0 = (rem / tiles_x) * T::TH, x0 = (rem % tiles_x) * T::TW;
    float* st = fsm + stage * T::STAGE;
    const float* xn = x + (size_t)n * H * W * C;
    for (int i = tid; i < (T::TH + 2) * T::HC * 2; i += F32_THREADS) {
      const int q = i >> 1, h = i & 1;
      const int hy = q / T::HC, hx = q % T::HC;
      const int gy = y0 + hy - 1, gx = x0 + hx - 1, c = c0 + 4 * h;
      const int valid =
          gy >= 0 && gy < H && gx >= 0 && gx < W ? clamp4(C - c) : 0;
      stage4f(st + hy * T::RS + hx * F32_CC + 4 * h,
              valid > 0 ? xn + ((size_t)gy * W + gx) * C + c : xn, valid,
              vec_x);
    }
    if (chunks == 1 && s >= T::NST) return;  // the stage holds them already
    float* sw = st + T::HALO;
    for (int i = tid; i < 9 * F32_CC * (BO / 4); i += F32_THREADS) {
      const int pc = i % (BO / 4), r = i / (BO / 4);
      const int c = c0 + r % F32_CC, o = o0 + 4 * pc;
      const int valid = c < C ? clamp4(O - o) : 0;
      stage4f(sw + r * BO + 4 * pc,
              valid > 0 ? w + ((size_t)(r / F32_CC) * C + c) * O + o : w,
              valid, vec_o);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int s = 0; s < T::NST - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // refill the stage that step s-1 read (the barrier below step s-1's
    // FMAs has passed), then wait for step s's own copies
    if (s + T::NST - 1 < steps)
      load((s + T::NST - 1) % T::NST, s + T::NST - 1);
    cp_async_commit();
    cp_async_wait<T::NST - 1>();
    __syncthreads();
    const float* st = fsm + (s % T::NST) * T::STAGE;
    const float* hb = st + row * T::RS + col * F32_CC;
    const float* wb = st + T::HALO + 4 * j;
    const int cn = C - F32_CC * (s % chunks);  // channels left (the stem: 1)
#pragma unroll 1
    for (int c4 = 0; c4 < F32_CC && c4 < cn; c4 += 4) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // halo row (row + ky), columns col .. col + 9, channels c4 .. c4+3
        float4 xv[10];
#pragma unroll
        for (int i = 0; i < 10; ++i)
          xv[i] = ld4(hb + ky * T::RS + i * F32_CC + c4);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const float* wr = wb + ((ky * 3 + kx) * F32_CC + c4 + ci) * BO;
            const float4 lo = ld4(wr), hi = ld4(wr + BO / 2);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              fma8(acc[i], part(xv[i + kx], ci), lo, hi);
          }
        }
      }
    }
    __syncthreads();
    if (s % chunks != chunks - 1) continue;

    // epilogue of the tile: bias in f32, one store a value; the moments of
    // the stored values, summed over the warp's rows by shuffles and added
    // to the warp's own shared sums in tile order
    const int t = blockIdx.x + (s / chunks) * gridDim.x;
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    const int oy = (rem / tiles_x) * T::TH + row;
    const int ox0 = (rem % tiles_x) * T::TW + col;
    float* yrow = y + ((size_t)n * H + oy) * W * O;
    float s1[8], s2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ol = hh * (BO / 2) + 4 * j, o = o0 + ol;
      const float4 bias = ld4(s_bias + ol);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = make_float4(
            acc[i][4 * hh] + bias.x, acc[i][4 * hh + 1] + bias.y,
            acc[i][4 * hh + 2] + bias.z, acc[i][4 * hh + 3] + bias.w);
        const bool in = oy < H && ox0 + i < W;
        if (in && o < O) {
          float* dst = yrow + (size_t)(ox0 + i) * O + o;
          if (vec_o) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            dst[0] = v.x;
            if (o + 1 < O) dst[1] = v.y;
            if (o + 2 < O) dst[2] = v.z;
            if (o + 3 < O) dst[3] = v.w;
          }
        }
        if (STATS && in) {  // outputs past O are 0 and never written out
          s1[4 * hh] += v.x;
          s1[4 * hh + 1] += v.y;
          s1[4 * hh + 2] += v.z;
          s1[4 * hh + 3] += v.w;
          s2[4 * hh] += v.x * v.x;
          s2[4 * hh + 1] += v.y * v.y;
          s2[4 * hh + 2] += v.z * v.z;
          s2[4 * hh + 3] += v.w * v.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    if (STATS) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = T::OG; off < 32; off <<= 1) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
        }
      if (lane < T::OG) {  // this lane alone owns these sums of its warp
        float* rp = s_red + warp * 2 * BO;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ol = (e >> 2) * (BO / 2) + 4 * j + (e & 3);
          rp[ol] += s1[e];
          rp[BO + ol] += s2[e];
        }
      }
    }
  }

  if (!STATS) return;
  __syncthreads();
  for (int i = tid; i < 2 * BO; i += F32_THREADS) {
    const int k = i / BO, ol = i % BO;
    if (o0 + ol < O) {
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < F32_THREADS / 32; ++wi)
        sum += s_red[(wi * 2 + k) * BO + ol];
      partial[((size_t)blockIdx.x * 2 + k) * O + o0 + ol] = sum;
    }
  }
}

// Weight-gradient tiling for BO output channels per block: 192 threads,
// each one tap row ky (its 3 taps kx), one quad of the block's 16 input
// channels and 8 outputs (as the forward's), over the tile rows of its row
// group (rows rg, rg + RG, ...): 3 x 4 x 8 accumulators.
template <int BO>
struct Wgrad32Tile {
  static constexpr int OG = BO / 8;           // output groups
  static constexpr int PER_RG = 3 * 4 * OG;   // threads of a row group
  static constexpr int THREADS = 192;
  static constexpr int RG = THREADS / PER_RG;  // 2, 4, 8 for BO 64, 32, 16
  static constexpr int TH = 8, TW = 16;        // pixel tile
  // halo row stride in floats: 16 mod 32, so that two halo rows' channel
  // quads fall on disjoint banks
  static constexpr int XRS = (TW + 2) * 16 + 16;
  static constexpr int HALO = (TH + 2) * XRS;
  static constexpr int GRS = TW * BO + 16;  // g tile-row stride, floats
  static constexpr int STAGE = HALO + TH * GRS;
  static constexpr int NST = BO == 64 ? 2 : 3;  // pipeline stages
  static constexpr int RED = 9 * 16 * BO;
  static constexpr int SMEM = (NST * STAGE > RED ? NST * STAGE : RED) * 4;
};

// One block: input channels 16*(blockIdx.x / o_tiles) + [0, 16), outputs
// BO*(blockIdx.x % o_tiles) + [0, BO), all 9 taps, pixel tiles
// [blockIdx.y * per_split, ...) of the N * tiles_per_img 8 x 16 tiles. A
// step is one tile's 10 x 18 x 16 halo and its 128 x BO slice of g, each
// read once in a cp.async ring; a thread walks a tile row keeping a
// 3-pixel window of the halo row in registers (one new float4 a pixel).
// Writes partial[blockIdx.y][tap][c][o] for its (c, o) range.
template <int BO>
__global__ void __launch_bounds__(Wgrad32Tile<BO>::THREADS, 1)
    conv3x3_wgrad_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         float* __restrict__ partial, int H, int W, int C,
                         int O, int o_tiles, int tiles_x, int tiles_per_img,
                         int tiles, int per_split, int vec_x, int vec_o) {
  using T = Wgrad32Tile<BO>;
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x;
  const int j = tid % T::OG, cq = (tid / T::OG) % 4;
  const int ky = (tid / (4 * T::OG)) % 3, rg = tid / T::PER_RG;
  const int c0 = (blockIdx.x / o_tiles) * 16;
  const int o0 = (blockIdx.x % o_tiles) * BO;
  const int t_begin = blockIdx.y * per_split;
  const int t_end = min(tiles, t_begin + per_split);

  // one stage: tile t's halo (channels c0..c0+15) and its 128 x BO slice
  // of g as tile rows of 16 pixels x BO outputs
  auto load = [&](int stage, int t) {
    float* s = fsm + stage * T::STAGE;
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    const int y0 = (rem / tiles_x) * T::TH, x0 = (rem % tiles_x) * T::TW;
    const float* xn = x + (size_t)n * H * W * C;
    for (int i = tid; i < (T::TH + 2) * (T::TW + 2) * 4; i += T::THREADS) {
      const int q = i >> 2, h = i & 3;
      const int hy = q / (T::TW + 2), hx = q % (T::TW + 2);
      const int gy = y0 + hy - 1, gx = x0 + hx - 1, c = c0 + 4 * h;
      const int valid =
          gy >= 0 && gy < H && gx >= 0 && gx < W ? clamp4(C - c) : 0;
      stage4f(s + hy * T::XRS + hx * 16 + 4 * h,
              valid > 0 ? xn + ((size_t)gy * W + gx) * C + c : xn, valid,
              vec_x);
    }
    const float* gn = g + (size_t)n * H * W * O;
    float* sg = s + T::HALO;
    for (int i = tid; i < T::TH * T::TW * (BO / 4); i += T::THREADS) {
      const int pc = i % (BO / 4), p = i / (BO / 4);
      const int py = p / T::TW, px = p % T::TW;
      const int gy = y0 + py, gx = x0 + px, o = o0 + 4 * pc;
      const int valid = gy < H && gx < W ? clamp4(O - o) : 0;
      stage4f(sg + py * T::GRS + px * BO + 4 * pc,
              valid > 0 ? gn + ((size_t)gy * W + gx) * O + o : gn, valid,
              vec_o);
    }
  };

  float acc[3][4][8];  // [kx][channel of the quad][output]
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[kx][ci][e] = 0.f;

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
    const float* st = fsm + (k % T::NST) * T::STAGE;
    const float* hb = st + ky * T::XRS + 4 * cq;
    const float* gb = st + T::HALO + 4 * j;
#pragma unroll 1
    for (int r = rg; r < T::TH; r += T::RG) {
      // halo row r + ky against g's tile row r: pixel px meets the halo
      // pixels px + kx, kx = 0..2
      const float* xr = hb + r * T::XRS;
      const float* gr = gb + r * T::GRS;
      float4 xa = ld4(xr), xb = ld4(xr + 16);
#pragma unroll
      for (int px = 0; px < T::TW; ++px) {
        const float4 xc = ld4(xr + (px + 2) * 16);
        const float4 lo = ld4(gr + px * BO), hi = ld4(gr + px * BO + BO / 2);
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
          fma8(acc[0][ci], part(xa, ci), lo, hi);
          fma8(acc[1][ci], part(xb, ci), lo, hi);
          fma8(acc[2][ci], part(xc, ci), lo, hi);
        }
        xa = xb;
        xb = xc;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // the groups still open hold no copy
  __syncthreads();

  // sum the row groups in shared memory, group 0 first
  float* red = fsm;  // [tap][16][BO]
  for (int s = 0; s < T::RG; ++s) {
    if (rg == s) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int o = (e >> 2) * (BO / 2) + 4 * j + (e & 3);
            float* p = red + ((ky * 3 + kx) * 16 + 4 * cq + ci) * BO + o;
            *p = s == 0 ? acc[kx][ci][e] : *p + acc[kx][ci][e];
          }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.y * 9 * C * O;
  for (int i = tid; i < T::RED; i += T::THREADS) {
    const int o = i % BO, c = (i / BO) % 16, tap = i / (16 * BO);
    if (c0 + c < C && o0 + o < O)
      out[((size_t)tap * C + c0 + c) * O + o0 + o] = red[i];
  }
}

// ---- f32 launchers ---------------------------------------------------------

// Output channels per f32 forward block: the least of 16/32/64/128 >= O.
int fwd32_bo(int O) { return O <= 16 ? 16 : O <= 32 ? 32 : O <= 64 ? 64 : 128; }

// The f32 forward's pixel tiles and its persistent grid: as many blocks as
// can be resident, shared among the output blocks, never more than there
// are tiles.
struct Fwd32Plan {
  int tiles_x, tiles_per_img, tiles, blocks;
};

template <int BO, bool STATS>
Fwd32Plan fwd32_plan(int N, int H, int W, int O) {
  using T = Fwd32Tile<BO>;
  static Residency memo[64] = {};
  const Residency r = residency(conv3x3_fwd_kernel<BO, STATS>, F32_THREADS,
                                T::SMEM, memo);
  Fwd32Plan p;
  p.tiles_x = (int)cdiv(W, T::TW);
  p.tiles_per_img = p.tiles_x * (int)cdiv(H, T::TH);
  p.tiles = N * p.tiles_per_img;
  const int per_o = (int)cdiv((long long)r.per_sm * r.sms, cdiv(O, BO));
  p.blocks = p.tiles < per_o ? p.tiles : per_o;
  return p;
}

template <int BO, bool STATS>
int launch_fwd32_bo(const void* x, const void* w, const void* b, void* y,
                    void* partial, int N, int H, int W, int C, int O,
                    void* stream) {
  const Fwd32Plan p = fwd32_plan<BO, STATS>(N, H, W, O);
  const dim3 grid(p.blocks, (int)cdiv(O, BO));
  conv3x3_fwd_kernel<BO, STATS><<<grid, F32_THREADS, Fwd32Tile<BO>::SMEM,
                                  (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<float*>(partial), H, W, C, O, p.tiles_x, p.tiles_per_img,
      p.tiles, vec16f(x, C), vec16f(w, O) && vec16f(y, O));
  return (int)cudaGetLastError();
}

template <bool STATS>
int launch_fwd32(const void* x, const void* w, const void* b, void* y,
                 void* partial, int N, int H, int W, int C, int O,
                 void* stream) {
  switch (fwd32_bo(O)) {
    case 16:
      return launch_fwd32_bo<16, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                        stream);
    case 32:
      return launch_fwd32_bo<32, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                        stream);
    case 64:
      return launch_fwd32_bo<64, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                        stream);
    default:
      return launch_fwd32_bo<128, STATS>(x, w, b, y, partial, N, H, W, C, O,
                                         stream);
  }
}

// Rows of the f32 moments' partials: the stats forward's blocks.
int fwd32_stats_rows(int N, int H, int W, int O) {
  switch (fwd32_bo(O)) {
    case 16:
      return fwd32_plan<16, true>(N, H, W, O).blocks;
    case 32:
      return fwd32_plan<32, true>(N, H, W, O).blocks;
    case 64:
      return fwd32_plan<64, true>(N, H, W, O).blocks;
    default:
      return fwd32_plan<128, true>(N, H, W, O).blocks;
  }
}

int wgrad32_bo(int O) { return O <= 16 ? 16 : O <= 32 ? 32 : 64; }

// How the f32 weight gradient splits the N * tiles_per_img pixel tiles:
// one wave of resident blocks where there are tiles for it, but no more
// partial bytes (splits * 9*C*O) than the bytes of x and g.
struct Wgrad32Plan {
  int tiles_x, tiles_per_img, tiles, per_split, splits;
};

template <int BO>
Wgrad32Plan wgrad32_plan_bo(int N, int H, int W, int C, int O) {
  using T = Wgrad32Tile<BO>;
  static Residency memo[64] = {};
  const Residency r = residency(conv3x3_wgrad_kernel<BO>, T::THREADS,
                                T::SMEM, memo);
  Wgrad32Plan p;
  p.tiles_x = (int)cdiv(W, T::TW);
  p.tiles_per_img = p.tiles_x * (int)cdiv(H, T::TH);
  p.tiles = N * p.tiles_per_img;
  const long long base = cdiv(C, 16) * cdiv(O, BO);
  long long splits = (long long)r.per_sm * r.sms / base;
  const long long most = (long long)N * H * W * (C + O) / (9LL * C * O);
  if (splits > most) splits = most;
  if (splits > p.tiles) splits = p.tiles;
  if (splits < 1) splits = 1;
  p.per_split = (int)cdiv(p.tiles, splits);
  p.splits = (int)cdiv(p.tiles, p.per_split);
  return p;
}

Wgrad32Plan wgrad32_plan(int N, int H, int W, int C, int O) {
  switch (wgrad32_bo(O)) {
    case 16:
      return wgrad32_plan_bo<16>(N, H, W, C, O);
    case 32:
      return wgrad32_plan_bo<32>(N, H, W, C, O);
    default:
      return wgrad32_plan_bo<64>(N, H, W, C, O);
  }
}

template <int BO>
int launch_wgrad32_bo(const void* x, const void* g, void* partial, int N,
                      int H, int W, int C, int O, void* stream) {
  using T = Wgrad32Tile<BO>;
  const Wgrad32Plan p = wgrad32_plan_bo<BO>(N, H, W, C, O);
  const int o_tiles = (int)cdiv(O, BO);
  const dim3 grid((int)cdiv(C, 16) * o_tiles, p.splits);
  conv3x3_wgrad_kernel<BO><<<grid, T::THREADS, T::SMEM,
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(partial), H, W, C, O, o_tiles, p.tiles_x,
      p.tiles_per_img, p.tiles, p.per_split, vec16f(x, C), vec16f(g, O));
  return (int)cudaGetLastError();
}

int launch_wgrad32(const void* x, const void* g, void* partial, int N, int H,
                   int W, int C, int O, void* stream) {
  switch (wgrad32_bo(O)) {
    case 16:
      return launch_wgrad32_bo<16>(x, g, partial, N, H, W, C, O, stream);
    case 32:
      return launch_wgrad32_bo<32>(x, g, partial, N, H, W, C, O, stream);
    default:
      return launch_wgrad32_bo<64>(x, g, partial, N, H, W, C, O, stream);
  }
}

// ---- bf16 tensor-core kernels ----------------------------------------------

using bf16 = __nv_bfloat16;

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

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core
// kernels);
// x, w, b and y all of that type. b may be null (no bias).
int conv3x3_fwd(const void* x, const void* w, const void* b, void* y, int N,
                int H, int W, int C, int O, int dtype, void* stream) {
  if (dtype == 1)
    return launch_fwd_bf16<false>(x, w, b, y, nullptr, N, H, W, C, O, stream);
  return launch_fwd32<false>(x, w, b, y, nullptr, N, H, W, C, O, stream);
}

// Rows of the (rows, 2, O) f32 partials tensor conv3x3_fwd_stats writes:
// one per persistent block.
int conv3x3_stats_rows(int N, int H, int W, int O, int dtype) {
  if (dtype == 1) return fwd_plan(N, H, W, O).blocks;
  return fwd32_stats_rows(N, H, W, O);
}

int conv3x3_fwd_stats(const void* x, const void* w, const void* b, void* y,
                      void* partial, int N, int H, int W, int C, int O,
                      int dtype, void* stream) {
  if (dtype == 1)
    return launch_fwd_bf16<true>(x, w, b, y, partial, N, H, W, C, O, stream);
  return launch_fwd32<true>(x, w, b, y, partial, N, H, W, C, O, stream);
}

// Number of pixel-range splits S of the (S, 3, 3, C, O) f32 partials
// tensor conv3x3_wgrad writes.
int conv3x3_wgrad_splits(int N, int H, int W, int C, int O, int dtype) {
  if (dtype == 1) return wgrad_plan(N, H, W, C, O).splits;
  return wgrad32_plan(N, H, W, C, O).splits;
}

int conv3x3_wgrad(const void* x, const void* g, void* partial, int N, int H,
                  int W, int C, int O, int dtype, void* stream) {
  if (dtype == 1)
    return launch_wgrad_bf16(x, g, partial, N, H, W, C, O, stream);
  return launch_wgrad32(x, g, partial, N, H, W, C, O, stream);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
