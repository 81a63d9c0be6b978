// Per-sample geometric augmentation of a batch of square slices, for Hopper
// (sm_90a). Replaces _aug_kernel (wsl4mis_tpu/ops/pallas/augment_pallas.py:137).
//
// Per sample b, policy[b] = (branch, k, axis, angle):
//   branch 0: np.rot90(., k) then a flip along `axis`;
//   branch 1: nearest-neighbour rotation by `angle` degrees about
//             ((H-1)/2, (W-1)/2); pixels whose source lies outside the plane
//             take 0 (image) or the label fill (4 when the sample's label
//             holds the ignore class 4, else 0);
//   branch 2: identity.
//
// The TPU kernel builds the rotation as a Paeth 3-shear because a TPU has no
// cheap gather; that agrees with scipy on only ~97% of pixels. On the H100 a
// gather is the natural operation, so branch 1 is the exact inverse map of
// wsl4mis_tpu/data/augment_device._rotate_nearest: source = R * (dst - ctr)
// + ctr, the inside test taken before rounding, then floor(s + 0.5). The
// coordinate arithmetic uses __fmul_rn/__fadd_rn (and the file is built
// with -fmad=false) so that it rounds exactly as the plain PyTorch version's
// separate multiply and add do. cos and sin are taken here, with cosf and
// sinf (not the fast intrinsics) of the f32 product angle * f32(pi / 180),
// the plain version's torch.cos / torch.sin of the same product.
//
// What bounds it on the H100: memory. It reads and writes 4 + 4 bytes per
// pixel for the image and the label and does a few integer and float ops per
// pixel, far below the card's flop/byte line. So the design is about the
// bytes and the launches:
// - One C entry point, no work on the host: the per-sample label fill is
//   found by a flag kernel (augment_fill_kernel) that reads only the labels
//   of rotated samples, 16 KB per block with 16-byte loads, and writes one
//   "holds a 4" word per block; the main kernel ORs a sample's words.
// - The main kernel (augment_kernel) takes one 32x32 output tile of one
//   sample per block. The source of a tile under any of the maps is a box:
//   the map is monotone in each output coordinate, in f32 rounding too, so
//   the box is spanned by the sources of the tile's four corners (the same
//   tile for the identity and flips, the transposed tile for rot90 by 1 or
//   3, at most 47x47 pixels for a rotation). The block stages that box of
//   image and label in shared memory with coalesced 16-byte loads, then
//   every thread maps its 4 adjacent output pixels and writes them with one
//   16-byte store per plane. The staged rows have an odd pitch, so the
//   transposed reads of rot90 by 1 or 3 hit 32 distinct banks. The identity
//   copies 16 bytes at a time without staging.
// - Planes whose width is no multiple of 4 (or unaligned pointers) take the
//   same code with 4-byte loads and stores.
//
// Scribble2Label's variant (augment_s2l_kernel, entry augment_s2l) applies
// the same policy to a third map, the per-pixel EMA weight rows (B,H,W,4)
// f32, one 16-byte float4 a pixel, and fills every map with 0: the scribble
// takes no ignore-class fill (dataset_s2l.py:118-123), so no flag kernel
// runs. Its JAX counterpart is XLA, not Pallas
// (wsl4mis_tpu/data/augment_device.augment_batch_s2l). It reads and writes
// 4 + 4 + 16 bytes a pixel; the weight rows of a tile's source box are
// staged beside the image and label (48 x 53 float4, 40,704 bytes of
// dynamic shared memory) and mapped by a pass of their own (carry_weights)
// in which each thread takes one pixel, so that a warp stores 32 adjacent
// float4. Both kernels share one tile body (augment_tile).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int T = 32;              // output tile edge
constexpr int NT = 256;            // threads: 32 rows x 8 groups of 4 pixels
constexpr int BOX = 48;            // staged rows (a 32-tile's source box <= 47)
constexpr int PITCH = BOX + 4 + 1; // staged row pitch in words: odd
constexpr int FLAG_CHUNK = 4096;   // label words per flag block
constexpr int FLAG_THREADS = 256;
// f32(pi / 180), as the plain version's multiply by the Python float rounds it
constexpr float DEG = (float)0.017453292519943295;

struct Map {
  int branch, k, axis;
  float c, s;
};

// Source pixel (si, sj) of output pixel (i, j), and whether it lies inside
// the plane (only a rotation can leave it).
__device__ __forceinline__ void source(const Map& m, int i, int j, int H,
                                       int W, int& si, int& sj,
                                       bool& inside) {
  si = i;
  sj = j;
  inside = true;
  if (m.branch == 0) {
    // out[i, j] = rot90(x, k)[fi, fj] with (fi, fj) the flipped index
    const int fi = m.axis == 0 ? H - 1 - i : i;
    const int fj = m.axis == 0 ? j : W - 1 - j;
    if (m.k == 0) {
      si = fi;
      sj = fj;
    } else if (m.k == 1) {
      si = fj;
      sj = W - 1 - fi;
    } else if (m.k == 2) {
      si = H - 1 - fi;
      sj = W - 1 - fj;
    } else {
      si = H - 1 - fj;
      sj = fi;
    }
  } else if (m.branch == 1) {
    const float cy = 0.5f * (float)(H - 1);
    const float cx = 0.5f * (float)(W - 1);
    const float yy = __fsub_rn((float)i, cy);
    const float xx = __fsub_rn((float)j, cx);
    const float sy =
        __fadd_rn(__fadd_rn(__fmul_rn(m.c, yy), __fmul_rn(m.s, xx)), cy);
    const float sx =
        __fadd_rn(__fadd_rn(__fmul_rn(-m.s, yy), __fmul_rn(m.c, xx)), cx);
    inside = sy >= 0.f && sy <= (float)(H - 1) && sx >= 0.f &&
             sx <= (float)(W - 1);
    si = min(max((int)floorf(__fadd_rn(sy, 0.5f)), 0), H - 1);
    sj = min(max((int)floorf(__fadd_rn(sx, 0.5f)), 0), W - 1);
  }
}

// flags[b * nflag + s] = whether words [s * FLAG_CHUNK, (s+1) * FLAG_CHUNK)
// of sample b's label hold a 4; written for rotated samples only.
template <bool VEC>
__global__ void __launch_bounds__(FLAG_THREADS)
    augment_fill_kernel(const int* __restrict__ lab,
                        const int* __restrict__ policy,
                        int* __restrict__ flags, int plane, int nflag) {
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  if (__ldg(policy + 4 * b) != 1) return;
  const int* lb = lab + (size_t)b * plane;
  const int start = s * FLAG_CHUNK;
  const int end = min(start + FLAG_CHUNK, plane);
  bool found = false;
  if (VEC) {
    const int4* l4 = reinterpret_cast<const int4*>(lb);
#pragma unroll 4
    for (int q = start / 4 + threadIdx.x; q < end / 4; q += FLAG_THREADS) {
      const int4 v = __ldg(l4 + q);
      found |= v.x == 4 || v.y == 4 || v.z == 4 || v.w == 4;
    }
  } else {
#pragma unroll 4
    for (int q = start + threadIdx.x; q < end; q += FLAG_THREADS)
      found |= __ldg(lb + q) == 4;
  }
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) flags[(size_t)b * nflag + s] = found;
}

// S2L: the weight rows of one 32x32 output tile, one pixel a thread per
// pass, a warp on 32 adjacent output columns of a row: its float4 stores are
// one contiguous 512 bytes, and its staged reads walk a source row (flips,
// rotations) or, for rot90 by 1 or 3, a source column at the odd pitch, so
// the 8 lanes of each quarter-warp hit 8 distinct 4-bank groups. r0 < 0:
// read the source from global memory.
__device__ __forceinline__ void carry_weights(
    const Map& m, const float4* __restrict__ wb, float4* __restrict__ wo,
    const float4* s_wgt, int r0, int c0, int i0, int j0, int H, int W) {
  for (int p = threadIdx.x; p < T * T; p += NT) {
    const int i = i0 + p / T;
    const int j = j0 + p % T;
    if (i >= H || j >= W) continue;
    int si, sj;
    bool inside;
    source(m, i, j, H, W, si, sj, inside);
    const float4 z = r0 >= 0 ? s_wgt[(si - r0) * PITCH + sj - c0]
                             : __ldg(wb + (size_t)si * W + sj);
    wo[(size_t)i * W + j] = inside ? z : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One 32x32 output tile of one sample. S2L: the label fill is 0 (flags is
// not read) and the weight rows wgt -> wgt_out are carried, staged in s_wgt
// (BOX * PITCH float4 of dynamic shared memory).
template <bool VEC, bool S2L>
__device__ __forceinline__ void augment_tile(
    const float* __restrict__ img, const int* __restrict__ lab,
    const float4* __restrict__ wgt, const int* __restrict__ policy,
    const int* __restrict__ flags, float* __restrict__ img_out,
    int* __restrict__ lab_out, float4* __restrict__ wgt_out, int H, int W,
    int nflag, float4* s_wgt) {
  __shared__ float s_img[BOX * PITCH];
  __shared__ int s_lab[BOX * PITCH];
  __shared__ Map s_map;
  // first staged row (-1: read the source from global), first staged
  // column, staged rows, staged columns, label fill
  __shared__ int s_box[5];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * T;
  const int j0 = blockIdx.x * T;
  const int i1 = min(i0 + T, H) - 1;  // last row and column of the tile
  const int j1 = min(j0 + T, W) - 1;
  const size_t plane = (size_t)H * W;
  const float* ib = img + (size_t)b * plane;
  const int* lb = lab + (size_t)b * plane;
  float* io = img_out + (size_t)b * plane;
  int* lo = lab_out + (size_t)b * plane;
  const float4* wb = S2L ? wgt + (size_t)b * plane : nullptr;
  float4* wo = S2L ? wgt_out + (size_t)b * plane : nullptr;

  // warp 0: the policy row, cos / sin, the label fill, the source box
  if (tid < 32) {
    const int4 pol = __ldg(reinterpret_cast<const int4*>(policy) + b);
    Map m{pol.x, pol.y & 3, pol.z, 1.f, 0.f};
    int fill = 0;
    if (m.branch == 1) {
      const float theta = __fmul_rn((float)pol.w, DEG);
      m.c = cosf(theta);
      m.s = sinf(theta);
      if (!S2L) {
        bool any = false;
        for (int q = tid; q < nflag; q += 32)
          any |= __ldg(flags + (size_t)b * nflag + q) != 0;
        fill = __any_sync(0xffffffffu, any) ? 4 : 0;
      }
    }
    // lanes 0-3: the sources of the tile's corners
    int si = 0, sj = 0;
    bool inside;
    source(m, (tid & 1) ? i1 : i0, (tid & 2) ? j1 : j0, H, W, si, sj,
           inside);
    int lo_i = (tid < 4) ? si : INT_MAX, hi_i = (tid < 4) ? si : INT_MIN;
    int lo_j = (tid < 4) ? sj : INT_MAX, hi_j = (tid < 4) ? sj : INT_MIN;
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      lo_i = min(lo_i, __shfl_xor_sync(0xffffffffu, lo_i, o));
      hi_i = max(hi_i, __shfl_xor_sync(0xffffffffu, hi_i, o));
      lo_j = min(lo_j, __shfl_xor_sync(0xffffffffu, lo_j, o));
      hi_j = max(hi_j, __shfl_xor_sync(0xffffffffu, hi_j, o));
    }
    if (tid == 0) {
      s_map = m;
      // 16-byte aligned column range on the vector route
      const int c0 = VEC ? (lo_j & ~3) : lo_j;
      const int c1 = VEC ? ((hi_j + 4) & ~3) : hi_j + 1;
      const bool fits = hi_i - lo_i + 1 <= BOX && c1 - c0 <= PITCH - 1;
      s_box[0] = fits ? lo_i : -1;
      s_box[1] = c0;
      s_box[2] = hi_i - lo_i + 1;
      s_box[3] = c1 - c0;
      s_box[4] = fill;
    }
  }
  __syncthreads();
  const Map m = s_map;
  const int r0 = s_box[0];
  const int c0 = s_box[1];
  const int nr = s_box[2];
  const int nc = s_box[3];
  const int fill = s_box[4];

  const int ty = tid >> 3;       // output row in the tile
  const int tx = (tid & 7) * 4;  // first of 4 output columns
  const int i = i0 + ty;
  const int j = j0 + tx;
  const bool full = VEC && j + 3 < W;

  if (m.branch == 2) {  // identity: copy, no staging
    if (S2L) carry_weights(m, wb, wo, s_wgt, -1, 0, i0, j0, H, W);
    if (i >= H) return;
    const size_t at = (size_t)i * W + j;
    if (full) {
      *reinterpret_cast<float4*>(io + at) =
          __ldg(reinterpret_cast<const float4*>(ib + at));
      *reinterpret_cast<int4*>(lo + at) =
          __ldg(reinterpret_cast<const int4*>(lb + at));
    } else {
      for (int e = 0; e < 4 && j + e < W; ++e) {
        io[at + e] = __ldg(ib + at + e);
        lo[at + e] = __ldg(lb + at + e);
      }
    }
    return;
  }

  if (r0 >= 0) {  // stage the source box
    if (VEC) {
      const int nq = nc / 4;
      for (int q = tid; q < nr * nq; q += NT) {
        const int r = q / nq;
        const int c = (q - r * nq) * 4;
        const size_t at = (size_t)(r0 + r) * W + c0 + c;
        const float4 v = __ldg(reinterpret_cast<const float4*>(ib + at));
        const int4 u = __ldg(reinterpret_cast<const int4*>(lb + at));
        float* si = s_img + r * PITCH + c;
        int* sl = s_lab + r * PITCH + c;
        si[0] = v.x;
        si[1] = v.y;
        si[2] = v.z;
        si[3] = v.w;
        sl[0] = u.x;
        sl[1] = u.y;
        sl[2] = u.z;
        sl[3] = u.w;
      }
    } else {
      for (int q = tid; q < nr * nc; q += NT) {
        const int r = q / nc;
        const int c = q - r * nc;
        const size_t at = (size_t)(r0 + r) * W + c0 + c;
        s_img[r * PITCH + c] = __ldg(ib + at);
        s_lab[r * PITCH + c] = __ldg(lb + at);
      }
    }
    if (S2L) {
      for (int q = tid; q < nr * nc; q += NT) {
        const int r = q / nc;
        const int c = q - r * nc;
        s_wgt[r * PITCH + c] = __ldg(wb + (size_t)(r0 + r) * W + c0 + c);
      }
    }
    __syncthreads();
  }
  if (S2L) carry_weights(m, wb, wo, s_wgt, r0, c0, i0, j0, H, W);
  if (i >= H) return;

  float v[4];
  int u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int si, sj;
    bool inside;
    source(m, i, min(j + e, W - 1), H, W, si, sj, inside);
    float x;
    int y;
    if (r0 >= 0) {
      const int at = (si - r0) * PITCH + sj - c0;
      x = s_img[at];
      y = s_lab[at];
    } else {
      const size_t at = (size_t)si * W + sj;
      x = __ldg(ib + at);
      y = __ldg(lb + at);
    }
    v[e] = inside ? x : 0.f;
    u[e] = inside ? y : fill;
  }
  const size_t at = (size_t)i * W + j;
  if (full) {
    *reinterpret_cast<float4*>(io + at) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(lo + at) = make_int4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j + e < W) {
        io[at + e] = v[e];
        lo[at + e] = u[e];
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
    augment_kernel(const float* __restrict__ img,
                   const int* __restrict__ lab,
                   const int* __restrict__ policy,
                   const int* __restrict__ flags,
                   float* __restrict__ img_out, int* __restrict__ lab_out,
                   int H, int W, int nflag) {
  augment_tile<VEC, false>(img, lab, nullptr, policy, flags, img_out,
                           lab_out, nullptr, H, W, nflag, nullptr);
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
    augment_s2l_kernel(const float* __restrict__ img,
                       const int* __restrict__ lab,
                       const float4* __restrict__ wgt,
                       const int* __restrict__ policy,
                       float* __restrict__ img_out,
                       int* __restrict__ lab_out,
                       float4* __restrict__ wgt_out, int H, int W) {
  extern __shared__ float4 s_wgt[];
  augment_tile<VEC, true>(img, lab, wgt, policy, nullptr, img_out, lab_out,
                          wgt_out, H, W, 0, s_wgt);
}

template <bool VEC>
int launch(const void* img, const void* lab, const void* policy, void* flags,
           void* img_out, void* lab_out, int B, int H, int W,
           cudaStream_t stream) {
  const int plane = H * W;
  const int nflag = (plane + FLAG_CHUNK - 1) / FLAG_CHUNK;
  augment_fill_kernel<VEC><<<dim3(nflag, B), FLAG_THREADS, 0, stream>>>(
      static_cast<const int*>(lab), static_cast<const int*>(policy),
      static_cast<int*>(flags), plane, nflag);
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  augment_kernel<VEC><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(img), static_cast<const int*>(lab),
      static_cast<const int*>(policy), static_cast<const int*>(flags),
      static_cast<float*>(img_out), static_cast<int*>(lab_out), H, W, nflag);
  return (int)cudaGetLastError();
}

constexpr int S2L_SMEM = BOX * PITCH * (int)sizeof(float4);  // 40,704 B

template <bool VEC>
int launch_s2l(const void* img, const void* lab, const void* wgt,
               const void* policy, void* img_out, void* lab_out,
               void* wgt_out, int B, int H, int W, cudaStream_t stream) {
  // above 48 KB of shared memory with the static image and label boxes:
  // opt in (per device, so on every call; it does not synchronize)
  cudaError_t err = cudaFuncSetAttribute(
      augment_s2l_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S2L_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  augment_s2l_kernel<VEC><<<grid, NT, S2L_SMEM, stream>>>(
      static_cast<const float*>(img), static_cast<const int*>(lab),
      static_cast<const float4*>(wgt), static_cast<const int*>(policy),
      static_cast<float*>(img_out), static_cast<int*>(lab_out),
      static_cast<float4*>(wgt_out), H, W);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// img (B,H,W) f32, lab (B,H,W) int32, policy (B,4) int32 (16-byte
// aligned); flags: int32 scratch of B * ceil(H * W / 4096) words; outputs of
// the input shapes. Requires H == W (rot90 of a square plane).
int augment(const void* img, const void* lab, const void* policy, void* flags,
            void* img_out, void* lab_out, int B, int H, int W, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H != W || (long long)H * W > INT_MAX ||
      !aligned16(policy))
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(img) && aligned16(lab) &&
                   aligned16(img_out) && aligned16(lab_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(img, lab, policy, flags, img_out, lab_out, B, H,
                            W, s)
             : launch<false>(img, lab, policy, flags, img_out, lab_out, B, H,
                             W, s);
}

// Scribble2Label: img (B,H,W) f32, lab (B,H,W) int32 (the scribble, filled
// with 0), wgt (B,H,W,4) f32 (16-byte aligned), policy (B,4) int32 (16-byte
// aligned); outputs of the input shapes. Requires H == W.
int augment_s2l(const void* img, const void* lab, const void* wgt,
                const void* policy, void* img_out, void* lab_out,
                void* wgt_out, int B, int H, int W, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H != W || (long long)H * W > INT_MAX ||
      !aligned16(policy) || !aligned16(wgt) || !aligned16(wgt_out))
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(img) && aligned16(lab) &&
                   aligned16(img_out) && aligned16(lab_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_s2l<true>(img, lab, wgt, policy, img_out, lab_out,
                                wgt_out, B, H, W, s)
             : launch_s2l<false>(img, lab, wgt, policy, img_out, lab_out,
                                 wgt_out, B, H, W, s);
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
