// Per-sample geometric augmentation of a batch of square slices, for Hopper
// (sm_90a). Replaces _aug_kernel (wsl4mis_tpu/ops/pallas/augment_pallas.py:137).
//
// Per sample b, policy[b] = (branch, k, axis, angle):
//   branch 0: np.rot90(., k) then a flip along `axis`;
//   branch 1: nearest-neighbour rotation by `angle` degrees about
//             ((H-1)/2, (W-1)/2); pixels whose source lies outside the plane
//             take 0 (image) or label_fill[b] (label: 4 when the label
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
// separate multiply and add do; cos and sin come in from the caller.
//
// What bounds it on the H100: memory. It reads and writes 4 + 4 bytes per
// pixel for the image and the label and does a few integer and float ops per
// pixel, far below the card's flop/byte line. One thread per output pixel,
// consecutive threads on consecutive output pixels, so the stores coalesce;
// the rotated reads are gathers that stay within a few rows of the output
// row, which the L2 and L1 caches serve.

#include <cuda_runtime.h>

namespace {

__global__ void augment_kernel(const float* __restrict__ img,
                               const int* __restrict__ lab,
                               const int* __restrict__ policy,
                               const float* __restrict__ cos_sin,
                               const int* __restrict__ label_fill,
                               float* __restrict__ img_out,
                               int* __restrict__ lab_out, int B, int H,
                               int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)H * W;
  if (idx >= (long long)B * plane) return;
  const int b = (int)(idx / plane);
  const int rem = (int)(idx - (long long)b * plane);
  const int i = rem / W;
  const int j = rem % W;

  const int branch = policy[4 * b + 0];
  int si = i;
  int sj = j;
  bool inside = true;
  if (branch == 0) {
    // out[i, j] = rot90(x, k)[fi, fj] with (fi, fj) the flipped index
    const int k = policy[4 * b + 1] & 3;
    const int axis = policy[4 * b + 2];
    const int fi = axis == 0 ? H - 1 - i : i;
    const int fj = axis == 0 ? j : W - 1 - j;
    if (k == 0) {
      si = fi;
      sj = fj;
    } else if (k == 1) {
      si = fj;
      sj = W - 1 - fi;
    } else if (k == 2) {
      si = H - 1 - fi;
      sj = W - 1 - fj;
    } else {
      si = H - 1 - fj;
      sj = fi;
    }
  } else if (branch == 1) {
    const float c = cos_sin[2 * b + 0];
    const float s = cos_sin[2 * b + 1];
    const float cy = 0.5f * (float)(H - 1);
    const float cx = 0.5f * (float)(W - 1);
    const float yy = __fsub_rn((float)i, cy);
    const float xx = __fsub_rn((float)j, cx);
    const float sy =
        __fadd_rn(__fadd_rn(__fmul_rn(c, yy), __fmul_rn(s, xx)), cy);
    const float sx =
        __fadd_rn(__fadd_rn(__fmul_rn(-s, yy), __fmul_rn(c, xx)), cx);
    inside = sy >= 0.f && sy <= (float)(H - 1) && sx >= 0.f &&
             sx <= (float)(W - 1);
    si = min(max((int)floorf(__fadd_rn(sy, 0.5f)), 0), H - 1);
    sj = min(max((int)floorf(__fadd_rn(sx, 0.5f)), 0), W - 1);
  }
  const long long src = (long long)b * plane + (long long)si * W + sj;
  img_out[idx] = inside ? img[src] : 0.f;
  lab_out[idx] = inside ? lab[src] : label_fill[b];
}

}  // namespace

extern "C" {

// img (B,H,W) f32, lab (B,H,W) int32, policy (B,4) int32, cos_sin (B,2) f32,
// label_fill (B,) int32; outputs of the input shapes. Requires H == W for
// branch 0 (rot90 of a square plane).
int augment(const void* img, const void* lab, const void* policy,
            const void* cos_sin, const void* label_fill, void* img_out,
            void* lab_out, int B, int H, int W, void* stream) {
  const long long total = (long long)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  augment_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(img), static_cast<const int*>(lab),
      static_cast<const int*>(policy), static_cast<const float*>(cos_sin),
      static_cast<const int*>(label_fill), static_cast<float*>(img_out),
      static_cast<int*>(lab_out), B, H, W);
  return (int)cudaGetLastError();
}

const char* wsl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
