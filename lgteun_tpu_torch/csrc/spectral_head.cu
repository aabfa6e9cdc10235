// LGB mixer head and global mixer for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/spectral_kernel.py::fused_ln_mixer_head_cm
//           (Pallas `_head_kernel` + `mixer_body`): channel LayerNorm,
//           split, and the FFT amplitude/phase mixer on the second half;
//           lgteun_tpu/ops/spectral_kernel.py::fused_global_mixer_cm
//           (Pallas `_kernel`): the mixer alone, without the LN.
//
// What bounds it here: not HBM. One 128x128 f32 plane is 64 KB in and
// 64 KB out (about 40 ns of the card's 3.35 TB/s), while its 2-D FFT pair
// is 28 radix-2 stages of 4-8 K butterflies through shared memory, each
// stage behind a __syncthreads, plus an atan2f/sincosf per half-spectrum
// bin. The plane needs 128 KB of shared memory as complex f32, so one
// block runs per SM: latency of shared memory and barriers bounds it.
//
// Design (the TPU kernel's DFT-as-matmul, polynomial atan2 and sin/cos are
// not carried over; the FFT itself is in fft_mixer.cuh):
//  1. ln_split_kernel (head only): one thread per pixel; reads the C
//     channels (coalesced across pixels), writes y1 and the normalised
//     second half into x2, which step 2 transforms in place.
//  2. fft_mixer_kernel: one block per (image, channel) plane held whole in
//     shared memory, read from `in` and written to `out` (the head passes
//     x2 as both). Any H, W of the form 2^a * odd with a >= 1 whose plane
//     fits in shared memory (fft_mixer_smem <= 232,448 bytes), so up to
//     168 x 168.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_mixer.cuh"

namespace {

constexpr int kThreadsLN = 256;
constexpr int kThreadsFFT = 512;

__global__ void __launch_bounds__(kThreadsLN)
ln_split_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, float* __restrict__ y1,
                float* __restrict__ y2, int C, int HW, float eps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  ln_split_pixel(x, ln_w, ln_b, y1, y2, C, HW, blockIdx.y, p, eps);
}

// `in` and `out` may alias (no __restrict__): every plane is read whole
// into shared memory before any of it is written.
__global__ void __launch_bounds__(kThreadsFFT)
fft_mixer_kernel(const float* in, float* out, const float* __restrict__ amp_w,
                 const float* __restrict__ amp_b,
                 const float* __restrict__ pha_w,
                 const float* __restrict__ pha_b, int C, int H, int W,
                 FftLen fh, FftLen fw) {
  extern __shared__ float2 smem[];
  const int plane = blockIdx.x;   // b * C + c
  const int c = plane % C;
  const size_t off = (size_t)plane * H * W;
  fft_mixer_plane(in + off, out + off, smem, H, W, fh, fw, amp_w[c],
                  amp_b[c], pha_w[c], pha_b[c]);
}

// Launch fft_mixer_kernel on B * C planes; checks the lengths it takes.
int launch_fft_mixer(const float* in, float* out, const float* amp_w,
                     const float* amp_b, const float* pha_w,
                     const float* pha_b, int B, int C, int H, int W,
                     cudaStream_t stream) {
  const FftLen fh = fft_len(H), fw = fft_len(W);
  if (fh.p < 2 || fw.p < 2 || fh.m > kThreadsFFT || fw.m > kThreadsFFT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fft_mixer_smem(H, W);
  const cudaError_t err = cudaFuncSetAttribute(
      fft_mixer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fft_mixer_kernel<<<B * C, kThreadsFFT, smem, stream>>>(
      in, out, amp_w, amp_b, pha_w, pha_b, C, H, W, fh, fw);
  return (int)cudaGetLastError();
}

}  // namespace

// y1, x2 = LN(x)[:, :C/2], global_mixer(LN(x)[:, C/2:]) on [B, C, H, W].
// H and W even, the plane within shared memory (checked by the wrapper).
extern "C" int lgteun_ln_mixer_head(const float* x, const float* ln_w,
                                    const float* ln_b, const float* amp_w,
                                    const float* amp_b, const float* pha_w,
                                    const float* pha_b, float* y1, float* x2,
                                    int B, int C, int H, int W, float eps,
                                    cudaStream_t stream) {
  const int HW = H * W;
  const dim3 grid_ln((HW + kThreadsLN - 1) / kThreadsLN, B);
  ln_split_kernel<<<grid_ln, kThreadsLN, 0, stream>>>(x, ln_w, ln_b, y1, x2,
                                                      C, HW, eps);
  return launch_fft_mixer(x2, x2, amp_w, amp_b, pha_w, pha_b, B, C / 2, H, W,
                          stream);
}

// out = global_mixer(x) on [B, C, H, W]; per-channel affine [C] each.
extern "C" int lgteun_global_mixer(const float* x, const float* amp_w,
                                   const float* amp_b, const float* pha_w,
                                   const float* pha_b, float* out, int B,
                                   int C, int H, int W, cudaStream_t stream) {
  return launch_fft_mixer(x, out, amp_w, amp_b, pha_w, pha_b, B, C, H, W,
                          stream);
}
