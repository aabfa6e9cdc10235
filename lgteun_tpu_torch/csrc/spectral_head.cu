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
// makes some ten passes over the plane in shared memory, each behind a
// barrier, plus an atan2f/sincosf per half-spectrum bin: latency of
// shared memory and barriers, and the FP32 issue of the passes, bound it.
//
// Design (the TPU kernel's DFT-as-matmul, polynomial atan2 and sin/cos are
// not carried over; the FFT itself is in fft_mixer.cuh):
//  1. ln_split_kernel (head only): one thread per pixel; reads the C
//     channels (coalesced across pixels), writes y1 and the normalised
//     second half into x2, which step 2 transforms in place.
//  2. fft_mixer_kernel: one block per (image, channel) plane, its half
//     spectrum in shared memory (H (W/2 + 1) complex values, 66.6 KB at
//     128^2: two 256-thread blocks an SM, so batch 16 at 128^2 is one
//     wave; 512 threads a block where the planes are fewer than the SMs),
//     read from `in` and written to `out` (the head passes x2 as both),
//     the real rows transformed as N = W/2 complex points, the passes in
//     registers, one barrier a pass. Any even H, W with odd prime factors
//     <= 512 whose half spectrum fits in shared memory (fft_mixer_smem <=
//     232,448 bytes), so up to 240 x 240.
//  3. fft_tables_kernel: the twiddle and position tables of one (H, W),
//     made once per size by the wrapper (`lgteun_fft_tables`) and read by
//     every plane of every launch.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_mixer.cuh"

namespace {

constexpr int kThreadsLN = 256;

// x, y1 in their storage types (loads.cuh), y2 float.
template <class TX, class TY>
__global__ void __launch_bounds__(kThreadsLN)
ln_split_kernel(const TX* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, TY* __restrict__ y1,
                float* __restrict__ y2, int C, int HW, float eps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  ln_split_pixels<1>(x, ln_w, ln_b, y1, y2, C, HW, blockIdx.y, p, 0, HW,
                    eps);
}

// `in` and `out` may alias (no __restrict__): every plane is read whole
// into shared memory before any of it is written. 256 threads, two
// blocks an SM, where the planes fill the card (three blocks at 80
// registers a thread spilled and were no faster); 512 threads, one block
// an SM, where there are fewer planes than SMs. Both allow 128 registers
// a thread, as lgb_block.cu does.
template <int kThreads, int kBlocksPerSM, class TI, class TO>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fft_mixer_kernel(const TI* in, TO* out, const float* __restrict__ amp_w,
                 const float* __restrict__ amp_b,
                 const float* __restrict__ pha_w,
                 const float* __restrict__ pha_b,
                 const float* __restrict__ tables, int C, int HW) {
  extern __shared__ float2 smem[];
  const int plane = blockIdx.x;   // b * C + c
  const int c = plane % C;
  const size_t off = (size_t)plane * HW;
  fft_mixer_plane(in + off, out + off, smem, tables, amp_w[c], amp_b[c],
                  pha_w[c], pha_b[c]);
}

// The same with a cluster of two blocks on each plane
// (fft_mixer_plane_pair), where twice the planes still fit on the SMs.
template <class TI, class TO>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(512, 1)
fft_mixer_pair_kernel(const TI* in, TO* out,
                      const float* __restrict__ amp_w,
                      const float* __restrict__ amp_b,
                      const float* __restrict__ pha_w,
                      const float* __restrict__ pha_b,
                      const float* __restrict__ tables, int C, int HW) {
  extern __shared__ float2 smem[];
  const int plane = blockIdx.x / 2;   // b * C + c
  const int c = plane % C;
  const size_t off = (size_t)plane * HW;
  fft_mixer_plane_pair(in + off, out + off, smem, tables, amp_w[c], amp_b[c],
                       pha_w[c], pha_b[c]);
}

// The tables of plan p (fft_mixer.cuh, FftMixerPlan), the plan first.
__global__ void fft_tables_kernel(float* __restrict__ tab, FftMixerPlan p) {
  const int N = p.row.n, H = p.col.n;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < kFftPlanFloats; ++i) tab[i] = 0.f;  // the padding
    *reinterpret_cast<FftMixerPlan*>(tab) = p;
  }
  float2* tw_row = reinterpret_cast<float2*>(tab + p.tw_row);
  float2* tw_half = reinterpret_cast<float2*>(tab + p.tw_half);
  float2* tw_col = reinterpret_cast<float2*>(tab + p.tw_col);
  int* pos = reinterpret_cast<int*>(tab + p.pos_row);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i <= N || i < H;
       i += gridDim.x * blockDim.x) {
    if (i < N) {
      tw_row[i] = fft_twiddle(i, N);
      pos[i] = fft_pos(p.row, i);
    }
    if (i <= N) tw_half[i] = fft_twiddle(i, 2 * N);
    if (i < H) tw_col[i] = fft_twiddle(i, H);
  }
}

// kernel: one of the fft_mixer kernels, launched with `blocks` blocks of
// `threads` on the planes.
template <class Kernel, class TI, class TO>
cudaError_t launch_fft_mixer_kernel(Kernel* kernel, int blocks, int threads,
                                    const TI* in, TO* out,
                                    const float* amp_w, const float* amp_b,
                                    const float* pha_w, const float* pha_b,
                                    const float* tables, int C, int HW,
                                    size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(in, out, amp_w, amp_b, pha_w,
                                            pha_b, tables, C, HW);
  return cudaGetLastError();
}

// Launch fft_mixer_kernel on B * C planes of storage types TI -> TO
// (loads.cuh); checks the lengths it takes and the pairs' alignment.
template <class TI, class TO>
int launch_fft_mixer(const TI* in, TO* out, const float* amp_w,
                     const float* amp_b, const float* pha_w,
                     const float* pha_b, const float* tables, int B, int C,
                     int H, int W, cudaStream_t stream) {
  FftMixerPlan p;
  if (!fft_mixer_plan(H, W, &p) ||
      reinterpret_cast<size_t>(in) % (2 * sizeof(TI)) ||
      reinterpret_cast<size_t>(out) % (2 * sizeof(TO)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fft_mixer_smem(H, W);
  const int planes = B * C;
  if (2 * planes <= sms)
    return (int)launch_fft_mixer_kernel(fft_mixer_pair_kernel<TI, TO>,
                                        2 * planes,
                                        512, in, out, amp_w, amp_b, pha_w,
                                        pha_b, tables, C, H * W, smem,
                                        stream);
  if (planes <= sms)
    return (int)launch_fft_mixer_kernel(fft_mixer_kernel<512, 1, TI, TO>,
                                        planes,
                                        512, in, out, amp_w, amp_b, pha_w,
                                        pha_b, tables, C, H * W, smem,
                                        stream);
  return (int)launch_fft_mixer_kernel(fft_mixer_kernel<256, 2, TI, TO>,
                                      planes, 256,
                                      in, out, amp_w, amp_b, pha_w, pha_b,
                                      tables, C, H * W, smem, stream);
}

}  // namespace

// The plan, twiddles and positions of the mixer of an H x W plane into
// `tables` (`floats` floats; cudaErrorInvalidValue if that is fewer than
// the plan's 28 + 5 (W/2) + 2 H + 2, or the size is not taken).
extern "C" int lgteun_fft_tables(float* tables, int floats, int H, int W,
                                 cudaStream_t stream) {
  FftMixerPlan p;
  if (!fft_mixer_plan(H, W, &p) || floats < p.floats)
    return (int)cudaErrorInvalidValue;
  const int n = (W / 2 + 1 > H ? W / 2 + 1 : H);
  fft_tables_kernel<<<(n + 255) / 256, 256, 0, stream>>>(tables, p);
  return (int)cudaGetLastError();
}

// The layout of the mixer entries' arguments: 2, they take the tables of
// lgteun_fft_tables after pha_b (earlier versions: none).
extern "C" int lgteun_fft_mixer_layout() { return 2; }

// y1, x2 = LN(x)[:, :C/2], global_mixer(LN(x)[:, C/2:]) on [B, C, H, W].
// H and W even, the plane within shared memory (checked by the wrapper).
extern "C" int lgteun_ln_mixer_head(const float* x, const float* ln_w,
                                    const float* ln_b, const float* amp_w,
                                    const float* amp_b, const float* pha_w,
                                    const float* pha_b, const float* tables,
                                    float* y1, float* x2, int B, int C,
                                    int H, int W, float eps,
                                    cudaStream_t stream) {
  const int HW = H * W;
  const dim3 grid_ln((HW + kThreadsLN - 1) / kThreadsLN, B);
  ln_split_kernel<float, float><<<grid_ln, kThreadsLN, 0, stream>>>(
      x, ln_w, ln_b, y1, x2, C, HW, eps);
  return launch_fft_mixer(x2, x2, amp_w, amp_b, pha_w, pha_b, tables, B,
                          C / 2, H, W, stream);
}

// out = global_mixer(x) on [B, C, H, W]; per-channel affine [C] each.
extern "C" int lgteun_global_mixer(const float* x, const float* amp_w,
                                   const float* amp_b, const float* pha_w,
                                   const float* pha_b, const float* tables,
                                   float* out, int B, int C, int H, int W,
                                   cudaStream_t stream) {
  return launch_fft_mixer(x, out, amp_w, amp_b, pha_w, pha_b, tables, B, C,
                          H, W, stream);
}

// The bf16 storage entries (LGTEUN_EVAL_DTYPE, loads.cuh): activations as
// __nv_bfloat16, math in float, one rounding to nearest even on store.

// lgteun_ln_mixer_head with y1 and x2 stored as bf16, x as float (x_bf16
// 0) or bf16 (1). The mixer takes the LN's float value: y2 (float, [B,
// C/2, H, W]) holds it between the LN and the mixer.
extern "C" int lgteun_ln_mixer_head_bf16(
    const void* x, const float* ln_w, const float* ln_b, const float* amp_w,
    const float* amp_b, const float* pha_w, const float* pha_b,
    const float* tables, __nv_bfloat16* y1, __nv_bfloat16* x2, float* y2,
    int B, int C, int H, int W, int x_bf16, float eps, cudaStream_t stream) {
  const int HW = H * W;
  const dim3 grid_ln((HW + kThreadsLN - 1) / kThreadsLN, B);
  if (x_bf16)
    ln_split_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<grid_ln, kThreadsLN, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), ln_w, ln_b, y1, y2, C, HW,
            eps);
  else
    ln_split_kernel<float, __nv_bfloat16><<<grid_ln, kThreadsLN, 0, stream>>>(
        static_cast<const float*>(x), ln_w, ln_b, y1, y2, C, HW, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fft_mixer(static_cast<const float*>(y2), x2, amp_w, amp_b,
                          pha_w, pha_b, tables, B, C / 2, H, W, stream);
}

// lgteun_global_mixer with out stored as bf16, x as float (x_bf16 0:
// the level-1 prior feeds the float LN, as the head's mixer takes it) or
// bf16 (1).
extern "C" int lgteun_global_mixer_bf16(const void* x, const float* amp_w,
                                        const float* amp_b,
                                        const float* pha_w,
                                        const float* pha_b,
                                        const float* tables,
                                        __nv_bfloat16* out, int B, int C,
                                        int H, int W, int x_bf16,
                                        cudaStream_t stream) {
  if (x_bf16)
    return launch_fft_mixer(static_cast<const __nv_bfloat16*>(x), out,
                            amp_w, amp_b, pha_w, pha_b, tables, B, C, H, W,
                            stream);
  return launch_fft_mixer(static_cast<const float*>(x), out, amp_w, amp_b,
                          pha_w, pha_b, tables, B, C, H, W, stream);
}
