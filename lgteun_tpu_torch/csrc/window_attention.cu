// Window multi-head self-attention for Hopper (sm_90a), in three layouts.
//
// Replaces: lgteun_tpu/ops/window_attention.py::
//           fused_window_attention_v3_packed (Pallas `_kernel_v3`; image
//           layout, lgteun_window_attention),
//           fused_window_attention_v2_cm (Pallas `_kernel_v2`; [N, C, S]
//           windows, lgteun_window_attention_windows) and
//           fused_window_attention (Pallas `_kernel`; [N*S, C] rows,
//           lgteun_window_attention_rows).
//
// What bounds it here: per window (64 tokens, C = 16 or 32 channels,
// 2 heads) the work is about 3*C*C*64 + 2*64*64*C multiply-adds on a
// 3*C*64 + 2*64*64 value working set, so HBM traffic (one read and one
// write of the window) is small; the bound is shared-memory bandwidth of
// the three small products and the latency of one block per window.
//
// Design: one block per window (window_attention.cuh), templated on the
// layout the window is read from and written to. The image layout reads
// the window in place from [B, C, H, W]: no partition copy, and none of
// the TPU kernels' two-window lane packing, -1e9 block-diagonal mask or
// windows-per-program blocking.

#include <cuda_runtime.h>
#include <math.h>

#include "window_attention.cuh"

namespace {

constexpr int kThreads = 256;

template <class Layout>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ x,
                        const float* __restrict__ wqkv,  // [3C][C] out, in
                        const float* __restrict__ bqkv,  // [3C]
                        const float* __restrict__ pos,   // [heads][S][S]
                        float* __restrict__ out, int C, int H, int W,
                        int heads, int win, float scale) {
  extern __shared__ float sm[];
  window_attention_body<false>(x, wqkv, bqkv, pos, out, sm, C, heads, win,
                               scale,
                               Layout::of(blockIdx.x, C, H, W, win));
}

template <class Layout>
int launch(const float* x, const float* wqkv, const float* bqkv,
           const float* pos, float* out, int windows, int C, int H, int W,
           int heads, int win, float scale, cudaStream_t stream) {
  const size_t smem = window_attention_smem(C, heads, win);
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<Layout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<Layout><<<windows, kThreads, smem, stream>>>(
      x, wqkv, bqkv, pos, out, C, H, W, heads, win, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// out = window MHSA of x, both [B, C, H, W]; H, W divisible by win,
// win*win <= 64, C divisible by heads (checked by the Python wrapper).
extern "C" int lgteun_window_attention(const float* x, const float* wqkv,
                                       const float* bqkv, const float* pos,
                                       float* out, int B, int C, int H, int W,
                                       int heads, int win, float scale,
                                       cudaStream_t stream) {
  return launch<ImageWindow>(x, wqkv, bqkv, pos, out, B * (H / win) * (W / win),
                             C, H, W, heads, win, scale, stream);
}

// The same on N windows laid out [N, C, win*win].
extern "C" int lgteun_window_attention_windows(
    const float* x, const float* wqkv, const float* bqkv, const float* pos,
    float* out, int N, int C, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch<ChannelMajor>(x, wqkv, bqkv, pos, out, N, C, 0, 0, heads, win,
                              scale, stream);
}

// The same on N windows laid out [N, win*win, C] ([N*S, C] rows).
extern "C" int lgteun_window_attention_rows(
    const float* x, const float* wqkv, const float* bqkv, const float* pos,
    float* out, int N, int C, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch<TokenMajor>(x, wqkv, bqkv, pos, out, N, C, 0, 0, heads, win,
                            scale, stream);
}
