// 8x8-window multi-head self-attention for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/window_attention.py::
//           fused_window_attention_v3_packed (Pallas `_kernel_v3`).
//
// What bounds it here: per window (64 tokens, C = 16 or 32 channels,
// 2 heads) the work is about 3*C*C*64 + 2*64*64*C multiply-adds on a
// 3*C*64 + 2*64*64 value working set, so HBM traffic (one read and one
// write of the window) is small; the bound is shared-memory bandwidth of
// the three small products and the latency of one block per window.
//
// Design: one block per window (window_attention.cuh). The window is read
// in place from the [B, C, H, W] image and the result written in place
// into the output image: no partition copy, and none of the TPU kernel's
// two-window lane packing or -1e9 block-diagonal mask.

#include <cuda_runtime.h>
#include <math.h>

#include "window_attention.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ x,
                        const float* __restrict__ wqkv,  // [3C][C] out, in
                        const float* __restrict__ bqkv,  // [3C]
                        const float* __restrict__ pos,   // [heads][S][S]
                        float* __restrict__ out, int C, int H, int W,
                        int heads, int win, float scale) {
  extern __shared__ float sm[];
  const int nwin = (H / win) * (W / win);
  window_attention_window<false>(x, wqkv, bqkv, pos, out, sm, C, H, W, heads,
                                 win, scale, blockIdx.x / nwin,
                                 blockIdx.x % nwin);
}

}  // namespace

// out = window MHSA of x, both [B, C, H, W]; H, W divisible by win,
// win*win <= 64, C divisible by heads (checked by the Python wrapper).
extern "C" int lgteun_window_attention(const float* x, const float* wqkv,
                                       const float* bqkv, const float* pos,
                                       float* out, int B, int C, int H, int W,
                                       int heads, int win, float scale,
                                       cudaStream_t stream) {
  const size_t smem = window_attention_smem(C, heads, win);
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * (H / win) * (W / win);
  window_attention_kernel<<<blocks, kThreads, smem, stream>>>(
      x, wqkv, bqkv, pos, out, C, H, W, heads, win, scale);
  return (int)cudaGetLastError();
}
