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
// Design: one block per window. The window is read in place from the
// [B, C, H, W] image and the result written in place into the output
// image: no partition copy, and none of the TPU kernel's two-window lane
// packing or -1e9 block-diagonal mask. In shared memory: the window
// [C][64], qkv [3C][64], the logits [heads*64][65] (row stride 65 so the
// A.V pass reads rows without bank conflicts) and 1/rowsum. qkv
// projection with bias, (q * scale) . k + pos, a max-subtracted softmax
// with expf in f32 (one warp per row, shuffle reductions), then
// (e . v) * 1/rowsum as in the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>

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
  const int S = win * win, PS = S + 1, hd = C / heads;
  float* xs = sm;                       // [C][S]
  float* qkv = xs + C * S;              // [3C][S]
  float* lg = qkv + 3 * C * S;          // [heads*S][PS]
  float* rinv = lg + heads * S * PS;    // [heads*S]

  const int nwx = W / win, nwin = (H / win) * nwx;
  const int b = blockIdx.x / nwin, wi = blockIdx.x % nwin;
  const int y0 = (wi / nwx) * win, x0 = (wi % nwx) * win;
  const size_t HW = (size_t)H * W;
  const float* xb = x + (size_t)b * C * HW;
  float* ob = out + (size_t)b * C * HW;

  for (int i = threadIdx.x; i < C * S; i += blockDim.x) {
    const int c = i / S, s = i % S;
    xs[i] = xb[c * HW + (size_t)(y0 + s / win) * W + x0 + s % win];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 3 * C * S; i += blockDim.x) {
    const int f = i / S, s = i % S;
    const float* wr = wqkv + (size_t)f * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(wr[c], xs[c * S + s], acc);
    qkv[i] = acc + bqkv[f];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < heads * S * S; i += blockDim.x) {
    const int row = i / S, j = i % S;  // row = head * S + query
    const int h = row / S, qi = row % S;
    const float* q = qkv + (h * hd) * S;
    const float* k = qkv + (C + h * hd) * S;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(q[d * S + qi] * scale, k[d * S + j], acc);
    lg[row * PS + j] = acc + pos[(size_t)row * S + j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int row = warp; row < heads * S; row += nwarps) {
    float* r = lg + row * PS;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, r[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(r[j] - m);
      r[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) rinv[row] = 1.0f / sum;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < C * S; i += blockDim.x) {
    const int c = i / S, qi = i % S, h = c / hd;
    const float* r = lg + (h * S + qi) * PS;
    const float* v = qkv + (2 * C + c) * S;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(r[j], v[j], acc);
    ob[c * HW + (size_t)(y0 + qi / win) * W + x0 + qi % win] =
        acc * rinv[h * S + qi];
  }
}

}  // namespace

// out = window MHSA of x, both [B, C, H, W]; H, W divisible by win,
// win*win <= 64, C divisible by heads (checked by the Python wrapper).
extern "C" int lgteun_window_attention(const float* x, const float* wqkv,
                                       const float* bqkv, const float* pos,
                                       float* out, int B, int C, int H, int W,
                                       int heads, int win, float scale,
                                       cudaStream_t stream) {
  const int S = win * win;
  const size_t smem = sizeof(float) * ((size_t)4 * C * S +
                                       (size_t)heads * S * (S + 1) +
                                       (size_t)heads * S);
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * (H / win) * (W / win);
  window_attention_kernel<<<blocks, kThreads, smem, stream>>>(
      x, wqkv, bqkv, pos, out, C, H, W, heads, win, scale);
  return (int)cudaGetLastError();
}
