// Device code shared by window_attention.cu (B2) and lgb_block.cu (B8):
// multi-head self-attention of one win x win window, read in place from a
// [B, C, H, W] image and written in place into the output image.
//
// In shared memory: the window [C][S], qkv [3C][S], the logits
// [heads*S][S+1] (row stride S+1 so the A.V pass reads rows without bank
// conflicts) and 1/rowsum. qkv projection with bias, (q * scale) . k +
// pos, a max-subtracted softmax with expf in f32 (one warp per row,
// shuffle reductions), then (e . v) * 1/rowsum as in the TPU kernel.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "loads.cuh"

namespace {

// Shared memory one window needs.
inline size_t window_attention_smem(int C, int heads, int win) {
  const size_t S = (size_t)win * win;
  return sizeof(float) * (4 * C * S + heads * S * (S + 1) + heads * S);
}

// Window wi of image b. x/out [B, C, H, W]; wqkv [3C][C] (out, in);
// bqkv [3C]; pos [heads][S][S]; kCoherent: see loads.cuh.
template <bool kCoherent>
__device__ __forceinline__ void window_attention_window(
    const float* x, const float* wqkv, const float* bqkv, const float* pos,
    float* out, float* sm, int C, int H, int W, int heads, int win,
    float scale, int b, int wi) {
  const int S = win * win, PS = S + 1, hd = C / heads;
  float* xs = sm;                       // [C][S]
  float* qkv = xs + C * S;              // [3C][S]
  float* lg = qkv + 3 * C * S;          // [heads*S][PS]
  float* rinv = lg + heads * S * PS;    // [heads*S]

  const int nwx = W / win;
  const int y0 = (wi / nwx) * win, x0 = (wi % nwx) * win;
  const size_t HW = (size_t)H * W;
  const float* xb = x + (size_t)b * C * HW;
  float* ob = out + (size_t)b * C * HW;

  for (int i = threadIdx.x; i < C * S; i += blockDim.x) {
    const int c = i / S, s = i % S;
    xs[i] = load_act<kCoherent>(xb + c * HW + (size_t)(y0 + s / win) * W +
                                x0 + s % win);
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
