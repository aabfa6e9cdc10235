// Device code shared by window_attention.cu (B2, B6, B7) and lgb_block.cu
// (B8): multi-head self-attention of one win x win window, read in place
// from its layout in global memory and written in place in the same
// layout. The layouts (`Layout::at(c, s)`, the offset of channel c of
// token s):
//
//   ImageWindow   a window of a [B, C, H, W] image           (B2, B8)
//   ChannelMajor  window n of [N, C, S]                      (B6)
//   TokenMajor    window n of [N, S, C] rows                 (B7)
//
// In shared memory: the window [C][S], qkv [3C][S], the logits
// [heads*S][S+1] (row stride S+1 so the A.V pass reads rows without bank
// conflicts) and 1/rowsum. qkv projection with bias, (q * scale) . k +
// pos, a max-subtracted softmax with expf in f32 (one warp per row,
// shuffle reductions), then (e . v) * 1/rowsum as in the TPU kernel. The
// layout changes only which thread loads and stores which value, never
// the arithmetic, so every layout gives the same bits. Neighbouring
// threads take neighbouring tokens, except where the layout's neighbours
// are channels (TokenMajor): there the window is loaded channel-fastest
// into rows of stride S+1 (no bank conflicts), and the output is staged
// in those rows and stored channel-fastest (coalesced).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "loads.cuh"

namespace {

// Shared memory one window needs.
inline size_t window_attention_smem(int C, int heads, int win) {
  const size_t S = (size_t)win * win;
  return sizeof(float) * (4 * C * S + C + heads * S * (S + 1) + heads * S);
}

// Window wi of image b of [B, C, H, W].
struct ImageWindow {
  static constexpr bool kTokenInner = true;  // consecutive threads: tokens
  size_t base, HW;
  int W, win;
  __device__ static ImageWindow of(int n, int C, int H, int W, int win) {
    const int nwx = W / win, nwin = (H / win) * nwx;
    const int b = n / nwin, wi = n % nwin;
    const int y0 = (wi / nwx) * win, x0 = (wi % nwx) * win;
    return {(size_t)b * C * H * W + (size_t)y0 * W + x0, (size_t)H * W, W,
            win};
  }
  __device__ size_t at(int c, int s) const {
    return base + c * HW + (size_t)(s / win) * W + s % win;
  }
};

// Window n of [N, C, S].
struct ChannelMajor {
  static constexpr bool kTokenInner = true;
  size_t base;
  int S;
  __device__ static ChannelMajor of(int n, int C, int, int, int win) {
    return {(size_t)n * C * win * win, win * win};
  }
  __device__ size_t at(int c, int s) const { return base + (size_t)c * S + s; }
};

// Window n of [N, S, C] (rows of C channels).
struct TokenMajor {
  static constexpr bool kTokenInner = false;  // consecutive threads: channels
  size_t base;
  int C;
  __device__ static TokenMajor of(int n, int C, int, int, int win) {
    return {(size_t)n * win * win * C, C};
  }
  __device__ size_t at(int c, int s) const { return base + (size_t)s * C + c; }
};

// One window in layout `lay`. x/out in that layout, each in its storage
// type (loads.cuh); wqkv [3C][C] (out, in); bqkv [3C]; pos [heads][S][S];
// kCoherent: see loads.cuh.
template <bool kCoherent, class Layout, class TI, class TO>
__device__ __forceinline__ void window_attention_body(
    const TI* x, const float* wqkv, const float* bqkv, const float* pos,
    TO* out, float* sm, int C, int heads, int win, float scale,
    const Layout& lay) {
  const int S = win * win, PS = S + 1, hd = C / heads;
  const int XS = Layout::kTokenInner ? S : PS;  // row stride of xs
  float* xs = sm;                       // [C][XS]; the staged output
  float* qkv = xs + C * PS;             // [3C][S]
  float* lg = qkv + 3 * C * S;          // [heads*S][PS]
  float* rinv = lg + heads * S * PS;    // [heads*S]

  for (int i = threadIdx.x; i < C * S; i += blockDim.x) {
    const int c = Layout::kTokenInner ? i / S : i % C;
    const int s = Layout::kTokenInner ? i % S : i / C;
    xs[c * XS + s] = load_act<kCoherent>(x + lay.at(c, s));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 3 * C * S; i += blockDim.x) {
    const int f = i / S, s = i % S;
    const float* wr = wqkv + (size_t)f * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(wr[c], xs[c * XS + s], acc);
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
    if (Layout::kTokenInner)
      store_act(out + lay.at(c, qi), acc * rinv[h * S + qi]);
    else
      xs[c * XS + qi] = acc * rinv[h * S + qi];
  }
  if (!Layout::kTokenInner) {
    __syncthreads();
    for (int i = threadIdx.x; i < C * S; i += blockDim.x)
      store_act(out + lay.at(i % C, i / C), xs[(i % C) * XS + i / C]);
  }
}

// Window wi of image b. x/out [B, C, H, W].
template <bool kCoherent, class TI, class TO>
__device__ __forceinline__ void window_attention_window(
    const TI* x, const float* wqkv, const float* bqkv, const float* pos,
    TO* out, float* sm, int C, int H, int W, int heads, int win,
    float scale, int b, int wi) {
  const int nwin = (H / win) * (W / win);
  window_attention_body<kCoherent>(
      x, wqkv, bqkv, pos, out, sm, C, heads, win, scale,
      ImageWindow::of(b * nwin + wi, C, H, W, win));
}

}  // namespace
