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
// 2 heads) the work is 3*C*C*64 + 2*64*64*C multiply-adds on a 3*C*64 +
// 2*64*64 value working set, so HBM traffic (one read and one write of
// the window) is small and the three products set the pace. The
// FP32-core body (window_attention.cuh: one block a window, every
// multiply-add a scalar FMA fed by two shared-memory loads, the position
// table re-read from L2 every window) took 0.1211 ms at 128^2/C32 and
// 0.0693 at 64^2/C64, batch 4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6),
// 5 % of its FP32 bound.
//
// Design: the tensor-core body (window_attention_tc.cuh): one warpgroup a
// (window, head), all three products as wgmma TF32 with the 3xTF32 split,
// q and P passed from one product to the next in registers, pos[head] in
// registers as the logits accumulator's start. Persistent blocks of two
// warpgroups (grid: the blocks resident on the card, a multiple of the
// heads so that each warpgroup keeps one head) walk the windows; each
// block copies the pre-split qkv weights (lgteun_attention_fragments) to
// shared memory once. Shapes the tensor-core body does not take
// (attention_tc_takes: win < 8, a head wider than 32, C above 64) run the
// FP32-core body through the *_fp32 entries; the Python wrapper picks the
// entry by shape. The image layout reads the window in place from [B, C,
// H, W]: no partition copy, and none of the TPU kernels' two-window lane
// packing, -1e9 block-diagonal mask or windows-per-program blocking.

#include <cuda_runtime.h>
#include <math.h>

#include "window_attention.cuh"
#include "window_attention_tc.cuh"

namespace {

constexpr int kThreads = 256;

// TS: the storage type of x and out (loads.cuh).
template <class Layout, class TS>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const TS* __restrict__ x,
                        const float* __restrict__ wqkv,  // [3C][C] out, in
                        const float* __restrict__ bqkv,  // [3C]
                        const float* __restrict__ pos,   // [heads][S][S]
                        TS* __restrict__ out, int C, int H, int W,
                        int heads, int win, float scale) {
  extern __shared__ float sm[];
  window_attention_body<false>(x, wqkv, bqkv, pos, out, sm, C, heads, win,
                               scale,
                               Layout::of(blockIdx.x, C, H, W, win));
}

template <class Layout, class TS>
int launch_fp32(const TS* x, const float* wqkv, const float* bqkv,
           const float* pos, TS* out, int windows, int C, int H, int W,
           int heads, int win, float scale, cudaStream_t stream) {
  const size_t smem = window_attention_smem(C, heads, win);
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<Layout, TS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<Layout, TS><<<windows, kThreads, smem, stream>>>(
      x, wqkv, bqkv, pos, out, C, H, W, heads, win, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef LGTEUN_BF16_UNIT
// The FP32-core body. out = window MHSA of x, both [B, C, H, W]; H, W
// divisible by win, win*win <= 64, C divisible by heads (checked by the
// Python wrapper); wqkv [3C][C] (out, in).
extern "C" int lgteun_window_attention_fp32(
    const float* x, const float* wqkv, const float* bqkv, const float* pos,
    float* out, int B, int C, int H, int W, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch_fp32<ImageWindow>(x, wqkv, bqkv, pos, out, B * (H / win) * (W / win),
                             C, H, W, heads, win, scale, stream);
}

// The same on N windows laid out [N, C, win*win].
extern "C" int lgteun_window_attention_windows_fp32(
    const float* x, const float* wqkv, const float* bqkv, const float* pos,
    float* out, int N, int C, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch_fp32<ChannelMajor>(x, wqkv, bqkv, pos, out, N, C, 0, 0, heads, win,
                              scale, stream);
}

// The same on N windows laid out [N, win*win, C] ([N*S, C] rows).
extern "C" int lgteun_window_attention_rows_fp32(
    const float* x, const float* wqkv, const float* bqkv, const float* pos,
    float* out, int N, int C, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch_fp32<TokenMajor>(x, wqkv, bqkv, pos, out, N, C, 0, 0, heads, win,
                            scale, stream);
}
#endif  // LGTEUN_BF16_UNIT

namespace {

constexpr int kTcWG = 2;  // warpgroups a block of the tensor-core kernel

// The tensor-core body on persistent blocks of kTcWG warpgroups, one block
// an SM: the body keeps q, P (hi and lo) and pos[head] in registers, which
// takes 212-255 registers a thread; capped at 128 for two blocks an SM it
// spilled 144-640 bytes a thread and ran 1.1x-1.8x slower (PERF.md §6).
// Global
// warpgroup G keeps head G % heads and walks the windows G / heads, +
// (warpgroups of the grid) / heads, ... (the grid's warpgroups are a
// multiple of the heads). wf: the weight fragments (attention_fragments),
// copied to shared memory once.
template <int HDP, int CP, class Layout, class TS>
__global__ void __launch_bounds__(128 * kTcWG, 1)
window_attention_tc_kernel(const TS* __restrict__ x,
                           const float* __restrict__ wf,
                           const float* __restrict__ bqkv,  // [3C]
                           const float* __restrict__ pos,   // [heads][64][64]
                           TS* __restrict__ out, int windows, int C,
                           int H, int W, int heads, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int nf = heads * 6 * HDP * CP;
  attention_load_weights(sm, wf, nf);
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int G = blockIdx.x * kTcWG + wg, T = gridDim.x * kTcWG;
  const int h = G % heads;
  float* kv = sm + nf + wg * 4 * kAttnS * HDP;
  float p[8][4];
  attention_pos(p, pos, h);
  for (int w = G / heads; w < windows; w += T / heads)
    window_attention_head_tc<HDP, CP, false>(
        x, sm, bqkv, out, kv, p, C, C / heads, h, scale,
        Layout::of(w, C, H, W, 8), wg);
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

template <int HDP, int CP, class Layout, class TS>
int launch_tc_shape(const TS* x, const float* wf, const float* bqkv,
                    const float* pos, TS* out, int windows, int C, int H,
                    int W, int heads, float scale, cudaStream_t stream) {
  auto kernel = window_attention_tc_kernel<HDP, CP, Layout, TS>;
  const size_t smem = attention_tc_smem(C, heads, kTcWG);
  // the attribute and the occupancy, looked up once per device and size,
  // not at every launch
  static int dev_seen = -1, sms = 0, per_sm = 0;
  static size_t smem_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != dev_seen || smem != smem_seen) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, 128 * kTcWG, smem)) != cudaSuccess)
      return (int)err;
    dev_seen = dev;
    smem_seen = smem;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // resident blocks, no more than the (window, head) pairs need, rounded
  // up to whole multiples of the heads' period
  const int need = (int)(((long long)windows * heads + kTcWG - 1) / kTcWG);
  int grid = per_sm * sms < need ? per_sm * sms : need;
  const int period = heads / gcd(heads, kTcWG);
  grid = (grid + period - 1) / period * period;
  kernel<<<grid, 128 * kTcWG, smem, stream>>>(x, wf, bqkv, pos, out, windows,
                                              C, H, W, heads, scale);
  return (int)cudaGetLastError();
}

template <class Layout, class TS>
int launch_tc(const TS* x, const float* wf, const float* bqkv,
              const float* pos, TS* out, int windows, int C, int H, int W,
              int heads, int win, float scale, cudaStream_t stream) {
  if (!attention_tc_takes(C, heads, win)) return (int)cudaErrorInvalidValue;
  const int hdp = attn_pad(C / heads), cp = attn_pad(C);
#define LGTEUN_TC_SHAPE(H_, C_)                                              \
  if (hdp == H_ && cp == C_)                                                 \
    return launch_tc_shape<H_, C_, Layout, TS>(x, wf, bqkv, pos, out,        \
                                              windows, C,                    \
                                           H, W, heads, scale, stream);
  LGTEUN_TC_SHAPE(8, 8)
  LGTEUN_TC_SHAPE(8, 16)
  LGTEUN_TC_SHAPE(8, 32)
  LGTEUN_TC_SHAPE(8, 64)
  LGTEUN_TC_SHAPE(16, 16)
  LGTEUN_TC_SHAPE(16, 32)
  LGTEUN_TC_SHAPE(16, 64)
  LGTEUN_TC_SHAPE(32, 32)
  LGTEUN_TC_SHAPE(32, 64)
#undef LGTEUN_TC_SHAPE
  return (int)cudaErrorInvalidValue;
}

__global__ void attention_fragments_kernel(const float* __restrict__ w,
                                           int C, int heads, int hdp, int cp,
                                           float* __restrict__ out) {
  const int hd = C / heads;
  const size_t total = (size_t)heads * 6 * hdp * cp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    // i = ((((((head, q/k/v), hi/lo), n-group), k-quad), n % 8), k % 4)
    size_t r = i;
    const int e = r % 4; r /= 4;
    const int nr = r % 8; r /= 8;
    const int kq = r % (cp / 4); r /= cp / 4;
    const int ng = r % (hdp / 8); r /= hdp / 8;
    const int part = r % 2; r /= 2;
    const int p = r % 3;
    const int h = (int)(r / 3);
    const int d = ng * 8 + nr, c = kq * 4 + e;
    const float v = d < hd && c < C
                        ? w[(size_t)(p * C + h * hd + d) * C + c] : 0.f;
    const uint32_t hi = tf32_rna(v);
    out[i] = part ? __uint_as_float(tf32_rna(v - __uint_as_float(hi)))
                  : __uint_as_float(hi);
  }
}

}  // namespace

#ifndef LGTEUN_BF16_UNIT
// The tensor-core body. out = window MHSA of x, both [B, C, H, W]; H, W
// divisible by 8, the shape taken by attention_tc_takes(C, heads, win)
// (checked by the Python wrapper and here); wf: wqkv as
// lgteun_attention_fragments lays it out.
extern "C" int lgteun_window_attention(const float* x, const float* wf,
                                       const float* bqkv, const float* pos,
                                       float* out, int B, int C, int H, int W,
                                       int heads, int win, float scale,
                                       cudaStream_t stream) {
  return launch_tc<ImageWindow>(x, wf, bqkv, pos, out,
                                B * (H / win) * (W / win), C, H, W, heads,
                                win, scale, stream);
}

// The same on N windows laid out [N, C, win*win].
extern "C" int lgteun_window_attention_windows(
    const float* x, const float* wf, const float* bqkv, const float* pos,
    float* out, int N, int C, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch_tc<ChannelMajor>(x, wf, bqkv, pos, out, N, C, 0, 0, heads,
                                 win, scale, stream);
}

// The same on N windows laid out [N, win*win, C] ([N*S, C] rows).
extern "C" int lgteun_window_attention_rows(
    const float* x, const float* wf, const float* bqkv, const float* pos,
    float* out, int N, int C, int heads, int win, float scale,
    cudaStream_t stream) {
  return launch_tc<TokenMajor>(x, wf, bqkv, pos, out, N, C, 0, 0, heads,
                               win, scale, stream);
}

// out = wqkv [3C, C] (out, in) as the tensor-core body's weight fragments
// (the same bits as ops/window_attention.py::attention_fragments):
// [heads][q, k, v][hi, lo][hdp / 8][cp / 4][8][4], element (d, c) of head
// h's part p = wqkv[p C + h hd + d][c] (zero for d >= hd or c >= C) at
// n-group d / 8, k-quad c / 4, [d % 8][c % 4]: wgmma's K-major core
// matrices without swizzle. hdp = attn_pad(C / heads), cp = attn_pad(C).
extern "C" int lgteun_attention_fragments(const float* w, int C, int heads,
                                          int hdp, int cp, float* out,
                                          cudaStream_t stream) {
  if (heads < 1 || C % heads || hdp != attn_pad(C / heads) ||
      cp != attn_pad(C))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)heads * 6 * hdp * cp;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                       : 1024);
  attention_fragments_kernel<<<blocks, 256, 0, stream>>>(w, C, heads, hdp,
                                                         cp, out);
  return (int)cudaGetLastError();
}

// The layout of wqkv that lgteun_window_attention(_windows, _rows) and
// lgteun_lgb_block take: 2 = the tensor-core body's fragments, where
// attention_tc_takes the shape (earlier versions, without this entry: the
// [3C][C] rows, which the *_fp32 entries take).
extern "C" int lgteun_window_attention_layout() { return 2; }
#else  // LGTEUN_BF16_UNIT: window_attention_bf16.cu

// The bf16 storage entries (LGTEUN_EVAL_DTYPE, loads.cuh): x and out as
// __nv_bfloat16, math in float (the tensor-core body's 3xTF32 products
// included), one rounding to nearest even on store. Arguments as the
// float32 entries of the same name without _bf16.
extern "C" int lgteun_window_attention_bf16(
    const __nv_bfloat16* x, const float* wf, const float* bqkv,
    const float* pos, __nv_bfloat16* out, int B, int C, int H, int W,
    int heads, int win, float scale, cudaStream_t stream) {
  return launch_tc<ImageWindow>(x, wf, bqkv, pos, out,
                                B * (H / win) * (W / win), C, H, W, heads,
                                win, scale, stream);
}

extern "C" int lgteun_window_attention_bf16_fp32(
    const __nv_bfloat16* x, const float* wqkv, const float* bqkv,
    const float* pos, __nv_bfloat16* out, int B, int C, int H, int W,
    int heads, int win, float scale, cudaStream_t stream) {
  return launch_fp32<ImageWindow>(x, wqkv, bqkv, pos, out,
                                  B * (H / win) * (W / win), C, H, W, heads,
                                  win, scale, stream);
}

extern "C" int lgteun_window_attention_windows_bf16(
    const __nv_bfloat16* x, const float* wf, const float* bqkv,
    const float* pos, __nv_bfloat16* out, int N, int C, int heads, int win,
    float scale, cudaStream_t stream) {
  return launch_tc<ChannelMajor>(x, wf, bqkv, pos, out, N, C, 0, 0, heads,
                                 win, scale, stream);
}

extern "C" int lgteun_window_attention_windows_bf16_fp32(
    const __nv_bfloat16* x, const float* wqkv, const float* bqkv,
    const float* pos, __nv_bfloat16* out, int N, int C, int heads, int win,
    float scale, cudaStream_t stream) {
  return launch_fp32<ChannelMajor>(x, wqkv, bqkv, pos, out, N, C, 0, 0,
                                   heads, win, scale, stream);
}
#endif  // LGTEUN_BF16_UNIT
