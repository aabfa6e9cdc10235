// Whole LGB block in one launch for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/lgb_block_kernel.py::fused_lgb_block_cm
//           (Pallas `_kernel`), on [B, C, H, W]:
//
//   y  = LN(x);  x1 = window_MHSA(y[:C/2]);  x2 = global_mixer(y[C/2:])
//   xm = x + proj([x1; x2]);  out = xm + FFN(LN(xm))
//
// What bounds it here: the work of its three phases, as in B1-B3 (the
// FFN's products, the FFT's shared-memory stages, the window products);
// fusing saves only the launches between them, not HBM traffic worth
// having: the TPU kernel kept a whole image in VMEM, while one H100 block
// holds at most 227 KB, a third of one image's activations at 128x128 /
// C = 32.
//
// Design: a persistent cooperative kernel, grid = the blocks that fit on
// the card at once (one 512-thread block an SM: at 128 registers a
// thread it fills the register file), phases separated by grid.sync():
//   A. LN + split, one thread per pixel: y1 and y2 into global scratch;
//   B. a work list of the (image, channel) FFT mixer planes (y2 -> x2 in
//      place, B1's half-spectrum body in a call of its own, mixer_plane)
//      followed by the windows (y1 -> x1), taken from an atomic
//      counter so the long planes start first and the windows fill in.
//      The windows run B2's tensor-core body (window_attention_tc.cuh)
//      where it takes the shape and 4 is a multiple of the heads: an item
//      is 4 (window, head) pairs, one a warpgroup, so warpgroup wg always
//      has head wg % heads and keeps its position bias in registers; the
//      block copies the weight fragments to shared memory at its first
//      window item (no plane comes after it). Otherwise an item is one
//      window on the FP32-core body (window_attention.cuh), and wqkv is
//      given as [3C/2][C/2] rows. An item's result does not depend on the
//      block that takes it, so the racy work list gives the same bits;
//   C. the tail on 8x8 tiles with a 1-pixel halo, x + proj([x1; x2]) then
//      LN + FFN + residual, into `out`. C > 64 takes B3's wide tile in
//      this launch too: its 182 KB of shared memory fit the budget, and
//      its h1 slot is block blockIdx.x's part of the scratch (one block
//      an SM, which that shared memory makes certain).
// Every phase runs the device code of B1-B3 (fft_mixer.cuh,
// window_attention(_tc).cuh, block_tail.cuh; phase C B3's tensor-core
// tile, whose 512 threads and block_tail_tc_smem are this launch's thread
// count and fit its one shared-memory budget), so the block computes what
// the three-kernel chain computes to FP32 rounding. The TPU kernel's
// window-pair packing, its permutation matrices, the -1e9 block-diagonal
// table and the tanh-form exp are not carried over. Scratch is read
// through L2 (loads.cuh): it is written earlier in the same launch, on
// other SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "block_tail.cuh"
#include "fft_mixer.cuh"
#include "window_attention.cuh"
#include "window_attention_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
static_assert(kThreads == kTcThreads, "phase C runs the tail's tile");

struct LgbBlockArgs {
  const float *x, *ln_w, *ln_b, *amp_w, *amp_b, *pha_w, *pha_b;
  const float* fft_tab;  // the mixer's tables (lgteun_fft_tables)
  const float *wqkv, *bqkv, *pos;
  TailWeights tail;
  float *y1, *x2, *x1;  // scratch, [B, C/2, H, W] each
  float* h1;            // scratch: the wide tile's h1 slots, one a block
  int* counter;         // the phase-B work list
  int attn;             // the tensor-core attention's shape, -1: FP32 core
  int attn_w;           // floats of its weight fragments
  float* out;
  int B, C, C4, H, W, heads, win;
  float scale, eps;
  int smem_item;        // float offset of the shared work-item slot
};

// The tensor-core attention's (HDP, CP) shapes, indexed by
// LgbBlockArgs::attn.
constexpr int kAttnShapes[][2] = {{8, 8},   {8, 16},  {8, 32},
                                  {8, 64},  {16, 16}, {16, 32},
                                  {16, 64}, {32, 32}, {32, 64}};

// Work item `grp` of the windows: (window, head) pair 4 grp + wg on
// warpgroup wg; pos: head wg % heads.
template <int HDP, int CP>
__device__ __forceinline__ void attention_group(const LgbBlockArgs& a,
                                                float* sm,
                                                const float (&pos)[8][4],
                                                int grp) {
  const int C2 = a.C / 2, wg = threadIdx.x >> 7, pair = 4 * grp + wg;
  const int w = pair / a.heads;
  if (w >= a.B * (a.H / 8) * (a.W / 8)) return;
  float* kv = sm + a.heads * 6 * HDP * CP + wg * 4 * kAttnS * HDP;
  window_attention_head_tc<HDP, CP, true>(
      a.y1, sm, a.bqkv, a.x1, kv, pos, C2, C2 / a.heads, pair % a.heads,
      a.scale, ImageWindow::of(w, C2, a.H, a.W, 8), wg);
}

// The same for the launch's shape a.attn.
__device__ __forceinline__ void attention_item(const LgbBlockArgs& a,
                                               float* sm,
                                               const float (&pos)[8][4],
                                               int grp) {
  switch (a.attn) {
#define LGTEUN_SHAPE(i)                                                   \
  case i:                                                                 \
    attention_group<kAttnShapes[i][0], kAttnShapes[i][1]>(a, sm, pos, grp); \
    break;
    LGTEUN_SHAPE(0) LGTEUN_SHAPE(1) LGTEUN_SHAPE(2) LGTEUN_SHAPE(3)
    LGTEUN_SHAPE(4) LGTEUN_SHAPE(5) LGTEUN_SHAPE(6) LGTEUN_SHAPE(7)
    LGTEUN_SHAPE(8)
#undef LGTEUN_SHAPE
  }
}

// The mixer of one plane in place, as a call of its own: inlined, its
// passes shared one register allocation with the window attention and the
// tail, and ptxas spilled more of both.
__device__ __noinline__ void mixer_plane(float* plane, float2* sm,
                                         const float* tab, float aw,
                                         float ab, float pw, float pb) {
  fft_mixer_plane(plane, plane, sm, tab, aw, ab, pw, pb);
}

__global__ void __launch_bounds__(kThreads) lgb_block_kernel(LgbBlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  int* item = reinterpret_cast<int*>(sm + a.smem_item);
  cg::grid_group grid = cg::this_grid();
  const int C2 = a.C / 2, HW = a.H * a.W;

  // A. LN + split
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.counter = 0;
  const int pixels = a.B * HW;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pixels;
       i += gridDim.x * blockDim.x)
    ln_split_pixel(a.x, a.ln_w, a.ln_b, a.y1, a.x2, a.C, HW, i / HW, i % HW,
                   a.eps);
  grid.sync();

  // B. mixer planes, then windows (the barrier after taking an item also
  // keeps the previous item's shared memory until every thread is done)
  const int planes = a.B * C2;
  const int nwin = (a.H / a.win) * (a.W / a.win);
  const bool tc = a.attn >= 0;
  const int items = planes + (tc ? (a.B * nwin * a.heads + 3) / 4
                                 : a.B * nwin);
  bool loaded = false;  // the attention weights in shared memory
  float pos[8][4];
  for (;;) {
    if (threadIdx.x == 0) *item = atomicAdd(a.counter, 1);
    __syncthreads();
    const int it = *item;
    __syncthreads();
    if (it >= items) break;
    if (it < planes) {
      const int c = it % C2;
      float* plane = a.x2 + (size_t)it * HW;
      mixer_plane(plane, reinterpret_cast<float2*>(sm), a.fft_tab, a.amp_w[c],
                  a.amp_b[c], a.pha_w[c], a.pha_b[c]);
    } else if (tc) {
      if (!loaded) {
        attention_load_weights(sm, a.wqkv, a.attn_w);
        attention_pos(pos, a.pos, (threadIdx.x >> 7) % a.heads);
        __syncthreads();
        loaded = true;
      }
      attention_item(a, sm, pos, it - planes);
    } else {
      const int w = it - planes;
      window_attention_window<true>(a.y1, a.wqkv, a.bqkv, a.pos, a.x1, sm, C2,
                                    a.H, a.W, a.heads, a.win, a.scale,
                                    w / nwin, w % nwin);
    }
  }
  grid.sync();

  // C. tail
  const int tiles = (a.H / kTailT) * (a.W / kTailT);
  for (int t = blockIdx.x; t < a.B * tiles; t += gridDim.x) {
    if (a.C <= 32)
      block_tail_tile_tc<2, true, false, true>(a.x, a.x1, a.x2, nullptr,
                                               a.tail, a.out, sm, nullptr,
                                               a.C, a.H, a.W, a.eps,
                                               t / tiles, t % tiles);
    else if (a.C <= 64)
      block_tail_tile_tc<4, true, false, true>(a.x, a.x1, a.x2, nullptr,
                                               a.tail, a.out, sm, nullptr,
                                               a.C, a.H, a.W, a.eps,
                                               t / tiles, t % tiles);
    else
      block_tail_tile_tc<8, true, false, true>(
          a.x, a.x1, a.x2, nullptr, a.tail, a.out, sm,
          a.h1 + blockIdx.x * tail_h1_floats(128), a.C, a.H, a.W, a.eps,
          t / tiles, t % tiles);
    __syncthreads();  // shared memory is reused by the next tile
  }
}

}  // namespace

// out = one LGB block of x, both [B, C, H, W]. C % 4 == 0, C <= 128, C4 =
// 4C, H and W divisible by win and 8, win*win <= 64, C/2 divisible by
// heads, the mixer plane within shared memory (checked by the Python
// wrapper). Weights: wqkv as lgteun_attention_fragments lays it out where
// attention_tc_takes(C/2, heads, win) and 4 % heads == 0, else [3C/2][C/2]
// (out, in); pos [heads][S][S]; the tail's as in lgteun_block_tail (TF32
// slabs of width tail_tc_width(C)); fft_tables: lgteun_fft_tables of (H,
// W). scratch: 3 * B * C/2 * H * W floats, and for C > 64 then one
// tail_h1_floats(128) slot an SM; counter: one int (zeroed by the
// kernel).
extern "C" int lgteun_lgb_block(
    const float* x, const float* ln_w, const float* ln_b, const float* amp_w,
    const float* amp_b, const float* pha_w, const float* pha_b,
    const float* fft_tables, const float* wqkv, const float* bqkv,
    const float* pos, const float* wpT, const float* bp, const float* fln_w,
    const float* fln_b, const float* w1T, const float* b1, const float* w2T,
    const float* b2, const float* dw, const float* bdw, const float* w3T,
    const float* b3,
    float* scratch, int* counter, float* out, int B, int C, int C4, int H,
    int W, int heads, int win, float scale, float eps, cudaStream_t stream) {
  LgbBlockArgs a;
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.amp_w = amp_w;
  a.amp_b = amp_b;
  a.pha_w = pha_w;
  a.pha_b = pha_b;
  a.fft_tab = fft_tables;
  a.wqkv = wqkv;
  a.bqkv = bqkv;
  a.pos = pos;
  a.tail = TailWeights{wpT, bp, fln_w, fln_b, w1T, b1, w2T, b2, dw, bdw,
                       w3T, b3};
  const size_t plane = (size_t)B * (C / 2) * H * W;
  a.y1 = scratch;
  a.x2 = scratch + plane;
  a.x1 = scratch + 2 * plane;
  a.h1 = scratch + 3 * plane;
  a.counter = counter;
  a.out = out;
  a.B = B;
  a.C = C;
  a.C4 = C4;
  a.H = H;
  a.W = W;
  a.heads = heads;
  a.win = win;
  a.scale = scale;
  a.eps = eps;
  const int cp = tail_tc_width(C);
  FftMixerPlan fft;
  if (!fft_mixer_plan(H, W, &fft) || !cp || C4 != 4 * C)
    return (int)cudaErrorInvalidValue;

  a.attn = -1;
  a.attn_w = (int)attn_wfrag_floats(C / 2, heads);
  if (attention_tc_takes(C / 2, heads, win) && 4 % heads == 0)
    for (int i = 0; i < 9; ++i)
      if (kAttnShapes[i][0] == attn_pad(C / 2 / heads) &&
          kAttnShapes[i][1] == attn_pad(C / 2))
        a.attn = i;
  const size_t attn_smem = a.attn >= 0
                               ? attention_tc_smem(C / 2, heads, 4)
                               : window_attention_smem(C / 2, heads, win);
  size_t smem = fft_mixer_smem(H, W);
  if (attn_smem > smem) smem = attn_smem;
  if (block_tail_tc_smem(cp) > smem) smem = block_tail_tc_smem(cp);
  a.smem_item = (int)((smem + 15) / 16 * 4);
  smem = sizeof(float) * (size_t)a.smem_item + 16;

  cudaError_t err = cudaFuncSetAttribute(
      lgb_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lgb_block_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the wide tile's h1: one slot an SM in the scratch
  if (cp == 128 && per_sm != 1) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)lgb_block_kernel,
                                    dim3(per_sm * sms), dim3(kThreads),
                                    params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
