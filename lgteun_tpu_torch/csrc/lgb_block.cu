// Whole LGB block in one launch for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/lgb_block_kernel.py::fused_lgb_block_cm
//           (Pallas `_kernel`), on [B, C, H, W]:
//
//   y  = LN(x);  x1 = window_MHSA(y[:C/2]);  x2 = global_mixer(y[C/2:])
//   xm = x + proj([x1; x2]);  out = xm + FFN(LN(xm))
//
// What bounds it here: the work of its three stages, as in B1-B3 (the
// FFN's products, the FFT's shared-memory stages, the window products);
// fusing saves only the launches and drains between them, not HBM
// traffic worth having: the TPU kernel kept a whole image in VMEM, while
// one H100 block holds at most 227 KB, a third of one image's
// activations at 128x128 / C = 32, and the intermediates y1, x2, x1 pass
// through the 50 MB L2. So the block wins only where each stage runs as
// well as its own kernel and the stages overlap.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md §6): 0.32 ms at 128^2/C32 and
// 0.24 at 64^2/C64 (batch 4), 1.42x and 1.15x the earlier grid-barrier
// design with the same bits, but still 1.12x / 1.18x the three kernels it
// fuses: its tail items alone run 1.17x B3, and its FFT planes run 1.5x
// slower while window items run on the other SMs.
//
// Design: a persistent cooperative kernel (every block resident), one
// 512-thread block an SM, that walks ONE work list handed out in order
// from an atomic counter. The list, its numbers computed by the wrapper
// (ops/lgb_block_kernel.py::lgb_schedule), is, image by image within
// each kind:
//   1. LN items: LN + split of ln_px pixels (y1, and y2 into x2), four
//      pixels a thread at once (ln_split_pixels);
//   2. plane items: the FFT mixer of one (image, channel) plane of x2 in
//      place (B1's half-spectrum body, a call of its own: mixer_plane);
//   3. window items: per_item (window, head) pairs of B2's tensor-core
//      body (window_attention_tc.cuh) where it takes the shape and 4 is
//      a multiple of the heads, else one window on the FP32-core body
//      (window_attention.cuh);
//   4. tail items: B3's tensor-core tile (block_tail.cuh), one 8x8 tile
//      with a 1-pixel halo an item; at C <= 32 each of the block's two
//      pairs of warpgroups takes tail items on its own (B3's own m64n32
//      layout, two tiles in flight an SM as B3's two blocks an SM have,
//      each with its shared memory and named barrier), at C <= 64 the
//      four warpgroups run one tile, above 64 the wide tile with its h1 in
//      block blockIdx.x's slot of the scratch.
// A block's items come in list order, so it walks the kinds in turn, one
// loop each (the window and tail loops picked by shape once).
//
// No grid barrier: each image has three counters in global memory, zeroed
// by the wrapper before the launch (LN items, planes and window items
// done). A block that ends an item releases it (__syncthreads, then one
// thread fence.acq_rel.gpu + red.add on its image's counter); a plane or
// a window item of image b first waits for b's LN items, a tail item for
// all of b's planes (the mixer is global over a plane) and window items,
// one thread spinning on ld.acquire.gpu, then __syncthreads. Scratch
// written in this launch is read through L2 (loads.cuh, kCoherent; the
// mixer's plane loads are __ldcg), never through __ldg. Before the tail,
// thread 0 keeps the block's next item reserved while it runs one (take).
//
// Why the list cannot deadlock: an item waits only for items of earlier
// kinds, which stand earlier in the list; the list is handed out in
// order; every block is resident (the cooperative launch makes it so);
// and a block (a pair of warpgroups, in the tail at C <= 32) runs one item
// at a time and holds at most one more, reserved, which it runs next. By
// induction on the index: item 0 waits for nothing and ends. If items 0
// .. n-1 end, item n is handed out (the blocks that held those come back
// for more), and if it is reserved, the item its block runs first is one
// of 0 .. n-1 and ends; everything item n waits for is among 0 .. n-1, so
// its block passes the wait and runs it to its end. This holds for any
// number of blocks: one block runs the list strictly in order (its pairs,
// in the tail, two items at a time), and a hang there would mean an item
// that waits for a later one. (A wait that outlasts kSpinLimit clocks
// traps, so a fault in the list ends the launch with an error instead of
// hanging the card.)
//
// Registers: __launch_bounds__(512, 1) gives a thread 128 registers,
// which the tail's tile takes as B3 does (B3 runs 128 a thread too), in a
// call of its own. B2's body needs 212-255: for the block's window items
// warpgroups 0-1 raise theirs to 232 with setmaxnreg while warpgroups 2-3
// drop to 24 and only keep step with the list's barriers ((232 + 24) x
// 256 = the 65,536 registers of the SM), as B2 runs two warpgroups an SM;
// after the window items all four return to 128. The launch checks that
// the kernel has exactly 128 registers a thread (the pool setmaxnreg
// shares out).
//
// An item's result does not depend on the block that takes it or on
// when: every item runs the same arithmetic on the same inputs, so the
// output is the same bit for bit for any grid size.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "block_tail.cuh"
#include "fft_mixer.cuh"
#include "window_attention.cuh"
#include "window_attention_tc.cuh"

// Clock stamps of each kind of work (thread 0 of each block), read by
// lgteun_read_lgb_stamps: only where LGTEUN_LGB_STAMPS (the blocks
// stamped) is defined, as scripts/torch_kernel_ab.py --b8-phases does.
// Kinds: 0 LN, 1 planes, 2 windows, 3 tails, 4 waits, 5 taking an item;
// then the count of each.
// (The bf16 unit, lgb_block_bf16.cu, is never stamped: its own copy of the
// array and of the reader would clash with this unit's at link time.)
#if defined(LGTEUN_LGB_STAMPS) && !defined(LGTEUN_BF16_UNIT)
__device__ long long lgteun_lgb_stamps[LGTEUN_LGB_STAMPS][12];
extern "C" int lgteun_read_lgb_stamps(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, lgteun_lgb_stamps,
                                   sizeof(lgteun_lgb_stamps));
}
// thread 0's clocks in shared memory, so that stamping takes no register
// from the bodies it measures
struct Stamps {
  long long* ph;  // [12], then the last stamp
  __device__ Stamps() {
    __shared__ long long st[13];
    ph = st;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 12; ++i) ph[i] = 0;
      ph[12] = clock64();
    }
  }
  __device__ void at(int i) {
    if (threadIdx.x == 0) {
      const long long n = clock64();
      ph[i] += n - ph[12];
      ph[6 + i] += 1;
      ph[12] = n;
    }
  }
  __device__ void end() const {
    if (threadIdx.x == 0 && blockIdx.x < LGTEUN_LGB_STAMPS)
      for (int i = 0; i < 12; ++i) lgteun_lgb_stamps[blockIdx.x][i] = ph[i];
  }
};
#else
struct Stamps {
  __device__ void at(int) {}
  __device__ void end() const {}
};
#endif

namespace {

constexpr int kThreads = 512;
static_assert(kThreads == kTcThreads, "the tail's tile at C > 32");
// pixels a thread normalises at once in an LN item (their loads overlap)
constexpr int kLnPx = 4;
// The attention's warpgroups in a window item, raised to kAttnRegs
// registers by setmaxnreg while the other two drop to kIdleRegs.
constexpr int kAttnWG = 2, kAttnRegs = 232, kIdleRegs = 24;
static_assert(2 * kAttnRegs + 2 * kIdleRegs == 4 * 128,
              "the register file of one 512-thread block an SM");

// LGTEUN_LGB_ONLY (a measurement, scripts/torch_kernel_ab.py --b8-phases
// --b8-only): 1 runs the LN and plane items alone, 2 the tail items alone
// (on whatever the scratch holds); the other items are taken and counted
// done at once. Not defined: the whole block.
#ifndef LGTEUN_LGB_ONLY
#define LGTEUN_LGB_ONLY 0
#endif
constexpr bool kRunPlanes = LGTEUN_LGB_ONLY != 2;
constexpr bool kRunWindows = LGTEUN_LGB_ONLY == 0;
constexpr bool kRunTails = LGTEUN_LGB_ONLY != 1;

// The work list's numbers (ops/lgb_block_kernel.py::lgb_schedule): items
// of each kind an image (a tail item is one tile), pixels an LN item, the
// (window, head) pairs (or windows) of an image, and pairs a window item
// (1 on the FP32-core body).
struct LgbSchedule {
  int ln, planes, windows, tails, ln_px, pairs, per_item;
};

// TX: the storage type of x and out (loads.cuh); the scratch is float.
template <class TX>
struct LgbBlockArgs {
  const TX* x;
  const float *ln_w, *ln_b, *amp_w, *amp_b, *pha_w, *pha_b;
  const float* fft_tab;  // the mixer's tables (lgteun_fft_tables)
  const float *wqkv, *bqkv, *pos;
  TailWeights tail;
  float *y1, *x2, *x1;  // scratch, [B, C/2, H, W] each
  float* h1;            // scratch: the wide tile's h1 slots, one a block
  int* counters;        // the list's head, then LN, planes, windows done
                        // [B] each (counter())
  int attn;             // the tensor-core attention's shape, -1: FP32 core
  int attn_w;           // floats of its weight fragments
  TX* out;
  int B, C, H, W, heads, win;
  float scale, eps;
  int tile_floats;      // floats of one tail tile's shared memory
  int smem_item;        // float offset of the shared work-item slot
  LgbSchedule s;
};

// The tensor-core attention's (HDP, CP) shapes, indexed by
// LgbBlockArgs::attn.
constexpr int kAttnShapes[][2] = {{8, 8},   {8, 16},  {8, 32},
                                  {8, 64},  {16, 16}, {16, 32},
                                  {16, 64}, {32, 32}, {32, 64}};

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The counters, each on a 128-byte line of its own (the spinning loads of
// one do not queue behind the atomics of another): k = 0 the list's head,
// 1 + b image b's LN items done, 1 + B + b its planes, 1 + 2B + b its
// window items.
constexpr int kCounterPad = 32;
template <class TX>
__device__ __forceinline__ int* counter(const LgbBlockArgs<TX>& a, int k) {
  return a.counters + k * kCounterPad;
}

// The block's writes of an item, made visible before counter c counts it.
__device__ __forceinline__ void release(int* c) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "red.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(c)
        : "memory");
}

// Clocks a wait may take before it traps (about 5 s at the H100's 1.98
// GHz): far beyond any item, so only a fault in the list reaches it.
constexpr long long kSpinLimit = 10000000000LL;

__device__ __forceinline__ void spin(const int* c, int n) {
  const long long t0 = clock64();
  while (load_acquire(c) < n) {
    __nanosleep(64);
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// Wait until *c >= n (and *d >= m), then the whole block goes on.
__device__ __forceinline__ void wait_for(const int* c, int n,
                                        const int* d = nullptr, int m = 0) {
  if (threadIdx.x == 0) {
    spin(c, n);
    if (d) spin(d, m);
  }
  __syncthreads();
}

// Named barrier 7 (0: __syncthreads, 1-4: the attention's warpgroups,
// 5-6: the tail's pairs): warpgroups 0-1 arrive once they have given
// their raised registers back, 2-3 wait for that.
__device__ __forceinline__ void idle_barrier(bool arrive) {
  if (arrive)
    asm volatile("bar.arrive 7, 512;\n" ::: "memory");
  else
    asm volatile("bar.sync 7, 512;\n" ::: "memory");
}

// The mixer of one plane in place, as a call of its own: inlined, its
// passes shared one register allocation with the window attention and the
// tail, and ptxas spilled more of both. TO: float, or Bf16InF32 where the
// branches are rounded (the plane read as float, written rounded).
template <class TO>
__device__ __noinline__ void mixer_plane(float* plane, float2* sm,
                                         const float* tab, float aw,
                                         float ab, float pw, float pb) {
  fft_mixer_plane(static_cast<const float*>(plane),
                  reinterpret_cast<TO*>(plane), sm, tab, aw, ab, pw, pb);
}

// The storage of the branch tensors y1, x2, x1 in the scratch: float, or,
// with kRound, float slots holding bf16-rounded values, so that level 3
// rounds where level 2 stores bf16 (loads.cuh).
template <bool kRound>
using Branch = std::conditional_t<kRound, Bf16InF32, float>;

// The next item of the list, for every thread of the block. Before the
// tail, thread 0 keeps the item after it reserved (`pre`; -1: none), so
// that the atomic's round trip overlaps the item's work; tail items are
// taken when wanted (one reserved ahead there could keep a tile waiting
// for its block at the end of the list while other blocks idle).
__device__ __forceinline__ int take(int* slot, int* head, int& pre,
                                    int e_win) {
  if (threadIdx.x == 0) {
    const int it = pre >= 0 ? pre : atomicAdd(head, 1);
    pre = it < e_win ? atomicAdd(head, 1) : -1;
    *slot = it;
  }
  __syncthreads();
  const int it = *slot;
  __syncthreads();
  return it;
}

// The window items from `it` on (every block's items come in list order)
// on the FP32-core body, one window an item on the whole block: returns
// the first item after them.
template <class TX, bool kRound>
__device__ __forceinline__ int window_items_fp32(const LgbBlockArgs<TX>& a,
                                                 float* sm, int* slot,
                                                 int& pre, int it, int e_pl,
                                                 int e_win, Stamps& st) {
  for (; it < e_win; it = take(slot, counter(a, 0), pre, e_win)) {
    st.at(5);
    const int i = it - e_pl, b = i / a.s.windows, j = i % a.s.windows;
    wait_for(counter(a, 1 + b), a.s.ln);
    st.at(4);
    if (kRunWindows)
      window_attention_window<true>(
          static_cast<const float*>(a.y1), a.wqkv, a.bqkv, a.pos,
          reinterpret_cast<Branch<kRound>*>(a.x1), sm, a.C / 2, a.H, a.W,
          a.heads, a.win, a.scale, b, j);
    st.at(2);
    release(counter(a, 1 + 2 * a.B + b));
  }
  return it;
}

// The same on B2's tensor-core body (HDP, CP: its padded widths).
template <int HDP, int CP, class TX, bool kRound>
__device__ __forceinline__ int window_items(const LgbBlockArgs<TX>& a,
                                            float* sm,
                                            int* slot, int& pre, int it,
                                            int e_pl, int e_win, Stamps& st) {
  if (it >= e_win) return it;
  // the weights stay in shared memory: no plane comes after a window
  attention_load_weights(sm, a.wqkv, a.attn_w);
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg < kAttnWG) {
    // B2's body on warpgroups 0-1 with their registers raised for the
    // whole of the block's window items (2-3 give theirs up meanwhile and
    // only keep step with the list's barriers). Item j of image b holds
    // pairs per_item j ..; pair p: window p / heads, head p % heads;
    // warpgroup wg takes pairs j per_item + wg, + kAttnWG, ... and so
    // keeps one head where 2 % heads == 0, its position bias loaded once.
    regs_inc<kAttnRegs>();
    const int C2 = a.C / 2, nwin = (a.H / 8) * (a.W / 8), n = a.s.per_item;
    const bool fixed = kAttnWG % a.heads == 0;
    float* kv = sm + a.attn_w + wg * 4 * kAttnS * HDP;
    float pos[8][4];
    if (fixed) attention_pos(pos, a.pos, wg % a.heads);
    for (; it < e_win; it = take(slot, counter(a, 0), pre, e_win)) {
      st.at(5);
      const int i = it - e_pl, b = i / a.s.windows, j = i % a.s.windows;
      wait_for(counter(a, 1 + b), a.s.ln);
      st.at(4);
      for (int p = j * n + wg; kRunWindows && p < min(a.s.pairs, (j + 1) * n);
           p += kAttnWG) {
        if (!fixed) attention_pos(pos, a.pos, p % a.heads);
        window_attention_head_tc<HDP, CP, true>(
            static_cast<const float*>(a.y1), sm, a.bqkv,
            reinterpret_cast<Branch<kRound>*>(a.x1), kv, pos, C2,
            C2 / a.heads, p % a.heads,
            a.scale, ImageWindow::of(b * nwin + p / a.heads, C2, a.H, a.W, 8),
            wg);
      }
      st.at(2);
      release(counter(a, 1 + 2 * a.B + b));
    }
    regs_dec<128>();
    idle_barrier(true);
  } else {
    regs_dec<kIdleRegs>();
    for (; it < e_win; it = take(slot, counter(a, 0), pre, e_win)) {
      __syncthreads();  // wait_for's barrier
      __syncthreads();  // release's
    }
    // take 128 back only once warpgroups 0-1 have returned theirs: asked
    // for earlier, they could take back what 0-1 wait for, and neither
    // side would go on
    idle_barrier(false);
    regs_inc<128>();
  }
  return it;
}

// A tile as a call of its own: inlined, it shared one register
// allocation with the values that live through the tail loop, and ptxas
// spilled inside it (1.04-1.10x slower at 128^2/C32 and 64^2/C64).
template <int kNT, int kWG, class Group, class TX>
__device__ __noinline__ void tail_tile(const TX* x, const float* x1,
                                       const float* x2, TailWeights wt,
                                       TX* out, float* sm, float* h1,
                                       int C, int H, int W, float eps, int b,
                                       int t) {
  if (kRunTails)
    block_tail_tile_tc<kNT, true, false, true, kWG, Group>(
        x, x1, x2, nullptr, wt, out, sm, h1, C, H, W, eps, b, t);
}

// The next item of the list for one pair of warpgroups (the tail at C <=
// 32), in its own slot.
__device__ __forceinline__ int take_pair(int* slot, int* head) {
  if (TilePair::tid() == 0) *slot = atomicAdd(head, 1);
  TilePair::sync();
  const int it = *slot;
  TilePair::sync();
  return it;
}

// The tail items (one tile each) from `it` to the end of the list, on
// tiles of padded width 16 kNT. At kNT = 2 the block's two pairs of
// warpgroups take tiles on their own, each with its shared memory, its
// item slot and its barrier (two tiles in flight an SM, as B3's two
// blocks an SM, and out of step as they are): pair 0 runs `it`, pair 1
// takes the next. Else the block runs tile after tile on its four
// warpgroups (the wide tile, kNT = 8, with its h1 in this block's slot of
// the scratch).
template <int kNT, class TX>
__device__ __forceinline__ void tail_items(const LgbBlockArgs<TX>& a,
                                           float* sm,
                                           int* slot, int it, int e_win,
                                           int items, Stamps& st) {
  if constexpr (kNT == 2) {
    const int pair = threadIdx.x >> 8;
    int* pslot = slot + 1 + pair;
    float* psm = sm + pair * a.tile_floats;
    if (pair == 1) it = take_pair(pslot, counter(a, 0));
    for (; it < items; it = take_pair(pslot, counter(a, 0))) {
      st.at(5);
      const int i = it - e_win, b = i / a.s.tails, t = i % a.s.tails;
      if (TilePair::tid() == 0) {
        spin(counter(a, 1 + a.B + b), a.s.planes);
        spin(counter(a, 1 + 2 * a.B + b), a.s.windows);
      }
      TilePair::sync();
      st.at(4);
      tail_tile<2, 2, TilePair>(a.x, static_cast<const float*>(a.x1),
                                static_cast<const float*>(a.x2), a.tail,
                                a.out, psm, nullptr, a.C, a.H, a.W, a.eps, b,
                                t);
      st.at(3);
    }
  } else {
    int pre = -1;
    for (; it < items; it = take(slot, counter(a, 0), pre, e_win)) {
      st.at(5);
      const int i = it - e_win, b = i / a.s.tails, t = i % a.s.tails;
      wait_for(counter(a, 1 + a.B + b), a.s.planes,
               counter(a, 1 + 2 * a.B + b), a.s.windows);
      st.at(4);
      tail_tile<kNT, 4, TileBlock>(
          a.x, static_cast<const float*>(a.x1),
          static_cast<const float*>(a.x2), a.tail, a.out, sm,
          kNT == 8 ? a.h1 + blockIdx.x * tail_h1_floats(128) : nullptr, a.C,
          a.H, a.W, a.eps, b, t);
      st.at(3);
    }
  }
}

// A block's items come in list order, so it walks the kinds in turn, one
// loop each, and the window and tail loops are picked by shape once: what
// the compiler keeps for one loop is not held through the others'. TX: the
// storage type of x and out; kRound: y1, x2 and x1 rounded to bf16 as
// stored (Branch).
template <class TX, bool kRound>
__global__ void __launch_bounds__(kThreads, 1)
lgb_block_kernel(LgbBlockArgs<TX> a) {
  Branch<kRound>* y1 = reinterpret_cast<Branch<kRound>*>(a.y1);
  extern __shared__ __align__(16) float sm[];
  int* slot = reinterpret_cast<int*>(sm + a.smem_item);
  Stamps st;
  const int HW = a.H * a.W;
  const int e_ln = a.B * a.s.ln, e_pl = e_ln + a.B * a.s.planes;
  const int e_win = e_pl + a.B * a.s.windows, items = e_win + a.B * a.s.tails;
  int pre = -1;  // thread 0's reserved next item
  int it = take(slot, counter(a, 0), pre, e_win);
  // LN + split
  for (; it < e_ln; it = take(slot, counter(a, 0), pre, e_win)) {
    st.at(5);
    const int b = it / a.s.ln, p0 = (it % a.s.ln) * a.s.ln_px;
    const int p1 = min(HW, p0 + a.s.ln_px);
    for (int p = p0 + threadIdx.x; p < p1 && kRunPlanes; p += kLnPx * kThreads)
      if (a.s.ln_px <= kThreads)  // one pixel a thread
        ln_split_pixels<1>(a.x, a.ln_w, a.ln_b, y1, a.x2, a.C, HW, b, p,
                           kThreads, p1, a.eps);
      else
        ln_split_pixels<kLnPx>(a.x, a.ln_w, a.ln_b, y1, a.x2, a.C, HW, b,
                               p, kThreads, p1, a.eps);
    st.at(0);
    release(counter(a, 1 + b));
  }
  // the mixer of plane c of image b
  for (; it < e_pl; it = take(slot, counter(a, 0), pre, e_win)) {
    st.at(5);
    const int i = it - e_ln, b = i / a.s.planes, c = i % a.s.planes;
    wait_for(counter(a, 1 + b), a.s.ln);
    st.at(4);
    if (kRunPlanes)
      mixer_plane<Branch<kRound>>(a.x2 + (size_t)i * HW,
                                  reinterpret_cast<float2*>(sm),
                  a.fft_tab, a.amp_w[c], a.amp_b[c], a.pha_w[c], a.pha_b[c]);
    st.at(1);
    release(counter(a, 1 + a.B + b));
  }
  switch (a.attn) {
#define LGTEUN_SHAPE(i)                                                      \
  case i:                                                                    \
    it = window_items<kAttnShapes[i][0], kAttnShapes[i][1], TX, kRound>( \
        a, sm, slot, pre, it, e_pl, e_win, st);                          \
    break;
    LGTEUN_SHAPE(0) LGTEUN_SHAPE(1) LGTEUN_SHAPE(2) LGTEUN_SHAPE(3)
    LGTEUN_SHAPE(4) LGTEUN_SHAPE(5) LGTEUN_SHAPE(6) LGTEUN_SHAPE(7)
    LGTEUN_SHAPE(8)
#undef LGTEUN_SHAPE
    default:
      it = window_items_fp32<TX, kRound>(a, sm, slot, pre, it, e_pl, e_win,
                                         st);
  }
  if (a.C <= 32)
    tail_items<2>(a, sm, slot, it, e_win, items, st);
  else if (a.C <= 64)
    tail_items<4>(a, sm, slot, it, e_win, items, st);
  else
    tail_items<8>(a, sm, slot, it, e_win, items, st);
  st.end();
}

}  // namespace

namespace {

// out = one LGB block of x, both [B, C, H, W] of storage type TX (with
// kRound, y1, x2 and x1 rounded to bf16 where level 2 stores them). C % 4
// == 0, C <= 128, C4 = 4C, H and W divisible by win and 8, win*win <= 64,
// C/2 divisible by heads, the mixer plane within shared memory (checked by
// the Python wrapper). Weights: wqkv as lgteun_attention_fragments lays it out where
// attention_tc_takes(C/2, heads, win) and 4 % heads == 0, else [3C/2][C/2]
// (out, in); pos [heads][S][S]; the tail's as in lgteun_block_tail (TF32
// slabs of width tail_tc_width(C)); fft_tables: lgteun_fft_tables of (H,
// W). scratch: 3 * B * C/2 * H * W floats, and for C > 64 then one
// tail_h1_floats(128) slot an SM; counters: (1 + 3B) x 32 ints, zero at
// the launch; sched: the work list's 7 numbers in host memory (LgbSchedule,
// lgb_schedule), checked here; blocks: the grid (0: every block that
// fits, one an SM; fewer only to exercise the work list).
template <class TX, bool kRound>
int launch_lgb_block(
    const TX* x, const float* ln_w, const float* ln_b, const float* amp_w,
    const float* amp_b, const float* pha_w, const float* pha_b,
    const float* fft_tables, const float* wqkv, const float* bqkv,
    const float* pos, const float* wpT, const float* bp, const float* fln_w,
    const float* fln_b, const float* w1T, const float* b1, const float* w2T,
    const float* b2, const float* dw, const float* bdw, const float* w3T,
    const float* b3, float* scratch, int* counters, TX* out, int B, int C,
    int C4, int H, int W, int heads, int win, const int* sched, int blocks,
    float scale, float eps, cudaStream_t stream) {
  LgbBlockArgs<TX> a;
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
  a.counters = counters;
  a.out = out;
  a.B = B;
  a.C = C;
  a.H = H;
  a.W = W;
  a.heads = heads;
  a.win = win;
  a.scale = scale;
  a.eps = eps;
  const int cp = tail_tc_width(C);
  // B8's planes: even sides, prime factors at most kFftMaxPrime (odd
  // sides and the line buffer run level 2's chain, lgb_route)
  FftMixerPlan fft;
  if (!fft_mixer_plan(H, W, &fft) || H % 2 || W % 2 ||
      fft_mixer_gbuf(fft) || !cp || C4 != 4 * C || blocks < 0)
    return (int)cudaErrorInvalidValue;

  a.attn = -1;
  a.attn_w = (int)attn_wfrag_floats(C / 2, heads);
  if (attention_tc_takes(C / 2, heads, win) && 4 % heads == 0)
    for (int i = 0; i < 9; ++i)
      if (kAttnShapes[i][0] == attn_pad(C / 2 / heads) &&
          kAttnShapes[i][1] == attn_pad(C / 2))
        a.attn = i;

  // the work list as the wrapper computed it, held to the shapes
  const LgbSchedule s{sched[0], sched[1], sched[2], sched[3],
                      sched[4], sched[5], sched[6]};
  const int nwin = (H / win) * (W / win);
  const int pairs = a.attn >= 0 ? nwin * heads : nwin;
  if (s.ln_px < 1 || s.ln != (H * W + s.ln_px - 1) / s.ln_px ||
      s.planes != C / 2 || s.pairs != pairs || s.per_item < 1 ||
      (a.attn < 0 ? s.per_item != 1 : s.per_item % kAttnWG != 0) ||
      s.windows != (pairs + s.per_item - 1) / s.per_item ||
      s.tails != (H / 8) * (W / 8))
    return (int)cudaErrorInvalidValue;
  a.s = s;

  const size_t attn_smem = a.attn >= 0
                               ? attention_tc_smem(C / 2, heads, kAttnWG)
                               : window_attention_smem(C / 2, heads, win);
  // each tile's shared memory on a 1 KB boundary, as a block's own is
  const size_t tile = (block_tail_tc_smem(cp) + 1023) / 1024 * 1024;
  a.tile_floats = (int)(tile / sizeof(float));
  size_t smem = fft_mixer_smem(H, W);
  if (attn_smem > smem) smem = attn_smem;
  const int group = cp == 32 ? 2 : 1;  // tiles in flight a block
  if (group * tile > smem) smem = group * tile;
  a.smem_item = (int)((smem + 15) / 16 * 4);
  smem = sizeof(float) * (size_t)a.smem_item + 16;

  cudaError_t err = cudaFuncSetAttribute(
      lgb_block_kernel<TX, kRound>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
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
           &per_sm, lgb_block_kernel<TX, kRound>, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  // one block an SM with 128 registers a thread: the attention's
  // setmaxnreg shares out exactly those 65,536, and the wide tile's h1
  // slots (one an SM in the scratch) count on it too
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, lgb_block_kernel<TX, kRound>)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm != 1 || (kRunWindows && fa.numRegs != 128))
    return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) blocks = sms;
  if (blocks > sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)lgb_block_kernel<TX, kRound>,
                                    dim3(blocks),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef LGTEUN_BF16_UNIT
// out = one LGB block of x, both [B, C, H, W]. C % 4 == 0, C <= 128, C4 =
// 4C, H and W divisible by win and 8, win*win <= 64, C/2 divisible by
// heads, the mixer plane within shared memory (checked by the Python
// wrapper). Arguments: see launch_lgb_block.
extern "C" int lgteun_lgb_block(
    const float* x, const float* ln_w, const float* ln_b, const float* amp_w,
    const float* amp_b, const float* pha_w, const float* pha_b,
    const float* fft_tables, const float* wqkv, const float* bqkv,
    const float* pos, const float* wpT, const float* bp, const float* fln_w,
    const float* fln_b, const float* w1T, const float* b1, const float* w2T,
    const float* b2, const float* dw, const float* bdw, const float* w3T,
    const float* b3, float* scratch, int* counters, float* out, int B, int C,
    int C4, int H, int W, int heads, int win, const int* sched, int blocks,
    float scale, float eps, cudaStream_t stream) {
  return launch_lgb_block<float, false>(
      x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b, fft_tables, wqkv, bqkv, pos,
      wpT, bp, fln_w, fln_b, w1T, b1, w2T, b2, dw, bdw, w3T, b3, scratch,
      counters, out, B, C, C4, H, W, heads, win, sched, blocks, scale, eps,
      stream);
}

// The arguments lgteun_lgb_block takes: 2, the work list's numbers in
// host memory, zeroed counters and a block count after `win` (earlier
// versions, without this entry: one counter the kernel zeroed itself).
extern "C" int lgteun_lgb_block_layout() { return 2; }
#else  // LGTEUN_BF16_UNIT: lgb_block_bf16.cu

// The bf16 storage entry (LGTEUN_EVAL_DTYPE, loads.cuh): the arguments of
// lgteun_lgb_block, x and out float (x_bf16 0) or __nv_bfloat16 (1); y1,
// x2 and x1 rounded to bf16 in the scratch as level 2 stores them, so that
// the block computes level 2's function in either storage mode.
extern "C" int lgteun_lgb_block_bf16(
    const void* x, const float* ln_w, const float* ln_b, const float* amp_w,
    const float* amp_b, const float* pha_w, const float* pha_b,
    const float* fft_tables, const float* wqkv, const float* bqkv,
    const float* pos, const float* wpT, const float* bp, const float* fln_w,
    const float* fln_b, const float* w1T, const float* b1, const float* w2T,
    const float* b2, const float* dw, const float* bdw, const float* w3T,
    const float* b3, float* scratch, int* counters, void* out, int B, int C,
    int C4, int H, int W, int heads, int win, const int* sched, int blocks,
    int x_bf16, float scale, float eps, cudaStream_t stream) {
  if (x_bf16)
    return launch_lgb_block<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(x), ln_w, ln_b, amp_w, amp_b,
        pha_w, pha_b, fft_tables, wqkv, bqkv, pos, wpT, bp, fln_w, fln_b,
        w1T, b1, w2T, b2, dw, bdw, w3T, b3, scratch, counters,
        static_cast<__nv_bfloat16*>(out), B, C, C4, H, W, heads, win, sched,
        blocks, scale, eps, stream);
  return launch_lgb_block<float, true>(
      static_cast<const float*>(x), ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
      fft_tables, wqkv, bqkv, pos, wpT, bp, fln_w, fln_b, w1T, b1, w2T, b2,
      dw, bdw, w3T, b3, scratch, counters, static_cast<float*>(out), B, C,
      C4, H, W, heads, win, sched, blocks, scale, eps, stream);
}
#endif  // LGTEUN_BF16_UNIT
