// Device code shared by block_tail.cu (B3, masked B3, B5) and
// lgb_block.cu (B8's tail items): one 8x8 output tile of
//
//   xm  = x + M * (Wp . [x1; x2] + bp)            (kProj; else xm = x;
//                                                  M = 1 unless kMask)
//   out = xm + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(xm) + b1) + b2) + bdw) + b3
//
// with a 1-pixel halo (10x10 = 100 pixels). proj -> LN -> W1 -> GELU -> W2
// are recomputed on the halo pixels (as the TPU kernels recompute their
// halo rows), so no intermediate leaves the block. The out-of-image halo
// of h2 is zeroed after W2, before the depthwise taps: the zero padding
// applies to the conv's input. Exact-erf GELU. With kMask the dropout mask
// M [B, C, H, W] is read at the halo pixels too (the halo's xm feeds the
// depthwise taps of the interior).
//
// The four 1x1 products run on the tensor cores as wgmma m64nNk8 TF32,
// FP32-accurate through the 3xTF32 split (tc_tf32.cuh), on kWG
// warpgroups (4, or 2 for B3 / B5 and B8's pairs at CP = 32). Pixels
// are the rows (M): the 100 halo pixels padded to 128 (2 x m64); for
// proj, W1 and W2 warpgroup g takes rows 64 (g % 2) .. and part g / 2 of
// the output channels of each CP-wide chunk (m64n32 with 2 warpgroups or
// at CP = 64, m64n16 with 4 at CP = 32, m64n64 at CP = 128), for W3 the
// 64 interior rows and part g of the output channels. Rows 112-127 hold
// no buffer: the warp that owns them gives zeros as its A fragments and
// stores nothing. The channels are padded to CP = 32 (C <= 32), 64 (C <=
// 64) or 128 (C <= 128, the wide tile: h1 in a global scratch slot of
// the block, see tail_wide), the hidden width to 4 CP (zero weights and
// biases, so the padded channels stay zero). A comes from registers, split into hi/lo TF32 parts as
// each warp loads its fragments from shared memory; B, the weights, comes
// pre-split (ops/ffn_kernel.py::tail_fragments) as slabs of CP output
// channels x 32 input channels (hi, then lo, each in wgmma's K-major
// core-matrix layout), streamed through a cp.async ring in shared memory
// (tail_ring) in the order the products consume them: one global read per
// block, shared by all its warps. W2 -> depthwise -> GELU -> W3 run by
// chunks of CP hidden channels, so that h2 is never held whole: h2[:,
// chunk] on the halo, the taps on the interior, and W3[:, chunk] . g
// added into an accumulator the W3 warps keep in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "loads.cuh"
#include "tc_tf32.cuh"

namespace {

constexpr int kTailT = 8;                 // output tile edge
constexpr int kTailHT = kTailT + 2;       // halo tile edge
constexpr int kTailNP = kTailHT * kTailHT;  // halo pixels
constexpr int kTailNI = kTailT * kTailT;    // interior pixels

constexpr int kTcThreads = 512;                 // 4 warpgroups (B8's)
constexpr int kTcRows = 112;                    // buffer rows (kTailNP
                                                // padded to m16)
constexpr int kSlabK = 32;                      // input channels a slab
// the slabs' core matrices (8 output channels x 4 input channels, 128
// bytes): the next 4 input channels 128 bytes on, the next 8 output
// channels 8 core matrices (1024 bytes) on
constexpr uint32_t kCoreK = 128, kCoreN = 1024;
// Weight slabs in the cp.async ring of a tile of padded width CP: the
// next slab is fetched while the current one is used, and at CP = 64,
// where W2's products run one slab behind its A loads, the one before is
// still being read. (Fetching two slabs ahead measured no faster at CP =
// 32 and 3 % faster at 64, and needs a slab more; PERF.md §6.)
__host__ __device__ constexpr int tail_ring(int CP) {
  return CP == 64 ? 3 : 2;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// Padded channel width of the tile for C channels: 32, 64 or, for the
// wide tile, 128 (0: C > 128, which no tile takes).
inline int tail_tc_width(int C) {
  return C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : 0;
}

// The wide tile (CP = 128): h1 [112][4CP+4] (229 KB) no longer fits in
// shared memory beside the other buffers, so it lives in a global
// scratch slot of its block (read back through L1/L2), and the rest of
// the tile stays in shared memory.
__host__ __device__ constexpr bool tail_wide(int CP) { return CP > 64; }

// Floats of h1 [112][4CP+4]: the wide tile's global scratch slot.
__host__ __device__ constexpr size_t tail_h1_floats(int CP) {
  return (size_t)kTcRows * (4 * CP + 4);
}

// Shared memory (bytes) of one tile of padded width CP: tail_ring(CP)
// weight slabs of 64 CP floats (first, so that wgmma's core matrices are
// aligned); h1 [112][4CP+4] (early: xm, [x1;x2] and the mask,
// [112][CP+4] each; the wide tile's is in global memory); yln
// [112][CP+4], later the chunk's h2 [100][CP+4] and g [64][CP+4]; the
// interior xm [64][CP+4]. 106 KB at CP = 32 (two blocks an SM), 222 KB at
// 64, 182 KB at 128.
inline size_t block_tail_tc_smem(int CP) {
  const size_t ldc = CP + 4;
  return sizeof(float) * (tail_ring(CP) * (size_t)64 * CP +
                          (tail_wide(CP) ? 0 : tail_h1_floats(CP)) +
                          (kTailNP + kTailNI) * ldc + kTailNI * ldc);
}

// Weights of the tail; wpT/bp are read only with kProj. Matrices as TF32
// slabs (tail_fragments); vectors as [C] / [4C]; dw as [4C][3][3].
struct TailWeights {
  const float *wpT, *bp, *ln_w, *ln_b, *w1T, *b1, *w2T, *b2, *dw, *bdw,
      *w3T, *b3;
};

// A fragments of one slab (32 input channels, 4 k-steps of 8) of a
// warp's 16 rows, split into TF32 hi/lo parts.
struct AFrag {
  uint32_t hi[kSlabK / 8][4], lo[kSlabK / 8][4];
};

// f = A[arow ..][k0 : k0 + 32] in fragment order. A: FP32 in shared
// memory, row stride lda (lda % 32 == 4: the fragment loads hit 32 banks);
// zeros where !live. All loads are made before the first split, so that
// their latencies overlap.
__device__ __forceinline__ void load_a(AFrag& f, const float* A, int lda,
                                       int arow, bool live, int k0) {
  constexpr int KS = kSlabK / 8;
  const int lane = threadIdx.x & 31;
  if (!live) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) f.hi[ks][q] = f.lo[ks][q] = 0u;
    return;
  }
  const float* r0 = A + (arow + (lane >> 2)) * lda + k0 + (lane & 3);
  const float* r1 = r0 + 8 * lda;
  float v[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    v[ks][0] = r0[8 * ks];
    v[ks][1] = r1[8 * ks];
    v[ks][2] = r0[8 * ks + 4];
    v[ks][3] = r1[8 * ks + 4];
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f.hi[ks][q] = tf32_rna(v[ks][q]);
      f.lo[ks][q] = tf32_rna(v[ks][q] - __uint_as_float(f.hi[ks][q]));
    }
}

// acc (the warpgroup's 64 x 8 NJ tile) += f . slab[n0 .. n0 + 8 NJ][0 :
// 32]^T, FP32-accurate (3xTF32): twelve wgmma issued back to back as one
// committed group, not waited for. slab: hi then lo, [CP / 8 n-groups][8
// k-quads][8][4] each.
template <int NJ, int CP>
__device__ __forceinline__ void issue_slab(float (&acc)[NJ][4],
                                           const AFrag& f, const float* slab,
                                           int n0) {
  const float* bhi = slab + (n0 / 8) * (kCoreN / 4);
  const float* blo = bhi + CP * kSlabK;
  wgmma_fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSlabK / 8; ++ks) {
    const uint64_t dh = wgmma_desc(bhi + ks * (2 * kCoreK / 4), kCoreK,
                                   kCoreN);
    const uint64_t dl = wgmma_desc(blo + ks * (2 * kCoreK / 4), kCoreK,
                                   kCoreN);
    wgmma_tf32(acc, f.lo[ks], dh);
    wgmma_tf32(acc, f.hi[ks], dl);
    wgmma_tf32(acc, f.hi[ks], dh);
  }
  wgmma_commit();
}

// The same for A[arow ..][k0 : k0 + 32], loaded, issued and waited for.
template <int NJ, int CP>
__device__ __forceinline__ void wgmma_slab(float (&acc)[NJ][4],
                                           const float* A, int lda, int arow,
                                           bool live, int k0,
                                           const float* slab, int n0) {
  AFrag f;
  load_a(f, A, lda, arow, live, k0);
  issue_slab<NJ, CP>(acc, f, slab, n0);
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
}

// f(row, column, value) for each element of a warp's accumulator of the
// warpgroup's 64 x 8 NJ tile (tc_tf32.cuh: wgmma_tf32), whose 16 rows
// start at row0 and columns at n0.
template <int NJ, class F>
__device__ __forceinline__ void each_frag(const float (&acc)[NJ][4], int row0,
                                          int n0, F&& f) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      f(row0 + gq + (q >> 1) * 8, n0 + j * 8 + 2 * tq + (q & 1), acc[j][q]);
}

// The threads that run one tile and their barrier: the whole block (B3,
// B5, and B8 at C > 32), or one of the two pairs of warpgroups of a
// 512-thread block (B8 at C <= 32, two tiles in flight a block as B3 has
// two blocks an SM), each pair with a named barrier of its own (5 and 6:
// 0 is __syncthreads, 1-4 the attention's warpgroups).
struct TileBlock {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
};
struct TilePair {
  __device__ static int tid() { return threadIdx.x & 255; }
  __device__ static void sync() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(5 + (threadIdx.x >> 8))
                 : "memory");
  }
};

// Tile ti of image b (kNT = CP / 16). x/out [B, C, H, W], both of storage
// type TX; x1/x2 [B, C/2, H, W] (kProj), of storage type TB (loads.cuh:
// upcast as loaded, out rounded once as stored); mask [B, C, H, W]
// (kMask, float); kCoherent: see loads.cuh (x, the block's input, is read
// through __ldg in every caller).
// wt's matrices are TF32 slabs (wpT [1][CP/32 slabs], w1T [4][CP/32],
// w2T [4][4CP/32], w3T [1][4CP/32]); vectors as given ([C], [4C]); dw
// [4C][3][3]. 128 kWG threads; sm holds block_tail_tc_smem(CP) bytes,
// 16-byte aligned; h1g: the wide tile's h1 slot (tail_h1_floats(CP),
// this block's alone; unused below CP = 128). Group: the threads that run
// the tile (TileBlock, or TilePair with kWG = 2).
template <int kNT, bool kProj, bool kMask, bool kCoherent = false,
          int kWG = 4, class Group = TileBlock, class TX, class TB>
__device__ __forceinline__ void block_tail_tile_tc(
    const TX* __restrict__ x, const TB* __restrict__ x1,
    const TB* __restrict__ x2, const float* __restrict__ mask,
    const TailWeights& wt, TX* __restrict__ out, float* sm, float* h1g,
    int C, int H, int W, float eps, int b, int ti) {
  constexpr int CP = 16 * kNT, HP = 4 * CP;
  constexpr int kThreads = 128 * kWG;
  constexpr int NH = 2 * CP / kWG, N3W = CP / kWG;  // outputs a warpgroup:
  constexpr int NJ = NH / 8, NJ3 = N3W / 8;         // halo, W3
  constexpr int kRing = tail_ring(CP);
  constexpr bool kPipe = CP == 64;               // W2 one slab behind
  constexpr int LDC = CP + 4, LDH = HP + 4;
  constexpr int SLAB = 2 * CP * kSlabK;          // floats
  constexpr int NP = kProj ? CP / kSlabK : 0;    // slabs: proj,
  constexpr int N1 = 4 * (CP / kSlabK);          // W1,
  constexpr int N2 = HP / kSlabK;                // W2 and W3 a hidden chunk
  constexpr int N3 = CP / kSlabK;
  constexpr int NSLAB = NP + N1 + 4 * (N2 + N3);
  constexpr bool kWide = tail_wide(CP);
  float* stage = sm;                             // kRing x SLAB
  float* h1 = kWide ? h1g : stage + kRing * SLAB;  // [112][LDH]
  float* xm = h1;                                // [112][LDC] (in h1)
  float* cat = xm + kTcRows * LDC;               // [112][LDC] (in h1)
  float* mk = cat + kTcRows * LDC;               // [112][LDC] (in h1)
  float* yln = kWide ? stage + kRing * SLAB      // [112][LDC]
                     : h1 + kTcRows * LDH;
  float* h2 = yln;                               // [100][LDC] (on yln)
  float* g = h2 + kTailNP * LDC;                 // [64][LDC]
  float* xmi = g + kTailNI * LDC;                // [64][LDC]

  const int tid = Group::tid(), warp = tid >> 5;
  // halo products: this warp's 16 rows and its warpgroup's NH outputs
  const int row0 = (warp % 8) * 16, n0 = (warp / 8) * NH;
  const bool live = row0 < kTcRows;
  // W3: 16 of the interior rows, the warpgroup's N3W outputs
  const int row3 = (warp % 4) * 16, n3 = (warp / 4) * N3W;
  const int C4 = 4 * C, C2 = C / 2;
  const int ntx = W / kTailT;
  const int y0 = (ti / ntx) * kTailT - 1, x0 = (ti % ntx) * kTailT - 1;
  const size_t HW = (size_t)H * W;
  auto inside = [&](int p) {
    const int yy = y0 + p / kTailHT, xx = x0 + p % kTailHT;
    return p < kTailNP && yy >= 0 && yy < H && xx >= 0 && xx < W;
  };

  // the weight-slab ring: slab s of the products' sequence
  auto slab_src = [&](int s) -> const float* {
    if (kProj) {
      if (s < NP) return wt.wpT + (size_t)s * SLAB;
      s -= NP;
    }
    if (s < N1) return wt.w1T + (size_t)s * SLAB;
    s -= N1;
    const int j = s / (N2 + N3), r = s % (N2 + N3);
    return r < N2 ? wt.w2T + ((size_t)j * N2 + r) * SLAB
                  : wt.w3T + ((size_t)j * N3 + r - N2) * SLAB;
  };
  auto issue = [&](int s) {
    if (s < NSLAB) {
      const float4* src = reinterpret_cast<const float4*>(slab_src(s));
      float4* dst = reinterpret_cast<float4*>(stage + (s % kRing) * SLAB);
#pragma unroll
      for (int i = tid; i < SLAB / 4; i += kThreads)
        cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  int slab = 0;
  // wait for the current slab, start the next one into the buffer of a
  // slab whose products every warp has waited for, return the current
  auto next_slab = [&]() -> const float* {
    cp_async_wait_all();
    fence_proxy_async();
    Group::sync();
    issue(slab + 1);
    const float* cur = stage + (slab % kRing) * SLAB;
    ++slab;
    return cur;
  };
  issue(0);

  // halo loads (zero outside the image, beyond C and in the pad rows)
  for (int i = tid; i < CP * kTcRows; i += kThreads) {
    const int c = i / kTcRows, p = i % kTcRows;
    float xv = 0.f, cv = 0.f, mv = 0.f;
    if (c < C && inside(p)) {
      const size_t off = (size_t)(y0 + p / kTailHT) * W + (x0 + p % kTailHT);
      xv = load_act<false>(x + ((size_t)b * C + c) * HW + off);  // never
                                                                 // written
      if (kProj)
        cv = load_act<kCoherent>(
            c < C2 ? x1 + ((size_t)b * C2 + c) * HW + off
                   : x2 + ((size_t)b * C2 + (c - C2)) * HW + off);
      if (kMask)
        mv = load_act<kCoherent>(mask + ((size_t)b * C + c) * HW + off);
    }
    xm[p * LDC + c] = xv;
    if (kProj) cat[p * LDC + c] = cv;
    if (kMask) mk[p * LDC + c] = mv;
  }
  Group::sync();

  if (kProj) {                                   // xm += M * (Wp cat + bp)
    float acc[NJ][4] = {};
    for (int k = 0; k < NP; ++k)
      wgmma_slab<NJ, CP>(acc, cat, LDC, row0, live, k * kSlabK, next_slab(),
                         n0);
    each_frag(acc, row0, n0, [&](int r, int c, float v) {
      if (r < kTailNP && c < C) {
        v += __ldg(wt.bp + c);
        if (kMask) v *= mk[r * LDC + c];
        xm[r * LDC + c] += v;
      }
    });
    Group::sync();
  }

  // channel LayerNorm per pixel, 4 threads a pixel (each every 4th
  // channel, so a warp's loads hit 32 banks); keep interior xm. A warp's
  // 8 pixels are all below kTcRows or all above.
  static_assert(kTcRows % 8 == 0, "whole warps");
  for (int p = tid >> 2; p < kTcRows; p += kThreads / 4) {
    const int q = tid & 3;
    const float* v = xm + p * LDC;
    float s = 0.f;
    for (int c = q; c < C; c += 4) s += v[c];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / (float)C;
    float var = 0.f;
    for (int c = q; c < C; c += 4) var += (v[c] - mu) * (v[c] - mu);
    var += __shfl_xor_sync(0xffffffffu, var, 1);
    var += __shfl_xor_sync(0xffffffffu, var, 2);
    const float r = rsqrtf(var / (float)C + eps);
    const int hy = p / kTailHT, hx = p % kTailHT;
    const bool interior = p < kTailNP && hy >= 1 && hy <= kTailT && hx >= 1 &&
                          hx <= kTailT;
    for (int c = q; c < CP; c += 4) {
      yln[p * LDC + c] = c < C && p < kTailNP
          ? (v[c] - mu) * r * __ldg(wt.ln_w + c) + __ldg(wt.ln_b + c) : 0.f;
      if (interior) xmi[((hy - 1) * kTailT + (hx - 1)) * LDC + c] = v[c];
    }
  }
  Group::sync();

  // h1 = GELU(W1 yln + b1), by 4 chunks of CP hidden channels
  for (int nc = 0; nc < 4; ++nc) {
    float acc[NJ][4] = {};
    for (int k = 0; k < CP / kSlabK; ++k)
      wgmma_slab<NJ, CP>(acc, yln, LDC, row0, live, k * kSlabK, next_slab(),
                         n0);
    each_frag(acc, row0, n0, [&](int r, int c, float v) {
      const int o = nc * CP + c;
      if (r < kTcRows)
        h1[r * LDH + o] = gelu(v + (o < C4 ? __ldg(wt.b1 + o) : 0.f));
    });
  }

  float acc3[NJ3][4] = {};                       // W3 g, over the chunks
  for (int hc = 0; hc < 4; ++hc) {               // hidden chunk hc
    {                                            // h2 = W2 h1 + b2
      float acc[NJ][4] = {};
      if (kPipe) {
        // slab k's products run while the A fragments of slab k + 1
        // load (the group of slab k - 1 waited for first, which frees
        // its fragments, and its weight slab for the ring)
        AFrag fa[2];
        load_a(fa[0], h1, LDH, row0, live, 0);
#pragma unroll
        for (int k = 0; k < N2; ++k) {
          issue_slab<NJ, CP>(acc, fa[k & 1], next_slab(), n0);
          if (k + 1 < N2) {
            wgmma_wait<1>();
            load_a(fa[(k + 1) & 1], h1, LDH, row0, live, (k + 1) * kSlabK);
          }
        }
        wgmma_wait<0>();
        wgmma_fence_acc(acc);
      } else {
        for (int k = 0; k < N2; ++k)
          wgmma_slab<NJ, CP>(acc, h1, LDH, row0, live, k * kSlabK,
                             next_slab(), n0);
      }
      each_frag(acc, row0, n0, [&](int r, int c, float v) {
        const int o = hc * CP + c;
        if (r < kTailNP)
          h2[r * LDC + c] = inside(r) && o < C4 ? v + __ldg(wt.b2 + o) : 0.f;
      });
    }
    Group::sync();
    // depthwise 3x3 + bdw + GELU on the interior: a thread keeps the 9
    // taps of channel tid % CP in registers and walks every kPG-th pixel
    {
      constexpr int kPG = kThreads / CP;
      const int c = tid % CP, o = hc * CP + c;
      float k[9], bias = 0.f;
#pragma unroll
      for (int q = 0; q < 9; ++q)
        k[q] = o < C4 ? __ldg(wt.dw + o * 9 + q) : 0.f;
      if (o < C4) bias = __ldg(wt.bdw + o);
      for (int pi = tid / CP; pi < kTailNI; pi += kPG) {
        const int ty = pi / kTailT, tx = pi % kTailT;
        float acc = 0.f;
#pragma unroll
        for (int dr = 0; dr < 3; ++dr)
#pragma unroll
          for (int dc = 0; dc < 3; ++dc)
            acc = fmaf(h2[((ty + dr) * kTailHT + tx + dc) * LDC + c],
                       k[dr * 3 + dc], acc);
        g[pi * LDC + c] = gelu(acc + bias);
      }
    }
    // acc3 += W3[:, chunk] g (next_slab's barrier orders g's writes)
    for (int k = 0; k < N3; ++k)
      wgmma_slab<NJ3, CP>(acc3, g, LDC, row3, true, k * kSlabK, next_slab(),
                          n3);
  }
  each_frag(acc3, row3, n3,
            [&](int r, int c, float v) { xmi[r * LDC + c] += v; });
  Group::sync();
  for (int i = tid; i < C * kTailNI; i += kThreads) {
    const int c = i / kTailNI, pi = i % kTailNI;
    store_act(out + ((size_t)b * C + c) * HW +
                  (size_t)(y0 + 1 + pi / kTailT) * W + (x0 + 1 + pi % kTailT),
              xmi[pi * LDC + c] + __ldg(wt.b3 + c));
  }
}

}  // namespace
