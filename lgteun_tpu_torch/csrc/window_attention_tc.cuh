// Device code of window MHSA on the tensor cores, shared by
// window_attention.cu (B2, B6, B7) and lgb_block.cu (B8's window items):
// one head of one 8x8 window (S = 64 tokens) on one warpgroup, in any of the
// layouts of window_attention.cuh (the layout changes only which thread
// loads and stores which value, so every layout gives the same bits).
//
// For head h of a window x [C][64] (hd = C / heads):
//
//   q, k, v = x^T . W_h^T + b_h                 [64 x C] . [C x hd], each
//   s       = (q * hd^-0.5) . k^T + pos[h]      [64 x hd] . [hd x 64]
//   out_h   = (exp(s - rowmax) . v) / rowsum    [64 x 64] . [64 x hd]
//
// Every product is wgmma m64nNk8 TF32, FP32-accurate by the 3xTF32 split
// (tc_tf32.cuh): A from registers, split into hi/lo as it is formed; B
// from shared memory, split when it is staged. S = 64 is wgmma's M, so a
// warpgroup's four warps own 16 tokens each, and every intermediate stays
// in the registers of the thread that made it:
//
// - x is loaded straight into the A fragments of the qkv product (lane 4g
//   + t: tokens g and g+8 of its warp's 16, channels t and t+4 of each
//   k-step of 8). In the image and [N, C, S] layouts a warp's load is 4
//   channels x 8 consecutive tokens: 4 whole 32-byte sectors.
// - The accumulator of a product gives lane 4g + t columns {8j+2t,
//   8j+2t+1} of rows g and g+8; the A fragment of the next product wants
//   k-slots t and t+4 of k-step j. Slot t is read as column 8j+2t and slot
//   t+4 as column 8j+2t+1, so the A fragment is the accumulator's
//   registers in the order {d0, d2, d1, d3}: q goes from the qkv
//   accumulator into the logits product, and the exponentiated logits P
//   into the A.V product, without leaving the registers. The B operand
//   sums over the same k, so it is staged in that permuted order: k's
//   columns (head dims) and v's rows (keys), per 8: 0, 2, 4, 6, 1, 3, 5, 7.
//   The sums are unchanged.
// - The position bias pos[h] lies in 32 registers a thread, in the logits
//   accumulator's layout, loaded once per warpgroup (its head is fixed)
//   and copied in as the accumulator's start: the bias costs no
//   instruction of the product and no read a window.
// - The softmax of a row is a reduction over the 16 values of a thread and
//   the 4 threads of its quad (two __shfl_xor_sync steps), expf in FP32.
// - The qkv weights come pre-split into hi/lo TF32 parts in wgmma's
//   K-major core-matrix order (attention_fragments, one launch a matrix on
//   the card), copied to shared memory once per block and kept there.
//
// Shapes (attention_tc_takes): win = 8 (S = 64); hd padded with zero
// weights to HDP = 8, 16 or 32 (a power of two), C padded to CP = 8, 16,
// 32 or 64, heads * HDP <= 64. Other shapes run the FP32-core body of
// window_attention.cuh (the wrappers pick by shape).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "loads.cuh"
#include "tc_tf32.cuh"

namespace {

constexpr int kAttnS = 64;  // tokens a window (win 8)

// The padded widths: the least power of two >= max(v, 8).
__host__ __device__ constexpr int attn_pad(int v) {
  return v <= 8 ? 8 : v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// Whether the tensor-core body takes C channels in `heads` heads of a
// win x win window.
inline bool attention_tc_takes(int C, int heads, int win) {
  if (win != 8 || heads < 1 || C % heads) return false;
  const int hdp = attn_pad(C / heads), cp = attn_pad(C);
  return hdp <= 32 && cp <= 64 && heads * hdp <= 64;
}

// Floats of the qkv weight fragments: [heads][q, k, v][hi, lo][HDP / 8
// n-groups][CP / 4 k-quads][8][4] (attention_fragments).
inline size_t attn_wfrag_floats(int C, int heads) {
  return (size_t)heads * 6 * attn_pad(C / heads) * attn_pad(C);
}

// Floats of one warpgroup's staging: k hi, k lo ([64 / 8 key groups][HDP
// / 4][8][4] each), v hi, v lo ([HDP / 8][64 / 4 key quads][8][4] each).
inline size_t attn_kv_floats(int hdp) { return (size_t)4 * kAttnS * hdp; }

// Shared memory (bytes) of a block of `nwg` warpgroups: the weight
// fragments, then each warpgroup's staging.
inline size_t attention_tc_smem(int C, int heads, int nwg) {
  return sizeof(float) * (attn_wfrag_floats(C, heads) +
                          nwg * attn_kv_floats(attn_pad(C / heads)));
}

// pos[h] in the logits accumulator's layout: p[j][q] = pos[h][row][col],
// row = 16 (warp % 4) + g + 8 (q / 2), col = 8j + 2t + q % 2.
__device__ __forceinline__ void attention_pos(float (&p)[8][4],
                                              const float* __restrict__ pos,
                                              int h) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[j][q] = __ldg(pos + ((size_t)h * kAttnS + row0 + g + (q >> 1) * 8) *
                                kAttnS + 8 * j + 2 * t + (q & 1));
}

// Copy the weight fragments (n floats, n % 4 == 0, 16-byte aligned) from
// global into shared memory with all threads of the block, made visible to
// wgmma (the caller's __syncthreads follows).
__device__ __forceinline__ void attention_load_weights(
    float* dst, const float* __restrict__ src, int n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = __ldg(s + i);
  fence_proxy_async();
}

// Head h of one window on the calling warpgroup (wg: its index in the
// block). x/out in layout `lay`, each in its storage type (loads.cuh); wf:
// the weight fragments in shared memory;
// bqkv [3C] in global memory; kv: the warpgroup's staging (attn_kv_floats
// (HDP) floats of shared memory); pos: attention_pos of head h; kCoherent:
// see loads.cuh. C and hd = C / heads within CP and HDP.
template <int HDP, int CP, bool kCoherent, class Layout, class TI,
          class TO>
__device__ __forceinline__ void window_attention_head_tc(
    const TI* x, const float* wf, const float* __restrict__ bqkv,
    TO* out, float* kv, const float (&pos)[8][4], int C, int hd, int h,
    float scale, const Layout& lay, int wg) {
  constexpr int NJ = HDP / 8, KS = CP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16;

  // 1. q, k, v of head h (A: x from global memory)
  uint32_t xh[KS][4], xl[KS][4];
  {
    float xv[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 8 * ks + t + 4 * (q >> 1), s = row0 + g + 8 * (q & 1);
        xv[ks][q] = c < C ? load_act<kCoherent>(x + lay.at(c, s)) : 0.f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(xv[ks][q], xh[ks][q], xl[ks][q]);
  }
  float aq[NJ][4] = {}, ak[NJ][4] = {}, av[NJ][4] = {};
  {
    const float* w = wf + (size_t)h * 6 * HDP * CP;  // [3][2][HDP/8][CP/4]..
    constexpr int PART = HDP * CP;                    // floats of one part
    constexpr uint32_t SBO = 32 * CP;                 // bytes an n-group
    wgmma_fence_acc(aq);
    wgmma_fence_acc(ak);
    wgmma_fence_acc(av);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      mma3(aq, xh[ks], xl[ks], w + 64 * ks, w + PART + 64 * ks, SBO);
      mma3(ak, xh[ks], xl[ks], w + 2 * PART + 64 * ks,
           w + 3 * PART + 64 * ks, SBO);
      mma3(av, xh[ks], xl[ks], w + 4 * PART + 64 * ks,
           w + 5 * PART + 64 * ks, SBO);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(aq);
    wgmma_fence_acc(ak);
    wgmma_fence_acc(av);
  }
  // bias (the padded columns have zero weights and get no bias: they stay
  // zero), then q * scale
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 8 * j + 2 * t + (q & 1);
      if (d < hd) {
        const float* b = bqkv + h * hd + d;
        aq[j][q] = (aq[j][q] + __ldg(b)) * scale;
        ak[j][q] += __ldg(b + C);
        av[j][q] += __ldg(b + 2 * C);
      }
    }

  // 2. stage k and v, split, in the permuted order (the warpgroup's
  // previous window is done with the buffers first)
  float* khi = kv;                      // [8][HDP/4][8][4]
  float* klo = khi + kAttnS * HDP;
  float* vhi = klo + kAttnS * HDP;      // [HDP/8][16][8][4]
  float* vlo = vhi + kAttnS * HDP;
  warpgroup_sync(wg);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = row0 + g + 8 * (q >> 1);  // this value's token (key)
      // k: row s (an n of the logits' B), k-slot 8j + t + 4 (q % 2)
      const int ko = (s >> 3) * (8 * HDP) + (2 * j + (q & 1)) * 32 +
                     (s & 7) * 4 + t;
      // v: row d = 8j + 2t + q % 2 (an n of A.V's B), key slot
      // 8 (s / 8) + (s % 8) / 2 + 4 (s % 2)
      const int vo = j * 512 + (2 * (s >> 3) + (s & 1)) * 32 +
                     (2 * t + (q & 1)) * 4 + ((s & 7) >> 1);
      uint32_t hi, lo;
      split_tf32(ak[j][q], hi, lo);
      khi[ko] = __uint_as_float(hi);
      klo[ko] = __uint_as_float(lo);
      split_tf32(av[j][q], hi, lo);
      vhi[vo] = __uint_as_float(hi);
      vlo[vo] = __uint_as_float(lo);
    }
  fence_proxy_async();
  warpgroup_sync(wg);

  // 3. logits = pos + q . k^T (A: q's accumulator, slots {0, 2, 1, 3})
  float sc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) sc[j][q] = pos[j][q];
  {
    uint32_t qh[NJ][4], ql[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      split_tf32(aq[j][0], qh[j][0], ql[j][0]);
      split_tf32(aq[j][2], qh[j][1], ql[j][1]);
      split_tf32(aq[j][1], qh[j][2], ql[j][2]);
      split_tf32(aq[j][3], qh[j][3], ql[j][3]);
    }
    wgmma_fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NJ; ++ks)
      mma3(sc, qh[ks], ql[ks], khi + 64 * ks, klo + 64 * ks, 32 * HDP);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(sc);
  }

  // 4. softmax numerators and 1 / rowsum (rows g and g + 8 of the warp)
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
    m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j][0] = expf(sc[j][0] - m0);
    sc[j][1] = expf(sc[j][1] - m0);
    sc[j][2] = expf(sc[j][2] - m1);
    sc[j][3] = expf(sc[j][3] - m1);
    s0 += sc[j][0] + sc[j][1];
    s1 += sc[j][2] + sc[j][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  const float r0 = 1.0f / s0, r1 = 1.0f / s1;

  // 5. o = P . v (A: P's accumulator, slots {0, 2, 1, 3})
  float o[NJ][4] = {};
  {
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(sc[j][0], ph[j][0], pl[j][0]);
      split_tf32(sc[j][2], ph[j][1], pl[j][1]);
      split_tf32(sc[j][1], ph[j][2], pl[j][2]);
      split_tf32(sc[j][3], ph[j][3], pl[j][3]);
    }
    wgmma_fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      mma3(o, ph[ks], pl[ks], vhi + 64 * ks, vlo + 64 * ks, 2048);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(o);
  }

  // 6. out[h hd + d][s] = o / rowsum
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 8 * j + 2 * t + (q & 1), s = row0 + g + 8 * (q >> 1);
      if (d < hd)
        store_act(out + lay.at(h * hd + d, s), o[j][q] * (q < 2 ? r0 : r1));
    }
}

}  // namespace
