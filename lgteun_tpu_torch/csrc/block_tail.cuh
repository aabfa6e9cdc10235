// Device code shared by block_tail.cu (B3, B5) and lgb_block.cu (B8): one
// 8x8 output tile of
//
//   xm  = x + M * (Wp . [x1; x2] + bp)            (kProj; else xm = x;
//                                                  M = 1 unless kMask)
//   out = xm + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(xm) + b1) + b2) + bdw) + b3
//
// with a 1-pixel halo (10x10 = 100 pixels). proj -> LN -> W1 -> GELU -> W2
// are recomputed on the halo pixels (as the TPU kernels recompute their
// halo rows), so no intermediate leaves the block. Weights stream from L2
// as [in][out] rows (each thread takes 4 output channels as one float4; a
// warp's row is one coalesced load); activations live in shared memory
// pixel-major, so a warp reads each input float4 as a broadcast, and
// every thread computes 4 pixels x 4 channels per pass (64 FMAs per 4 + 4
// loads). Shared memory holds two [100][4C] buffers (h1, h2; the early
// [100][C] stages alias h2) and the interior xm [64][C]: 216 KB at C = 64.
// The out-of-image halo of h2 is zeroed after W2, before the depthwise
// taps: the zero padding applies to the conv's input. Exact-erf GELU.
// With kMask the dropout mask M [B, C, H, W] is read at the halo pixels
// too (the halo's xm feeds the depthwise taps of the interior), into a
// fourth [100][C] buffer aliasing h2.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "loads.cuh"

namespace {

constexpr int kTailT = 8;                 // output tile edge
constexpr int kTailHT = kTailT + 2;       // halo tile edge
constexpr int kTailNP = kTailHT * kTailHT;  // halo pixels
constexpr int kTailNI = kTailT * kTailT;    // interior pixels
constexpr int kPB = 4;                    // pixels per thread per pass
constexpr int kOB = 4;                    // output channels per thread

// Shared memory one tile needs.
inline size_t block_tail_smem(int C, int C4) {
  return sizeof(float) * ((size_t)2 * kTailNP * C4 + (size_t)kTailNI * C);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// out[p][o] (+)= (bias[o] + sum_i in[p][i] * wT[i][o]) (* mul[p][o]), p < P.
// in: shared [P][I]; wT: global [I][O]; out, mul: shared [P][O]; I, O
// multiples of 4 (16-byte aligned rows), P % kPB == 0. Each thread
// computes kPB pixels x kOB output channels, so one float4 of inputs
// (a broadcast within the warp) and one float4 of weights (a coalesced
// row) feed 16 FMAs.
template <bool kGelu, bool kAccum, bool kMul = false>
__device__ __forceinline__ void pointwise(const float* __restrict__ in,
                                          int I, const float* __restrict__ wT,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int O,
                                          int P,
                                          const float* __restrict__ mul =
                                              nullptr) {
  const int no = O / kOB, nchunk = P / kPB;
  for (int t = threadIdx.x; t < no * nchunk; t += blockDim.x) {
    const int o = (t % no) * kOB, p0 = (t / no) * kPB;
    float acc[kPB][kOB] = {};
    for (int i = 0; i < I; i += 4) {
      float4 w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = __ldg(reinterpret_cast<const float4*>(wT + (size_t)(i + r) * O
                                                     + o));
#pragma unroll
      for (int q = 0; q < kPB; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(in + (p0 + q) * I + i);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[q][0] = fmaf(vs[r], w[r].x, acc[q][0]);
          acc[q][1] = fmaf(vs[r], w[r].y, acc[q][1]);
          acc[q][2] = fmaf(vs[r], w[r].z, acc[q][2]);
          acc[q][3] = fmaf(vs[r], w[r].w, acc[q][3]);
        }
      }
    }
    const float b[kOB] = {__ldg(bias + o), __ldg(bias + o + 1),
                          __ldg(bias + o + 2), __ldg(bias + o + 3)};
#pragma unroll
    for (int q = 0; q < kPB; ++q) {
      float r[kOB];
#pragma unroll
      for (int j = 0; j < kOB; ++j) {
        r[j] = acc[q][j] + b[j];
        if (kGelu) r[j] = gelu(r[j]);
        if (kMul) r[j] *= mul[(p0 + q) * O + o + j];
      }
      float4* dst = reinterpret_cast<float4*>(out + (p0 + q) * O + o);
      float4 res = make_float4(r[0], r[1], r[2], r[3]);
      if (kAccum) {
        const float4 prev = *dst;
        res = make_float4(prev.x + r[0], prev.y + r[1], prev.z + r[2],
                          prev.w + r[3]);
      }
      *dst = res;
    }
  }
}

// Weights of the tail; wpT/bp are read only with kProj. Matrices as
// [in][out]; dw as [C4][3][3].
struct TailWeights {
  const float *wpT, *bp, *ln_w, *ln_b, *w1T, *b1, *w2T, *b2, *dw, *bdw,
      *w3T, *b3;
};

// Tile ti of image b. x/out [B, C, H, W]; x1/x2 [B, C/2, H, W] (kProj);
// mask [B, C, H, W] (kMask, with kProj); kCoherent: see loads.cuh.
template <bool kProj, bool kCoherent, bool kMask = false>
__device__ __forceinline__ void block_tail_tile(
    const float* x, const float* x1, const float* x2, const TailWeights& wt,
    float* out, float* sm, int C, int C4, int H, int W, float eps, int b,
    int ti, const float* mask = nullptr) {
  float* h1 = sm;                       // [kNP][C4]; later the taps' output
  float* h2 = h1 + kTailNP * C4;        // [kNP][C4]
  float* xmi = h2 + kTailNP * C4;       // [kNI][C] interior xm, then out
  float* cat = h2;                      // [kNP][C] x1;x2   (aliases h2)
  float* xm = h2 + kTailNP * C;         // [kNP][C]         (aliases h2)
  float* yln = h2 + 2 * kTailNP * C;    // [kNP][C] LN(xm)  (aliases h2)
  float* mk = h2 + 3 * kTailNP * C;     // [kNP][C] mask    (aliases h2)

  const int ntx = W / kTailT;
  const int y0 = (ti / ntx) * kTailT - 1, x0 = (ti % ntx) * kTailT - 1;
  const size_t HW = (size_t)H * W;
  const int C2 = C / 2;
  auto inside = [&](int p) {
    const int yy = y0 + p / kTailHT, xx = x0 + p % kTailHT;
    return yy >= 0 && yy < H && xx >= 0 && xx < W;
  };

  // halo loads (zero outside the image; those pixels' h2 is zeroed below)
  for (int i = threadIdx.x; i < kTailNP * C; i += blockDim.x) {
    const int c = i / kTailNP, p = i % kTailNP;
    float xv = 0.f, cv = 0.f, mv = 0.f;
    if (inside(p)) {
      const size_t off = (size_t)(y0 + p / kTailHT) * W + (x0 + p % kTailHT);
      xv = load_act<kCoherent>(x + ((size_t)b * C + c) * HW + off);
      if (kProj)
        cv = load_act<kCoherent>(
            c < C2 ? x1 + ((size_t)b * C2 + c) * HW + off
                   : x2 + ((size_t)b * C2 + (c - C2)) * HW + off);
      if (kMask) mv = load_act<kCoherent>(mask + ((size_t)b * C + c) * HW + off);
    }
    xm[p * C + c] = xv;
    if (kProj) cat[p * C + c] = cv;
    if (kMask) mk[p * C + c] = mv;
  }
  __syncthreads();

  if (kProj) {
    pointwise<false, true, kMask>(cat, C, wt.wpT, wt.bp, xm, C, kTailNP, mk);
    __syncthreads();                    // xm = x + (mask *) proj
  }

  // channel LayerNorm per pixel (one warp per pixel); keep interior xm
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < kTailNP; p += blockDim.x >> 5) {
    const float* v = xm + p * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += v[c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / (float)C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) q += (v[c] - mu) * (v[c] - mu);
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float r = rsqrtf(q / (float)C + eps);
    const int hy = p / kTailHT, hx = p % kTailHT;
    const bool interior = hy >= 1 && hy <= kTailT && hx >= 1 && hx <= kTailT;
    for (int c = lane; c < C; c += 32) {
      yln[p * C + c] =
          (v[c] - mu) * r * __ldg(wt.ln_w + c) + __ldg(wt.ln_b + c);
      if (interior) xmi[((hy - 1) * kTailT + (hx - 1)) * C + c] = v[c];
    }
  }
  __syncthreads();

  pointwise<true, false>(yln, C, wt.w1T, wt.b1, h1, C4, kTailNP);
  __syncthreads();                      // GELU(W1 y + b1)
  pointwise<false, false>(h1, C4, wt.w2T, wt.b2, h2, C4, kTailNP);
  __syncthreads();                      // W2 h1 + b2
  for (int i = threadIdx.x; i < kTailNP * C4; i += blockDim.x)
    if (!inside(i / C4)) h2[i] = 0.f;
  __syncthreads();

  // depthwise 3x3 + bdw + GELU on the interior (into h1)
  for (int i = threadIdx.x; i < kTailNI * C4; i += blockDim.x) {
    const int pi = i / C4, c = i % C4;
    const int ty = pi / kTailT, tx = pi % kTailT;
    const float* k = wt.dw + (size_t)c * 9;
    float acc = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        acc = fmaf(h2[((ty + dr) * kTailHT + tx + dc) * C4 + c],
                   __ldg(k + dr * 3 + dc), acc);
    h1[pi * C4 + c] = gelu(acc + __ldg(wt.bdw + c));
  }
  __syncthreads();

  pointwise<false, true>(h1, C4, wt.w3T, wt.b3, xmi, C, kTailNI);
  __syncthreads();                      // xm + W3 g + b3
  for (int i = threadIdx.x; i < C * kTailNI; i += blockDim.x) {
    const int c = i / kTailNI, pi = i % kTailNI;
    out[((size_t)b * C + c) * HW + (size_t)(y0 + 1 + pi / kTailT) * W +
        (x0 + 1 + pi % kTailT)] = xmi[pi * C + c];
  }
}

}  // namespace
