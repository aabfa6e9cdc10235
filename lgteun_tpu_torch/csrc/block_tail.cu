// LGB block tail for Hopper (sm_90a): mixer proj (times the dropout mask
// in training) + residual, then LN + FFN + residual, in one pass over 8x8
// output tiles; and the same without the proj prologue, x + FFN(LN(x)).
//
// Replaces: lgteun_tpu/ops/ffn_kernel.py::fused_block_tail_cm
//           (Pallas `_tail_kernel` and `_tail_kernel_rolls`, with and
//           without their dropout-mask input), and
//           lgteun_tpu/ops/ffn_kernel.py::fused_ln_ffn_cm / fused_ln_ffn
//           (Pallas `_kernel`).
//
//   xm  = x + M * (Wp . [x1; x2] + bp)  (block tail, M = 1 without a mask;
//                                        ln_ffn: xm = x)
//   out = xm + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(xm) + b1) + b2) + bdw) + b3
//
// What bounds it here: the four 1x1 products, 50 C^2 of the (50 C^2 + 122
// C) operations a pixel (93 % at C = 32), 42 C^2 of them recomputed on
// the 1-pixel halo (128 rows for 64 outputs). The FP32-core version ran
// them as scalar FMAs fed by __ldg weight loads: 0.3449 ms at 128^2/C32
// and 0.4288 at 64^2/C64, batch 4 (H100 80GB HBM3, 700 W; chip_smoke.py).
// The TPU kernels kept a whole image in VMEM; a Hopper block has 227 KB
// and w2 alone is 256 KB at C = 64.
//
// Design (block_tail.cuh, block_tail_tile_tc): every 1x1 product on the
// tensor cores as wgmma m64nNk8 TF32 (A from registers, B from shared
// memory), FP32-accurate by the 3xTF32 split; the weights split once per
// weight version (ops/ffn_kernel.py::tail_fragments, one
// lgteun_tail_fragments launch a matrix on the card) into wgmma's
// core-matrix order and staged through a cp.async ring, one global read
// per block shared by its warps; W2 -> depthwise -> GELU -> W3 by chunks
// of CP hidden channels, which frees the second [100][4C] buffer: 106 KB
// of shared memory at C <= 32, so two blocks share an SM (each of two
// warpgroups, m64n32 products; see tail_wg), and 222 KB at C <= 64 (one
// block an SM of four warpgroups, W2's products pipelined one slab behind
// its A loads). Tiles stay 8x8: any H, W divisible by 8 tile exactly (the
// scene engine's 72^2 is no multiple of 16), and batch 1 at 64^2 keeps its
// 64 blocks. Any C % 4 == 0 up to 64 (zero-padded to 32 or 64 channels)
// on that tile. Above 64 (up to 128, padded to 128: a 16-band UnlgFormer's
// bottleneck) h1 [112][4C] alone passes the 227 KB a block may have, so
// the wide entries (lgteun_block_tail_wide, lgteun_ln_ffn_wide) run the
// same tile with h1 in a global scratch slot of each block (229 KB, L2-
// resident at one persistent block an SM) and the rest in 182 KB of
// shared memory; the Python wrapper picks the entry by C.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md §6): about 0.22 ms at
// 128^2/C32 and 0.17 at 64^2/C64 (batch 4), 1.6x and 2.5x the FP32-core
// version. What bounds it now is latency between the per-slab barriers,
// not a pipe: clock stamps in a copy of the kernel (scripts/
// torch_kernel_ab.py --phases) put most of a tile in W2 and W1, each
// warpgroup waiting for its group of twelve wgmma before the next slab,
// and little in waiting for the weight slabs. With four warpgroups at C32
// the 64 registers a thread of two blocks an SM made ptxas serialize the
// wgmma (0.29 ms); one block an SM measured slower still.

#include <cuda_runtime.h>
#include <math.h>

#include "block_tail.cuh"

namespace {

// Warpgroups of a B3 / B5 block of kNT (CP / 16): at CP = 32 two blocks
// share an SM (shared memory), and with 4 warpgroups each the 64
// registers a thread that leaves made ptxas serialize the wgmma; with 2
// (m64n32 products) a thread has 128. At CP = 64 one block an SM of 4.
__host__ __device__ constexpr int tail_wg(int kNT) { return kNT == 2 ? 2 : 4; }

// The weights come as __restrict__ pointers, not as a TailWeights
// parameter, which measured 2 % slower on an H100
// (scripts/torch_kernel_ab.py). TX: the storage type of x and out, TB of
// x1 and x2 (loads.cuh).
template <int kNT, bool kProj, bool kMask, class TX, class TB>
__global__ void __launch_bounds__(128 * tail_wg(kNT), kNT == 2 ? 2 : 1)
block_tail_kernel(const TX* __restrict__ x, const TB* __restrict__ x1,
                  const TB* __restrict__ x2,
                  const float* __restrict__ mask,  // [B][C][H][W] or null
                  const float* __restrict__ wpT,  // TF32 slabs
                  const float* __restrict__ bp,
                  const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b,
                  const float* __restrict__ w1T,  // TF32 slabs
                  const float* __restrict__ b1,
                  const float* __restrict__ w2T,  // TF32 slabs
                  const float* __restrict__ b2,
                  const float* __restrict__ dw,   // [C4][3][3]
                  const float* __restrict__ bdw,
                  const float* __restrict__ w3T,  // TF32 slabs
                  const float* __restrict__ b3, TX* __restrict__ out,
                  int C, int H, int W, float eps) {
  extern __shared__ __align__(16) float sm[];
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  const int tiles = (H / kTailT) * (W / kTailT);
  block_tail_tile_tc<kNT, kProj, kMask, false, tail_wg(kNT)>(
      x, x1, x2, mask, wt, out, sm, nullptr, C, H, W, eps,
      blockIdx.x / tiles, blockIdx.x % tiles);
}

// The wide tile (CP = 128, four warpgroups, one block an SM): persistent,
// each block walks the tiles t = blockIdx.x, + gridDim.x, ... with its h1
// in its own slot of `scratch` (tail_h1_floats(128) floats a block).
template <bool kProj, bool kMask, class TX, class TB>
__global__ void __launch_bounds__(kTcThreads, 1)
block_tail_wide_kernel(const TX* __restrict__ x,
                       const TB* __restrict__ x1,
                       const TB* __restrict__ x2,
                       const float* __restrict__ mask,
                       const float* __restrict__ wpT,
                       const float* __restrict__ bp,
                       const float* __restrict__ ln_w,
                       const float* __restrict__ ln_b,
                       const float* __restrict__ w1T,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2T,
                       const float* __restrict__ b2,
                       const float* __restrict__ dw,
                       const float* __restrict__ bdw,
                       const float* __restrict__ w3T,
                       const float* __restrict__ b3, TX* __restrict__ out,
                       float* __restrict__ scratch, int B, int C, int H,
                       int W, float eps) {
  extern __shared__ __align__(16) float sm[];
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  const int tiles = (H / kTailT) * (W / kTailT);
  float* h1 = scratch + blockIdx.x * tail_h1_floats(128);
  for (int t = blockIdx.x; t < B * tiles; t += gridDim.x) {
    block_tail_tile_tc<8, kProj, kMask>(x, x1, x2, mask, wt, out, sm, h1, C,
                                        H, W, eps, t / tiles, t % tiles);
    __syncthreads();  // shared memory and h1 are reused by the next tile
  }
}

template <int kNT, bool kProj, bool kMask, class TX, class TB>
int launch_tc(const TX* x, const TB* x1, const TB* x2,
              const float* mask, const TailWeights& wt, TX* out, int B,
              int C, int H, int W, float eps, cudaStream_t stream) {
  const size_t smem = block_tail_tc_smem(16 * kNT);
  const cudaError_t err = cudaFuncSetAttribute(
      block_tail_kernel<kNT, kProj, kMask, TX, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * (H / kTailT) * (W / kTailT);
  block_tail_kernel<kNT, kProj, kMask, TX, TB>
      <<<blocks, 128 * tail_wg(kNT), smem, stream>>>(
          x, x1, x2, mask, wt.wpT, wt.bp, wt.ln_w, wt.ln_b, wt.w1T, wt.b1,
          wt.w2T, wt.b2, wt.dw, wt.bdw, wt.w3T, wt.b3, out, C, H, W, eps);
  return (int)cudaGetLastError();
}

template <bool kProj, bool kMask, class TX, class TB>
int launch_wide(const TX* x, const TB* x1, const TB* x2,
                const float* mask, const TailWeights& wt, TX* out,
                float* scratch, int slots, int B, int C, int C4, int H,
                int W, float eps, cudaStream_t stream) {
  if (C4 != 4 * C || C % 4 || tail_tc_width(C) != 128 || slots < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_tail_tc_smem(128);
  const cudaError_t err = cudaFuncSetAttribute(
      block_tail_wide_kernel<kProj, kMask, TX, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * (H / kTailT) * (W / kTailT);
  block_tail_wide_kernel<kProj, kMask, TX, TB>
      <<<tiles < slots ? tiles : slots, kTcThreads, smem, stream>>>(
          x, x1, x2, mask, wt.wpT, wt.bp, wt.ln_w, wt.ln_b, wt.w1T, wt.b1,
          wt.w2T, wt.b2, wt.dw, wt.bdw, wt.w3T, wt.b3, out, scratch, B, C, H,
          W, eps);
  return (int)cudaGetLastError();
}

template <bool kProj, bool kMask, class TX, class TB>
int launch_block_tail(const TX* x, const TB* x1, const TB* x2,
                      const float* mask, const TailWeights& wt, TX* out,
                      int B, int C, int C4, int H, int W, float eps,
                      cudaStream_t stream) {
  if (C4 != 4 * C || C % 4) return (int)cudaErrorInvalidValue;
  switch (tail_tc_width(C)) {
    case 32:
      return launch_tc<2, kProj, kMask>(x, x1, x2, mask, wt, out, B, C, H, W,
                                        eps, stream);
    case 64:
      return launch_tc<4, kProj, kMask>(x, x1, x2, mask, wt, out, B, C, H, W,
                                        eps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#ifndef LGTEUN_BF16_UNIT
// out = block tail of (x, x1, x2) on [B, C, H, W], the proj output times
// `mask` [B, C, H, W] unless mask is null; C % 4 == 0, C <= 64 (wider:
// lgteun_block_tail_wide), C4 = 4C,
// H and W divisible by 8 (checked by the Python wrapper). The matrices
// wpT, w1T, w2T, w3T as TF32 slabs of padded width tail_tc_width(C)
// (lgteun_tail_fragments); the vectors as [C] / [C4]; dw as [C4][3][3].
extern "C" int lgteun_block_tail(const float* x, const float* x1,
                                 const float* x2, const float* mask,
                                 const float* wpT,
                                 const float* bp, const float* ln_w,
                                 const float* ln_b, const float* w1T,
                                 const float* b1, const float* w2T,
                                 const float* b2, const float* dw,
                                 const float* bdw, const float* w3T,
                                 const float* b3, float* out, int B, int C,
                                 int C4, int H, int W, float eps,
                                 cudaStream_t stream) {
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  return mask ? launch_block_tail<true, true>(x, x1, x2, mask, wt, out, B, C,
                                              C4, H, W, eps, stream)
              : launch_block_tail<true, false>(x, x1, x2, nullptr, wt, out, B,
                                               C, C4, H, W, eps, stream);
}

// The same for 64 < C <= 128 on the wide tile: scratch holds `slots` x
// tail_h1_floats(128) floats (slots: at most one block a slot, e.g. one
// an SM), the matrices as TF32 slabs of padded width 128.
extern "C" int lgteun_block_tail_wide(
    const float* x, const float* x1, const float* x2, const float* mask,
    const float* wpT, const float* bp, const float* ln_w, const float* ln_b,
    const float* w1T, const float* b1, const float* w2T, const float* b2,
    const float* dw, const float* bdw, const float* w3T, const float* b3,
    float* out, float* scratch, int slots, int B, int C, int C4, int H,
    int W, float eps, cudaStream_t stream) {
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  return mask ? launch_wide<true, true>(x, x1, x2, mask, wt, out, scratch,
                                        slots, B, C, C4, H, W, eps, stream)
              : launch_wide<true, false>(x, x1, x2, nullptr, wt, out,
                                         scratch, slots, B, C, C4, H, W, eps,
                                         stream);
}

// out = x + FFN(LN(x)) on [B, C, H, W]; the same contract without the proj.
extern "C" int lgteun_ln_ffn(const float* x, const float* ln_w,
                             const float* ln_b, const float* w1T,
                             const float* b1, const float* w2T,
                             const float* b2, const float* dw,
                             const float* bdw, const float* w3T,
                             const float* b3, float* out, int B, int C,
                             int C4, int H, int W, float eps,
                             cudaStream_t stream) {
  const TailWeights wt{nullptr, nullptr, ln_w, ln_b, w1T, b1, w2T, b2, dw,
                       bdw, w3T, b3};
  return launch_block_tail<false, false>(x, (const float*)nullptr,
                                         (const float*)nullptr, nullptr, wt,
                                         out, B, C, C4, H, W, eps, stream);
}

// The same for 64 < C <= 128 on the wide tile (scratch and slots as for
// lgteun_block_tail_wide).
extern "C" int lgteun_ln_ffn_wide(const float* x, const float* ln_w,
                                  const float* ln_b, const float* w1T,
                                  const float* b1, const float* w2T,
                                  const float* b2, const float* dw,
                                  const float* bdw, const float* w3T,
                                  const float* b3, float* out,
                                  float* scratch, int slots, int B, int C,
                                  int C4, int H, int W, float eps,
                                  cudaStream_t stream) {
  const TailWeights wt{nullptr, nullptr, ln_w, ln_b, w1T, b1, w2T, b2, dw,
                       bdw, w3T, b3};
  return launch_wide<false, false>(x, (const float*)nullptr,
                                   (const float*)nullptr, nullptr, wt, out,
                                   scratch, slots, B, C, C4, H, W, eps,
                                   stream);
}
#endif  // LGTEUN_BF16_UNIT

#ifndef LGTEUN_BF16_UNIT
namespace {

__global__ void tail_fragments_kernel(const float* __restrict__ w, int N,
                                      int K, int n_pad, int k_pad, int cp,
                                      float* __restrict__ out) {
  const size_t total = 2 * (size_t)n_pad * k_pad;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    // i = (((((chunk, slab), hi/lo), n-group), k-quad), n % 8, k % 4)
    size_t t = i;
    const int e = t % 4; t /= 4;
    const int r = t % 8; t /= 8;
    const int kq = t % 8; t /= 8;
    const int ng = t % (cp / 8); t /= cp / 8;
    const int part = t % 2; t /= 2;
    const int slab = t % (k_pad / kSlabK);
    const int chunk = (int)(t / (k_pad / kSlabK));
    const int n = chunk * cp + ng * 8 + r, k = slab * kSlabK + kq * 4 + e;
    const float v = n < N && k < K ? w[(size_t)n * K + k] : 0.f;
    const uint32_t hi = tf32_rna(v);
    out[i] = part ? __uint_as_float(tf32_rna(v - __uint_as_float(hi)))
                  : __uint_as_float(hi);
  }
}

}  // namespace

// out = w [N, K] (out, in) zero-padded to [n_pad, k_pad], split into
// TF32 hi/lo parts and laid out as the tile's weight slabs (the same
// bits as ops/ffn_kernel.py::tail_fragments): [n_pad / cp chunks][k_pad /
// 32 slabs][hi, lo][cp / 8 n-groups][8 k-quads][8][4]. n_pad % cp == 0,
// k_pad % 32 == 0, cp % 8 == 0.
extern "C" int lgteun_tail_fragments(const float* w, int N, int K, int n_pad,
                                     int k_pad, int cp, float* out,
                                     cudaStream_t stream) {
  if (n_pad % cp || k_pad % kSlabK || cp % 8 || N > n_pad || K > k_pad)
    return (int)cudaErrorInvalidValue;
  const size_t total = 2 * (size_t)n_pad * k_pad;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                       : 1024);
  tail_fragments_kernel<<<blocks, 256, 0, stream>>>(w, N, K, n_pad, k_pad,
                                                    cp, out);
  return (int)cudaGetLastError();
}

// The weight layout this library's lgteun_block_tail, lgteun_ln_ffn and
// lgteun_lgb_block take: 3 = TF32 slabs in wgmma's core-matrix order (2:
// mma.sync fragment slabs; the [in][out] rows of earlier versions had no
// such entry).
extern "C" int lgteun_block_tail_layout() { return 3; }
#else  // LGTEUN_BF16_UNIT: block_tail_bf16.cu

// The bf16 storage entries (LGTEUN_EVAL_DTYPE, loads.cuh): activations
// upcast as loaded, math in float, out rounded once to nearest even. Each
// takes the arguments of the float32 entry without _bf16 (no mask: the
// masked tail is training's, float32 only), then the storage flags.

namespace {

// The proj tail on x (and out) of storage type TX and x1, x2 of TB, on the
// tile or (kWide) the wide tile.
template <bool kWide, class TX, class TB>
int tail_bf16(const void* x, const void* x1, const void* x2,
              const TailWeights& wt, void* out, float* scratch, int slots,
              int B, int C, int C4, int H, int W, float eps,
              cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TB* x1t = static_cast<const TB*>(x1);
  const TB* x2t = static_cast<const TB*>(x2);
  TX* outt = static_cast<TX*>(out);
  if constexpr (kWide)
    return launch_wide<true, false>(xt, x1t, x2t, nullptr, wt, outt,
                                    scratch, slots, B, C, C4, H, W, eps,
                                    stream);
  else
    return launch_block_tail<true, false>(xt, x1t, x2t, nullptr, wt, outt,
                                          B, C, C4, H, W, eps, stream);
}

// tail_bf16 for the storage flags (0: float, 1: __nv_bfloat16) of x (and
// out) and of x1/x2; both float is the float32 entry's.
template <bool kWide>
int tail_bf16_any(const void* x, const void* x1, const void* x2,
                  const TailWeights& wt, void* out, float* scratch,
                  int slots, int B, int C, int C4, int H, int W, int x_bf16,
                  int br_bf16, float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (x_bf16 && br_bf16)
    return tail_bf16<kWide, bf, bf>(x, x1, x2, wt, out, scratch, slots, B,
                                    C, C4, H, W, eps, stream);
  if (x_bf16)
    return tail_bf16<kWide, bf, float>(x, x1, x2, wt, out, scratch, slots,
                                       B, C, C4, H, W, eps, stream);
  if (br_bf16)
    return tail_bf16<kWide, float, bf>(x, x1, x2, wt, out, scratch, slots,
                                       B, C, C4, H, W, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// lgteun_block_tail, no mask: x and out bf16 where x_bf16, x1 and x2
// where br_bf16 (at least one of them; both float: lgteun_block_tail).
extern "C" int lgteun_block_tail_bf16(
    const void* x, const void* x1, const void* x2, const float* wpT,
    const float* bp, const float* ln_w, const float* ln_b, const float* w1T,
    const float* b1, const float* w2T, const float* b2, const float* dw,
    const float* bdw, const float* w3T, const float* b3, void* out, int B,
    int C, int C4, int H, int W, int x_bf16, int br_bf16, float eps,
    cudaStream_t stream) {
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  return tail_bf16_any<false>(x, x1, x2, wt, out, nullptr, 0, B, C, C4, H,
                              W, x_bf16, br_bf16, eps, stream);
}

// lgteun_block_tail_wide, no mask, with the storage flags.
extern "C" int lgteun_block_tail_wide_bf16(
    const void* x, const void* x1, const void* x2, const float* wpT,
    const float* bp, const float* ln_w, const float* ln_b, const float* w1T,
    const float* b1, const float* w2T, const float* b2, const float* dw,
    const float* bdw, const float* w3T, const float* b3, void* out,
    float* scratch, int slots, int B, int C, int C4, int H, int W,
    int x_bf16, int br_bf16, float eps, cudaStream_t stream) {
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  return tail_bf16_any<true>(x, x1, x2, wt, out, scratch, slots, B, C, C4,
                             H, W, x_bf16, br_bf16, eps, stream);
}

// lgteun_ln_ffn on bf16 x and out.
extern "C" int lgteun_ln_ffn_bf16(const __nv_bfloat16* x, const float* ln_w,
                                  const float* ln_b, const float* w1T,
                                  const float* b1, const float* w2T,
                                  const float* b2, const float* dw,
                                  const float* bdw, const float* w3T,
                                  const float* b3, __nv_bfloat16* out, int B,
                                  int C, int C4, int H, int W, float eps,
                                  cudaStream_t stream) {
  const TailWeights wt{nullptr, nullptr, ln_w, ln_b, w1T, b1, w2T, b2, dw,
                       bdw, w3T, b3};
  return launch_block_tail<false, false>(
      x, (const __nv_bfloat16*)nullptr, (const __nv_bfloat16*)nullptr,
      nullptr, wt, out, B, C, C4, H, W, eps, stream);
}

// lgteun_ln_ffn_wide on bf16 x and out.
extern "C" int lgteun_ln_ffn_wide_bf16(const __nv_bfloat16* x,
                                       const float* ln_w, const float* ln_b,
                                       const float* w1T, const float* b1,
                                       const float* w2T, const float* b2,
                                       const float* dw, const float* bdw,
                                       const float* w3T, const float* b3,
                                       __nv_bfloat16* out, float* scratch,
                                       int slots, int B, int C, int C4,
                                       int H, int W, float eps,
                                       cudaStream_t stream) {
  const TailWeights wt{nullptr, nullptr, ln_w, ln_b, w1T, b1, w2T, b2, dw,
                       bdw, w3T, b3};
  return launch_wide<false, false>(
      x, (const __nv_bfloat16*)nullptr, (const __nv_bfloat16*)nullptr,
      nullptr, wt, out, scratch, slots, B, C, C4, H, W, eps, stream);
}
#endif  // LGTEUN_BF16_UNIT
