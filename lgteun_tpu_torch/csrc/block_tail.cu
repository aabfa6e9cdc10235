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
// What bounds it here: the 4C x 4C product W2 (16*C*C multiply-adds per
// pixel, 65 K at the 64x64 bottleneck's C = 64) on the FP32 cores; the
// TPU kernels kept a whole image in 100 MB of VMEM, while a Hopper block
// has at most 227 KB of shared memory and w2 alone is 256 KB at C = 64.
//
// Design: one block per 8x8 output tile with a 1-pixel halo whose
// intermediates never leave the block (block_tail.cuh); the template flags
// kProj and kMask select the proj prologue and its mask. Any H, W
// divisible by 8 and C % 4 == 0.

#include <cuda_runtime.h>
#include <math.h>

#include "block_tail.cuh"

namespace {

constexpr int kThreads = 512;

// The weights come as __restrict__ pointers, not as a TailWeights
// parameter, which measured 2 % slower on an H100
// (scripts/torch_kernel_ab.py).
template <bool kProj, bool kMask>
__global__ void __launch_bounds__(kThreads)
block_tail_kernel(const float* __restrict__ x, const float* __restrict__ x1,
                  const float* __restrict__ x2,
                  const float* __restrict__ mask,  // [B][C][H][W] or null
                  const float* __restrict__ wpT,  // [C][C]   in, out
                  const float* __restrict__ bp,
                  const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b,
                  const float* __restrict__ w1T,  // [C][C4]
                  const float* __restrict__ b1,
                  const float* __restrict__ w2T,  // [C4][C4]
                  const float* __restrict__ b2,
                  const float* __restrict__ dw,   // [C4][3][3]
                  const float* __restrict__ bdw,
                  const float* __restrict__ w3T,  // [C4][C]
                  const float* __restrict__ b3, float* __restrict__ out,
                  int C, int C4, int H, int W, float eps) {
  extern __shared__ __align__(16) float sm[];
  const TailWeights wt{wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T,
                       b3};
  const int tiles = (H / kTailT) * (W / kTailT);
  block_tail_tile<kProj, false, kMask>(x, x1, x2, wt, out, sm, C, C4, H, W,
                                       eps, blockIdx.x / tiles,
                                       blockIdx.x % tiles, mask);
}

template <bool kProj, bool kMask>
int launch_block_tail(const float* x, const float* x1, const float* x2,
                      const float* mask, const TailWeights& wt, float* out,
                      int B, int C, int C4, int H, int W, float eps,
                      cudaStream_t stream) {
  const size_t smem = block_tail_smem(C, C4);
  const cudaError_t err = cudaFuncSetAttribute(
      block_tail_kernel<kProj, kMask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * (H / kTailT) * (W / kTailT);
  block_tail_kernel<kProj, kMask><<<blocks, kThreads, smem, stream>>>(
      x, x1, x2, mask, wt.wpT, wt.bp, wt.ln_w, wt.ln_b, wt.w1T, wt.b1, wt.w2T,
      wt.b2, wt.dw, wt.bdw, wt.w3T, wt.b3, out, C, C4, H, W, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// out = block tail of (x, x1, x2) on [B, C, H, W], the proj output times
// `mask` [B, C, H, W] unless mask is null; C % 4 == 0, C4 = 4C, H and W
// divisible by 8 (checked by the Python wrapper). Weights as [in][out]; dw
// as [C4][3][3].
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
  return launch_block_tail<false, false>(x, nullptr, nullptr, nullptr, wt, out,
                                         B, C, C4, H, W, eps, stream);
}
