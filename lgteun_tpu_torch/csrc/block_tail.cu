// LGB block tail for Hopper (sm_90a): mixer proj + residual, then
// LN + FFN + residual, in one pass over 8x8 output tiles.
//
// Replaces: lgteun_tpu/ops/ffn_kernel.py::fused_block_tail_cm
//           (Pallas `_tail_kernel` and `_tail_kernel_rolls`).
//
//   xm  = x + Wp . [x1; x2] + bp
//   out = xm + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(xm) + b1) + b2) + bdw) + b3
//
// What bounds it here: the 4C x 4C product W2 (16*C*C multiply-adds per
// pixel, 65 K at the 64x64 bottleneck's C = 64) on the FP32 cores; the
// TPU kernel kept a whole image in 100 MB of VMEM, while a Hopper block
// has at most 227 KB of shared memory and w2 alone is 256 KB at C = 64.
//
// Design: one block per 8x8 output tile with a 1-pixel halo (10x10 = 100
// pixels). proj -> LN -> W1 -> GELU -> W2 are recomputed on the halo
// pixels (as `_tail_kernel` recomputes its halo rows), so no
// intermediate leaves the block. Weights stream from L2 as [in][out]
// rows (each thread takes 4 output channels as one float4; a warp's row
// is one coalesced load); activations live in shared memory pixel-major,
// so a warp reads each input float4 as a broadcast, and every thread
// computes 4 pixels x 4 channels per pass (64 FMAs per 4 + 4 loads).
// Shared memory holds two [100][4C] buffers (h1, h2; the early [100][C]
// stages alias h2) and the interior xm [64][C]: 216 KB at C = 64. The out-of-image halo of h2 is zeroed after W2, before the
// depthwise taps: the zero padding applies to the conv's input.
// One kernel serves 128x128/C=32 and 64x64/C=64. Exact-erf GELU (erff).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 8;             // output tile edge
constexpr int kHT = kT + 2;       // halo tile edge
constexpr int kNP = kHT * kHT;    // halo pixels
constexpr int kNI = kT * kT;      // interior pixels
constexpr int kThreads = 512;
constexpr int kPB = 4;            // pixels per thread per product pass
constexpr int kOB = 4;            // output channels per thread per pass

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// out[p][o] (+)= bias[o] + sum_i in[p][i] * wT[i][o], p < P.
// in: shared [P][I]; wT: global [I][O]; out: shared [P][O]; I, O
// multiples of 4 (16-byte aligned rows), P % kPB == 0. Each thread
// computes kPB pixels x kOB output channels, so one float4 of inputs
// (a broadcast within the warp) and one float4 of weights (a coalesced
// row) feed 16 FMAs.
template <bool kGelu, bool kAccum>
__device__ __forceinline__ void pointwise(const float* __restrict__ in,
                                          int I, const float* __restrict__ wT,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int O,
                                          int P) {
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
    const float b[kOB] = {bias[o], bias[o + 1], bias[o + 2], bias[o + 3]};
#pragma unroll
    for (int q = 0; q < kPB; ++q) {
      float r[kOB];
#pragma unroll
      for (int j = 0; j < kOB; ++j) {
        r[j] = acc[q][j] + b[j];
        if (kGelu) r[j] = gelu(r[j]);
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

__global__ void __launch_bounds__(kThreads)
block_tail_kernel(const float* __restrict__ x, const float* __restrict__ x1,
                  const float* __restrict__ x2,
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
  float* h1 = sm;                   // [kNP][C4]; later the taps' output
  float* h2 = h1 + kNP * C4;        // [kNP][C4]
  float* xmi = h2 + kNP * C4;       // [kNI][C] interior xm, then out
  float* cat = h2;                  // [kNP][C] x1;x2   (aliases h2)
  float* xm = h2 + kNP * C;         // [kNP][C]         (aliases h2)
  float* yln = h2 + 2 * kNP * C;    // [kNP][C] LN(xm)  (aliases h2)

  const int ntx = W / kT, tiles = (H / kT) * ntx;
  const int b = blockIdx.x / tiles, ti = blockIdx.x % tiles;
  const int y0 = (ti / ntx) * kT - 1, x0 = (ti % ntx) * kT - 1;  // halo
  const size_t HW = (size_t)H * W;
  const int C2 = C / 2;
  auto inside = [&](int p) {
    const int yy = y0 + p / kHT, xx = x0 + p % kHT;
    return yy >= 0 && yy < H && xx >= 0 && xx < W;
  };

  // halo loads (zero outside the image; those pixels' h2 is zeroed below)
  for (int i = threadIdx.x; i < kNP * C; i += blockDim.x) {
    const int c = i / kNP, p = i % kNP;
    float xv = 0.f, cv = 0.f;
    if (inside(p)) {
      const size_t off = (size_t)(y0 + p / kHT) * W + (x0 + p % kHT);
      xv = x[((size_t)b * C + c) * HW + off];
      cv = c < C2 ? x1[((size_t)b * C2 + c) * HW + off]
                  : x2[((size_t)b * C2 + (c - C2)) * HW + off];
    }
    xm[p * C + c] = xv;
    cat[p * C + c] = cv;
  }
  __syncthreads();

  pointwise<false, true>(cat, C, wpT, bp, xm, C, kNP);  // xm = x + proj
  __syncthreads();

  // channel LayerNorm per pixel (one warp per pixel); keep interior xm
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < kNP; p += blockDim.x >> 5) {
    const float* v = xm + p * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += v[c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / (float)C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) q += (v[c] - mu) * (v[c] - mu);
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float r = rsqrtf(q / (float)C + eps);
    const int hy = p / kHT, hx = p % kHT;
    const bool interior = hy >= 1 && hy <= kT && hx >= 1 && hx <= kT;
    for (int c = lane; c < C; c += 32) {
      yln[p * C + c] = (v[c] - mu) * r * ln_w[c] + ln_b[c];
      if (interior) xmi[((hy - 1) * kT + (hx - 1)) * C + c] = v[c];
    }
  }
  __syncthreads();

  pointwise<true, false>(yln, C, w1T, b1, h1, C4, kNP);   // GELU(W1 y + b1)
  __syncthreads();
  pointwise<false, false>(h1, C4, w2T, b2, h2, C4, kNP);  // W2 h1 + b2
  __syncthreads();
  for (int i = threadIdx.x; i < kNP * C4; i += blockDim.x)
    if (!inside(i / C4)) h2[i] = 0.f;
  __syncthreads();

  // depthwise 3x3 + bdw + GELU on the interior (into h1)
  for (int i = threadIdx.x; i < kNI * C4; i += blockDim.x) {
    const int pi = i / C4, c = i % C4;
    const int ty = pi / kT, tx = pi % kT;
    const float* k = dw + (size_t)c * 9;
    float acc = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        acc = fmaf(h2[((ty + dr) * kHT + tx + dc) * C4 + c], k[dr * 3 + dc],
                   acc);
    h1[pi * C4 + c] = gelu(acc + bdw[c]);
  }
  __syncthreads();

  pointwise<false, true>(h1, C4, w3T, b3, xmi, C, kNI);   // xm + W3 g + b3
  __syncthreads();
  for (int i = threadIdx.x; i < C * kNI; i += blockDim.x) {
    const int c = i / kNI, pi = i % kNI;
    out[((size_t)b * C + c) * HW + (size_t)(y0 + 1 + pi / kT) * W +
        (x0 + 1 + pi % kT)] = xmi[pi * C + c];
  }
}

}  // namespace

// out = block tail of (x, x1, x2) on [B, C, H, W]; C % 4 == 0, C4 = 4C,
// H and W divisible by 8 (checked by the Python wrapper). Weights as
// [in][out]; dw as [C4][3][3].
extern "C" int lgteun_block_tail(const float* x, const float* x1,
                                 const float* x2, const float* wpT,
                                 const float* bp, const float* ln_w,
                                 const float* ln_b, const float* w1T,
                                 const float* b1, const float* w2T,
                                 const float* b2, const float* dw,
                                 const float* bdw, const float* w3T,
                                 const float* b3, float* out, int B, int C,
                                 int C4, int H, int W, float eps,
                                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * kNP * C4 + (size_t)kNI * C);
  const cudaError_t err = cudaFuncSetAttribute(
      block_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * (H / kT) * (W / kT);
  block_tail_kernel<<<blocks, kThreads, smem, stream>>>(
      x, x1, x2, wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T, b3, out,
      C, C4, H, W, eps);
  return (int)cudaGetLastError();
}
