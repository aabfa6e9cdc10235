// MDCUN's neighbourhood non-local attention (blockNL) for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/nonlocal_kernel.py::fused_neighborhood_attention
//           (Pallas `_kernel` via `_fused_na_impl`).
//
// Per pixel p, over the fs x fs offsets f (phi, g zero outside the image):
//   att(p, f) = softmax_f( theta[p] . phi[p + f] )
//   out[p]    = Ww ( sum_f att(p, f) g[p + f] ) + x[p]
// with theta = Wt x, phi = Wp x, g = Wg x (bias-free 1x1 convs).
//
// What bounds it here: at C = 8 and fs = 15 a pixel takes 225 dot
// products of length C, 225 exponentials and 225 scaled adds of C values
// (about 3.9 K multiply-adds), all from shared memory; the input and
// output are 64 B a pixel. It is bound by the FP32 cores and shared
// memory reads, not by device memory. The TPU kernel kept a
// [fs*fs, rows*W] logit scratch and two passes in VMEM; a register file
// has no room for 225 logits a pixel.
//
// Design: one block of 256 threads per (image, 16x16 output tile), one
// thread per output pixel. The block first computes phi and g on the
// tile plus a (fs/2)-pixel halo into shared memory, planar [C][E*E] with
// E = 16 + fs - 1 (57.6 KB at C = 8, fs = 15), writing zeros outside the
// image. An out-of-image neighbour is not skipped: it takes part in the
// softmax with logit 0 and g = 0, as the reference's F.unfold padding
// gives. Each thread keeps theta and the C accumulators in registers and
// makes one pass over the offsets with a running-max (online) softmax,
// so no logit is stored. Ragged tiles are masked, so any H, W work. The
// channel count is a template bound (4, 8, 16 or 32) with the true C
// masked, so theta and the accumulators stay in registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 16;                 // output tile edge
constexpr int kThreads = kT * kT;      // one thread per output pixel
constexpr int kSmemMax = 232448;       // per-block shared memory on sm_90

template <int CM>
__global__ void __launch_bounds__(kThreads)
na_kernel(const float* __restrict__ x, const float* __restrict__ wt,
          const float* __restrict__ wp, const float* __restrict__ wg,
          const float* __restrict__ ww, float* __restrict__ out, int C,
          int H, int W, int fs, int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  const int r = fs / 2, E = kT + 2 * r, ne = E * E;
  float* phi = smem;                    // [C][E*E]
  float* g = phi + (size_t)C * ne;      // [C][E*E]
  float* wsm = g + (size_t)C * ne;      // wt, wp, wg, ww: [4][C][C]

  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = (tile / tiles_x) * kT, x0 = (tile % tiles_x) * kT;
  const size_t HW = (size_t)H * W;
  const float* xb = x + (size_t)b * C * HW;

  for (int i = threadIdx.x; i < C * C; i += blockDim.x) {
    wsm[i] = wt[i];
    wsm[C * C + i] = wp[i];
    wsm[2 * C * C + i] = wg[i];
    wsm[3 * C * C + i] = ww[i];
  }
  __syncthreads();
  const float* swt = wsm;
  const float* swp = wsm + C * C;
  const float* swg = wsm + 2 * C * C;
  const float* sww = wsm + 3 * C * C;

  // phi and g on the tile plus its halo; zero outside the image
  for (int p = threadIdx.x; p < ne; p += blockDim.x) {
    const int gy = y0 - r + p / E, gx = x0 - r + p % E;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float xv[CM];
#pragma unroll
    for (int c = 0; c < CM; ++c)
      xv[c] = (inside && c < C) ? xb[c * HW + (size_t)gy * W + gx] : 0.f;
#pragma unroll
    for (int d = 0; d < CM; ++d) {
      if (d >= C) break;
      float sp = 0.f, sg = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c >= C) break;
        sp = fmaf(swp[d * C + c], xv[c], sp);
        sg = fmaf(swg[d * C + c], xv[c], sg);
      }
      phi[d * ne + p] = sp;
      g[d * ne + p] = sg;
    }
  }
  __syncthreads();

  const int ty = threadIdx.x / kT, tx = threadIdx.x % kT;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= H || gx >= W) return;
  const size_t at = (size_t)gy * W + gx;
  float xv[CM], th[CM], acc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    xv[c] = c < C ? xb[c * HW + at] : 0.f;
    acc[c] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < CM; ++d) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c)
      if (c < C && d < C) s = fmaf(swt[d * C + c], xv[c], s);
    th[d] = s;
  }

  // one pass over the offsets, running-max softmax
  float m = -INFINITY, l = 0.f;
  for (int dy = 0; dy < fs; ++dy) {
    for (int dx = 0; dx < fs; ++dx) {
      const int p = (ty + dy) * E + tx + dx;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c)
        if (c < C) s = fmaf(th[c], phi[c * ne + p], s);
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int c = 0; c < CM; ++c) acc[c] *= corr;
        m = s;
      }
      const float e = expf(s - m);
      l += e;
#pragma unroll
      for (int c = 0; c < CM; ++c)
        if (c < C) acc[c] = fmaf(e, g[c * ne + p], acc[c]);
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < CM; ++d) {
    if (d >= C) break;
    float s = xv[d];
#pragma unroll
    for (int c = 0; c < CM; ++c)
      if (c < C) s = fmaf(sww[d * C + c], acc[c] * inv, s);
    out[((size_t)b * C + d) * HW + at] = s;
  }
}

template <int CM>
int launch_na(const float* x, const float* wt, const float* wp,
              const float* wg, const float* ww, float* out, int B, int C,
              int H, int W, int fs, cudaStream_t stream) {
  const int E = kT + 2 * (fs / 2);
  const size_t smem = sizeof(float) * (2 * (size_t)C * E * E + 4 * C * C);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      na_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  na_kernel<CM><<<B * tiles_x * tiles_y, kThreads, smem, stream>>>(
      x, wt, wp, wg, ww, out, C, H, W, fs, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

// out = blockNL(x) on [B, C, H, W]; weights [C][C] as (out, in); odd fs;
// C <= 32 (checked by the Python wrapper too).
extern "C" int lgteun_neighborhood_attention(const float* x, const float* wt,
                                             const float* wp, const float* wg,
                                             const float* ww, float* out,
                                             int B, int C, int H, int W,
                                             int fs, cudaStream_t stream) {
  if (C < 1 || fs < 1 || fs % 2 == 0) return (int)cudaErrorInvalidValue;
  auto run = C <= 4 ? &launch_na<4> : C <= 8 ? &launch_na<8>
             : C <= 16 ? &launch_na<16> : &launch_na<32>;
  if (C > 32) return (int)cudaErrorInvalidValue;
  return run(x, wt, wp, wg, ww, out, B, C, H, W, fs, stream);
}
