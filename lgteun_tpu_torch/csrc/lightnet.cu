// LightNet's SpanConv stack for Hopper (sm_90a): a group of whole layers
// per launch, over 16x16 output tiles, with the lms residual on the last.
//
// Replaces: lgteun_tpu/ops/lightnet_kernel.py::lightnet_fused_forward
//           (Pallas `_kernel` via `_lightnet_call`).
//
// Each layer is  out = DW1(PW1 x + pb1) + DW2(PW2 x + pb2) + db1 + db2,
// optionally followed by a ReLU; PW are 1x1 convs, DW 3x3 depthwise
// convs whose input is zero outside the image (torch's zero padding).
// The last layer of the stack adds lms.
//
// What bounds it here: shared memory. The TPU kernel held a whole
// 128x128 image (2 MB a buffer) in VMEM; a Hopper block has 227 KB. The
// whole stack on one tile would need a 10-pixel halo: at an 8x8 tile
// that is a 28x28 region and about 6x recompute. So the wrapper splits
// the stack into three launches of 4, 3 and 3 layers (halo 4 and 3
// around a 16x16 tile, about 1.6x recompute); between launches the
// 32-channel activation goes through device memory (33.5 MB at batch
// 16, which the 50 MB L2 mostly holds). At up to 209 KB a block, one
// block runs per SM, and then the latency of shared loads behind the
// FMA chains bounds the time, not the FP32 cores (about 15.4 K
// multiply-adds a pixel at 8 bands, 11.4 K of them pointwise): on an
// H100 (700 W), 256 -> 512 -> 1024 threads a block took the batch-16
// stack from 2.20 to 1.53 to 1.41 ms, while halving the depthwise
// phase's shared loads gained 2 %.
//
// Design: one block of 1024 threads per (image, 16x16 tile). Shared
// memory holds the group's packed weights, the layer input A [cin][R*R]
// and output O [cout][(R-2)*(R-2)] over the tile's shrinking halo region
// R, and P [2][8][R*R]: one chunk of 8 pointwise output channels of both
// branches. Per chunk, each thread computes 8 output channels of one
// branch at one pixel (one broadcast float4 pair of weights and one
// activation load feed 8 FMAs), writing 0 outside the image (the border
// trap: the pointwise output there is the bias, but the depthwise input
// must be zero on every layer, not just the first); then warps j, j + 8,
// ... sum both branches' 3x3 taps of chunk channel j over the pixels of
// O, its 18 taps held in registers (one shared load per FMA). A and O
// swap after each layer. Ragged tiles (H or W not a multiple of 16) are
// masked on load and store.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kT = 16;            // output tile edge
constexpr int kChunk = 8;         // output channels per pass and branch
constexpr int kThreads = 1024;
constexpr int kWarpsPerChannel = kThreads / (32 * kChunk);
static_assert(kThreads % (32 * kChunk) == 0, "whole warps per channel");
constexpr int kMaxLayers = 10;
constexpr int kSmemMax = 232448;  // per-block shared memory on sm_90

// One layer of the packed weight buffer (built by
// lgteun_tpu_torch/ops/lightnet_kernel.py::_pack). At `off` floats:
// pw [cin][2][coutp], pb [2][coutp], dw [2][coutp][9], db [2][coutp];
// coutp = cout rounded up to kChunk, padded entries zero.
struct Layer {
  int cin, cout, coutp, relu, off;
};

struct Group {
  Layer l[kMaxLayers];
  int n;       // layers in this launch (= halo width)
  int w_off;   // first float of the group's weights in the packed buffer
  int w_len;   // floats of the group's weights
  int cmax;    // most channels any activation of the group has
};

__host__ __device__ inline int layer_len(const Layer& L) {
  return 2 * L.coutp * (L.cin + 11);
}

__host__ inline size_t group_smem(const Group& g) {
  const size_t r0 = kT + 2 * g.n;
  return sizeof(float) * ((size_t)g.w_len + 2 * (size_t)g.cmax * r0 * r0 +
                          2 * (size_t)kChunk * r0 * r0);
}

__global__ void __launch_bounds__(kThreads)
lightnet_group_kernel(const float* __restrict__ in, int in_c,
                      const float* __restrict__ lms,
                      const float* __restrict__ wts, float* __restrict__ out,
                      const Group g, int H, int W, int tiles_x,
                      int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = kT + 2 * g.n;
  float* wsm = smem;                                // g.w_len (16-aligned)
  float* A = wsm + g.w_len;                         // [cmax][r0*r0]
  float* O = A + (size_t)g.cmax * r0 * r0;          // [cmax][r0*r0]
  float* P = O + (size_t)g.cmax * r0 * r0;          // [2][kChunk][r0*r0]

  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = (tile / tiles_x) * kT, x0 = (tile % tiles_x) * kT;
  const size_t HW = (size_t)H * W;

  for (int i = threadIdx.x; i < g.w_len; i += blockDim.x)
    wsm[i] = wts[g.w_off + i];
  {
    const int n0 = r0 * r0;
    const float* src = in + (size_t)b * in_c * HW;
    for (int i = threadIdx.x; i < in_c * n0; i += blockDim.x) {
      const int c = i / n0, p = i % n0;
      const int gy = y0 - g.n + p / r0, gx = x0 - g.n + p % r0;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      A[i] = inside ? src[c * HW + (size_t)gy * W + gx] : 0.f;
    }
  }
  __syncthreads();

  for (int k = 0; k < g.n; ++k) {
    const Layer L = g.l[k];
    const int rin = r0 - 2 * k, rout = rin - 2;
    const int nin = rin * rin, nout = rout * rout;
    const int org = g.n - k;        // region origin offset from the tile
    const float* pw = wsm + (L.off - g.w_off);
    const float* pb = pw + (size_t)L.cin * 2 * L.coutp;
    const float* dw = pb + 2 * L.coutp;
    const float* db = dw + 18 * L.coutp;
    for (int o0 = 0; o0 < L.coutp; o0 += kChunk) {
      // pointwise: 8 channels of one branch at one region pixel
      for (int t = threadIdx.x; t < 2 * nin; t += blockDim.x) {
        const int br = t / nin, p = t % nin;
        const int gy = y0 - org + p / rin, gx = x0 - org + p % rin;
        float* dst = P + (size_t)br * kChunk * nin + p;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
          for (int j = 0; j < kChunk; ++j) dst[j * nin] = 0.f;
          continue;
        }
        float acc[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc[j] = pb[br * L.coutp + o0 + j];
        const float* wrow = pw + br * L.coutp + o0;
        for (int i = 0; i < L.cin; ++i) {
          const float v = A[i * nin + p];
          const float4 wa =
              *reinterpret_cast<const float4*>(wrow + i * 2 * L.coutp);
          const float4 wb =
              *reinterpret_cast<const float4*>(wrow + i * 2 * L.coutp + 4);
          acc[0] = fmaf(v, wa.x, acc[0]);
          acc[1] = fmaf(v, wa.y, acc[1]);
          acc[2] = fmaf(v, wa.z, acc[2]);
          acc[3] = fmaf(v, wa.w, acc[3]);
          acc[4] = fmaf(v, wb.x, acc[4]);
          acc[5] = fmaf(v, wb.y, acc[5]);
          acc[6] = fmaf(v, wb.z, acc[6]);
          acc[7] = fmaf(v, wb.w, acc[7]);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) dst[j * nin] = acc[j];
      }
      __syncthreads();
      // depthwise taps of both branches, biases, ReLU -> O: warps
      // j, j + kChunk, ... take output channel o0 + j, with its 18 taps
      // in registers
      const int j = threadIdx.x / 32 % kChunk, o = o0 + j;
      if (o < L.cout) {
        float k1[9], k2[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          k1[t] = dw[(size_t)o * 9 + t];
          k2[t] = dw[((size_t)L.coutp + o) * 9 + t];
        }
        const float bias = db[o] + db[L.coutp + o];
        const float* p1 = P + (size_t)j * nin;
        const float* p2 = P + ((size_t)kChunk + j) * nin;
        for (int q = threadIdx.x / (32 * kChunk) * 32 + threadIdx.x % 32;
             q < nout; q += 32 * kWarpsPerChannel) {
          const int at = (q / rout) * rin + q % rout;
          float s = bias;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              s = fmaf(p1[at + dy * rin + dx], k1[dy * 3 + dx], s);
              s = fmaf(p2[at + dy * rin + dx], k2[dy * 3 + dx], s);
            }
          O[(size_t)o * nout + q] = L.relu ? fmaxf(s, 0.f) : s;
        }
      }
      __syncthreads();
    }
    float* tmp = A;
    A = O;
    O = tmp;
  }

  // A holds [cout][kT*kT] of the tile; store the in-image part
  const int cout = g.l[g.n - 1].cout;
  for (int i = threadIdx.x; i < cout * kT * kT; i += blockDim.x) {
    const int c = i / (kT * kT), q = i % (kT * kT);
    const int gy = y0 + q / kT, gx = x0 + q % kT;
    if (gy >= H || gx >= W) continue;
    const size_t at = ((size_t)b * cout + c) * HW + (size_t)gy * W + gx;
    out[at] = lms ? A[i] + lms[at] : A[i];
  }
}

}  // namespace

// One launch over layers table[0..n) of the stack (n <= kMaxLayers).
// in [B, in_c, H, W] is the first layer's input; out [B, cout, H, W]
// the last layer's output (cout = table[n-1].cout), plus lms
// [B, cout, H, W] when lms is not null. wts is the packed weight buffer
// of the whole stack on the device; table is a HOST array of n rows
// (cin, cout, coutp, relu, off), read before this call returns.
extern "C" int lgteun_lightnet_group(const float* in, int in_c,
                                     const float* lms, const float* wts,
                                     float* out, const int* table, int n,
                                     int B, int H, int W,
                                     cudaStream_t stream) {
  if (n < 1 || n > kMaxLayers) return (int)cudaErrorInvalidValue;
  Group g{};
  g.n = n;
  g.cmax = in_c;
  for (int k = 0; k < n; ++k) {
    const int* r = table + 5 * k;
    g.l[k] = Layer{r[0], r[1], r[2], r[3], r[4]};
    if (g.l[k].coutp % kChunk || g.l[k].off % 4)
      return (int)cudaErrorInvalidValue;
    g.cmax = std::max({g.cmax, g.l[k].cin, g.l[k].cout});
  }
  if (g.l[0].cin != in_c) return (int)cudaErrorInvalidValue;
  g.w_off = g.l[0].off;
  g.w_len = g.l[n - 1].off + layer_len(g.l[n - 1]) - g.w_off;
  const size_t smem = group_smem(g);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      lightnet_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  lightnet_group_kernel<<<B * tiles_x * tiles_y, kThreads, smem, stream>>>(
      in, in_c, lms, wts, out, g, H, W, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}
