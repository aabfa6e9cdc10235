// LightNet's SpanConv stack for Hopper (sm_90a): two layers a launch over
// 16x16 output tiles, the pointwise convs on the tensor cores (mma.sync
// TF32, 3xTF32), the lms residual on the last launch.
//
// Replaces: lgteun_tpu/ops/lightnet_kernel.py::lightnet_fused_forward
//           (Pallas `_kernel` via `_lightnet_call`).
//
// Each layer is  out = DW1(PW1 x + pb1) + DW2(PW2 x + pb2) + db1 + db2,
// optionally followed by a ReLU; PW are 1x1 convs, DW 3x3 depthwise
// convs whose input is zero outside the image (torch's zero padding; the
// pointwise output there would be the bias, so it is zeroed on every
// layer, ROADMAP C.10). The last layer of the stack adds lms.
//
// What bounds it: at 8 bands a pixel takes 15.4 K multiply-adds, 11.4 K
// of them in the pointwise convs, which now run on the tensor cores: the
// tensor-core bound (the products' 3xTF32 passes at 495 TFLOP/s, the
// depthwise taps and the rest at 67) is 0.018 ms at [4,9,128,128], the
// all-FP32 bound 0.031 ms. This body takes 0.19 ms there (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md §6), a tenth of its bound: clock
// stamps (scripts/torch_kernel_ab.py --stack-phases) put a block's time
// in its products (about 44 %), its depthwise taps (about 32 %), the
// region's staging (15 %) and the two barriers a chunk; at 16 warps an SM
// each phase is bound by instruction issue and latency, not by the tensor
// or FP32 pipes. The earlier body (one 209 KB block of 1024
// threads an SM, the pointwise convs as FP32 FMAs from shared loads,
// launches of 4, 3 and 3 layers) took 0.3556 ms at [4,9,128,128] and
// 1.41 ms for the batch-16 stack on the same card.
//
// Design: five launches of two layers, one block of 256 threads per
// (image, 16x16 tile), two blocks an SM (at most 112,256 bytes of shared
// memory each), so that one block's depthwise phase and barriers overlap
// the other's products. Layer k of a launch works on the tile's region R
// = 16 + 2 (n - k) (20 then 18 pixels a side): its input A [cinp][R*R]
// in shared memory (the first layer's staged by cp.async, zero-filled
// outside the image; channel strides of 8 or 24 mod 32 floats, so that
// the A-fragment loads hit 32 banks), the first layer's output in a
// second buffer, the second's straight to device memory (plus lms on the
// last launch), the layer's depthwise taps and biases in shared memory.
//   Pointwise: per chunk of 4 output channels, both branches' products
// D[16 pixels x 8 columns] = A[16 x cinp] . W[cinp x 8] (columns 0-3
// branch 1, 4-7 branch 2) as mma.sync m16n8k8 with the 3xTF32 split:
// each warp holds its up to 4 M-tiles side by side (independent
// accumulators, straight-line code per tile and k-step count), A split
// into hi/lo as loaded (the lo part passed whole: the tensor core reads
// it truncated), W's hi/lo fragments read from the weight layout
// (`lightnet_fragments`: split once per weight version, in the lanes'
// order), the next chunk's while this chunk's taps run. mma.sync, not
// wgmma: the region shrinks layer by layer (400, 324 pixels) and the M
// granule of 16 wastes at most 15 pixels where wgmma's 64 would waste up
// to 60. The bias is added and the pixels outside the image set to 0 as
// the accumulators go to P [8][R*R] (stride = 4 mod 32: conflict-free).
//   Depthwise (FP32 cores): each thread takes one channel of the chunk
// and a strip of up to 3 rows of two adjacent output columns, the 18 taps
// and two biases in registers, the 3 x 4 windows of both branches slid
// down the strip, each new row read as two float2; per output each
// branch's sum from its bias over the taps, then the two added, the ReLU,
// and the output to the next buffer (a float2) or to device memory.
// Ragged tiles (H or W not a multiple of 16) are masked on load and
// store.
//   A variant with one 512-thread block an SM holding every channel's
// pointwise output (A split once a layer, two barriers a layer) ran 1.5x
// faster at [1,9,72,100] but 5 % slower at [4,9,128,128] (two rounds of
// blocks; PERF.md §6); not kept.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc_tf32.cuh"

// Clock stamps of the phases (thread 0 of each block), read by
// lgteun_read_lightnet_stamps: only where LGTEUN_LIGHTNET_STAMPS (the
// blocks stamped) is defined, as scripts/torch_kernel_ab.py
// --stack-phases does. Phases: 0 staging the region, 1 the products
// (with the taps' loads issued), 2 the barrier after them, 3 the
// depthwise taps, 4 the barrier after them; 5 the chunks; 6, 7 the
// block's start and end on the global timer (ns); 8 its SM; 9 its clocks.
#ifdef LGTEUN_LIGHTNET_STAMPS
__device__ long long lgteun_lightnet_stamps[LGTEUN_LIGHTNET_STAMPS][10];
extern "C" int lgteun_read_lightnet_stamps(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, lgteun_lightnet_stamps,
                                   sizeof(lgteun_lightnet_stamps));
}
#endif

namespace {

#ifdef LGTEUN_LIGHTNET_STAMPS
struct Stamps {
  long long* ph;  // [10], then the last stamp
  __device__ Stamps() {
    __shared__ long long st[11];
    ph = st;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 10; ++i) ph[i] = 0;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ph[6]));
      ph[10] = ph[9] = clock64();
    }
  }
  __device__ void at(int i) const {
    if (threadIdx.x == 0) {
      const long long n = clock64();
      ph[i] += n - ph[10];
      ph[5] += i == 1;
      ph[10] = n;
    }
  }
  __device__ void end() const {
    if (threadIdx.x == 0 && blockIdx.x < LGTEUN_LIGHTNET_STAMPS) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      ph[9] = clock64() - ph[9];
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ph[7]));
      ph[8] = sm;
      for (int i = 0; i < 10; ++i)
        lgteun_lightnet_stamps[blockIdx.x][i] = ph[i];
    }
  }
};
#else
struct Stamps {
  __device__ void at(int) const {}
  __device__ void end() const {}
};
#endif

constexpr int kT = 16;            // output tile edge
constexpr int kChunk = 4;         // output channels of a chunk, per branch
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 10;
constexpr int kMaxKSteps = 4;     // cinp <= 32
constexpr int kMTiles = 4;        // M-tiles a warp holds: 4 x 8 x 16 >= 20^2
constexpr int kMaxRows = 8;       // rows of a depthwise strip
constexpr int kSmemMax = 232448;  // per-block shared memory on sm_90

// One layer of the weight layout (built by
// lgteun_tpu_torch/ops/lightnet_kernel.py::lightnet_fragments). At `off`
// floats: frag [coutp/4][cinp/8][32 lanes][4] = {b0 hi, b1 hi, b0 lo,
// b1 lo} of chunk q's k-step ks for lane 4g + t (b0 = W[8 ks + t][g], b1 =
// W[8 ks + t + 4][g], column g: branch g / 4, channel 4 q + g % 4), then
// pb [coutp/4][8] in column order, dw [2][coutp][9], db [2][coutp];
// cinp = cin and coutp = cout rounded up to 8, the padding zero.
struct Layer {
  int cin, cout, coutp, relu, off;
};

struct Group {
  Layer l[kMaxLayers];
  int n;              // layers in this launch (= halo width)
  int buf[2];         // floats of the two activation buffers
};

__host__ __device__ inline int ceil8(int v) { return (v + 7) / 8 * 8; }

// channel stride of a region of r x r pixels: its 16-pixel M-tiles
// rounded up to 8 or 24 mod 32 floats (lane 4g + t of an A-fragment load
// reads t cs + g: 32 banks)
__host__ __device__ inline int act_stride(int r) {
  const int m = (r * r + 15) / 16 * 16;
  return m + (8 - m % 16 + 16) % 16;
}

// P's channel stride for a first region of r0 x r0: = 4 mod 32 floats
__host__ __device__ inline int p_stride(int r0) {
  const int m = (r0 * r0 + 15) / 16 * 16;
  return m + ((4 - m % 32) + 32) % 32;
}

// the two activation buffers, P and the layer's depthwise taps and biases
// (at most 20 coutp floats)
__host__ inline size_t group_smem(const Group& g) {
  const int r0 = kT + 2 * g.n;
  int taps = 0;
  for (int k = 0; k < g.n; ++k) taps = std::max(taps, 20 * g.l[k].coutp);
  return sizeof(float) * ((size_t)g.buf[0] + g.buf[1] +
                          2 * kChunk * (size_t)p_stride(r0) + taps);
}

// chunk q's B fragments (hi, lo) of a layer for this lane
__device__ __forceinline__ void load_b(const float* frag, int q, int ksteps,
                                       int lane,
                                       uint32_t (&bh)[kMaxKSteps][2],
                                       uint32_t (&bl)[kMaxKSteps][2]) {
  const float4* fq =
      reinterpret_cast<const float4*>(frag) + (size_t)q * ksteps * 32;
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    if (ks >= ksteps) break;
    const float4 f = __ldg(fq + ks * 32 + lane);
    bh[ks][0] = __float_as_uint(f.x);
    bh[ks][1] = __float_as_uint(f.y);
    bl[ks][0] = __float_as_uint(f.z);
    bl[ks][1] = __float_as_uint(f.w);
  }
}

struct PointwiseArgs {
  const float* A;   // the layer's input [cinp][cs]
  int cs;
  float* P;         // [8][ps]
  int ps, warp, gq, tq;
  float pb0, pb1;   // the biases of columns 2 tq, 2 tq + 1
  uint32_t in_img;  // bit 2 i + h: row h of tile i lies in the image
};

// NT M-tiles (warp + kWarps i) of KS k-steps: the products with the
// 3xTF32 split, the bias, the zeros outside the image, into P
template <int NT, int KS>
__device__ __forceinline__ void pointwise(const PointwiseArgs& a,
                                          const uint32_t (&bh)[kMaxKSteps][2],
                                          const uint32_t (&bl)[kMaxKSteps][2]) {
  float d[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float* v =
          a.A + (ks * 8 + a.tq) * a.cs + (a.warp + kWarps * i) * 16 + a.gq;
      uint32_t ah[4], al[4];
      split_tf32_trunc(v[0], ah[0], al[0]);
      split_tf32_trunc(v[8], ah[1], al[1]);
      split_tf32_trunc(v[4 * a.cs], ah[2], al[2]);
      split_tf32_trunc(v[4 * a.cs + 8], ah[3], al[3]);
      mma3_sync(d[i], ah, al, bh[ks][0], bh[ks][1], bl[ks][0], bl[ks][1]);
    }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (a.warp + kWarps * i) * 16 + a.gq + 8 * h;
      const bool inside = a.in_img >> (2 * i + h) & 1u;
      a.P[(2 * a.tq) * a.ps + p] = inside ? d[i][2 * h] + a.pb0 : 0.f;
      a.P[(2 * a.tq + 1) * a.ps + p] = inside ? d[i][2 * h + 1] + a.pb1 : 0.f;
    }
}

template <int NT>
__device__ __forceinline__ void pointwise_k(
    const PointwiseArgs& a, int ksteps, const uint32_t (&bh)[kMaxKSteps][2],
    const uint32_t (&bl)[kMaxKSteps][2]) {
  switch (ksteps) {
    case 4: pointwise<NT, 4>(a, bh, bl); break;
    case 3: pointwise<NT, 3>(a, bh, bl); break;
    case 2: pointwise<NT, 2>(a, bh, bl); break;
    case 1: pointwise<NT, 1>(a, bh, bl); break;
    default: break;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
lightnet_group_kernel(const float* __restrict__ in, int in_c,
                      const float* __restrict__ lms,
                      const float* __restrict__ wts, float* __restrict__ out,
                      const Group g, int H, int W, int tiles_x,
                      int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = kT + 2 * g.n;
  const int ps = p_stride(r0);
  float* const buf0 = smem;
  float* const buf1 = smem + g.buf[0];
  float* P = smem + g.buf[0] + g.buf[1];   // [8][ps]
  float* taps = P + 2 * kChunk * ps;       // dw [2][coutp][9], db [2][coutp]

  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = (tile / tiles_x) * kT, x0 = (tile % tiles_x) * kT;
  const size_t HW = (size_t)H * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const Stamps stamps;

  // the first layer's input over the region, 0 outside the image and in
  // the padded channels: a warp a region row (lane = column, r0 <= 32),
  // every copy in flight at once (cp.async, zero-filled outside)
  {
    const int cs = act_stride(r0);
    const float* src = in + (size_t)b * in_c * HW;
    const int gx = x0 - g.n + lane;
    const bool col_in = gx >= 0 && gx < W;
    if (lane < r0)
      for (int c = 0; c < ceil8(g.l[0].cin); ++c)
        for (int yy = warp; yy < r0; yy += kWarps) {
          const int gy = y0 - g.n + yy;
          const bool ok = c < in_c && col_in && gy >= 0 && gy < H;
          cp_async4_zfill(buf0 + c * cs + yy * r0 + lane,
                          ok ? src + c * HW + (size_t)gy * W + gx : src, ok);
        }
    cp_async_wait_all();
  }
  __syncthreads();
  stamps.at(0);

  for (int k = 0; k < g.n; ++k) {
    const Layer L = g.l[k];
    const bool last = k == g.n - 1;
    const int rin = r0 - 2 * k, rout = rin - 2;
    const int nin = rin * rin, mtiles = (nin + 15) / 16;
    const int cs = act_stride(rin), cs_out = act_stride(rout);
    const int ksteps = ceil8(L.cin) / 8;
    const int org = g.n - k;   // region origin offset from the tile
    const float* A = (k & 1) ? buf1 : buf0;
    float* O = (k & 1) ? buf0 : buf1;
    const float* frag = wts + L.off;
    const float* pb = frag + (size_t)L.coutp / kChunk * ksteps * 128;
    const float* dw = pb + 2 * L.coutp;   // then db: 20 coutp floats
    // depthwise item of this thread: channel j of the chunk, the column
    // pair x, x + 1 (rout is even), strip s of rows [ya, yb)
    const int pairs = rout / 2;
    const int strips = max(1, kThreads / (kChunk * pairs));
    const int rows = (rout + strips - 1) / strips;
    const int item = threadIdx.x;
    const bool has_item = item < kChunk * strips * pairs;
    const int x = 2 * (item % pairs), js = item / pairs;
    const int j = js / strips, s = js - j * strips;
    const int ya = s * rows, yb = min(rout, ya + rows);
    // bit 2 i + h: this lane's row h of M-tile warp + kWarps i lies in the
    // region and the image
    uint32_t in_img = 0;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (warp + kWarps * i) * 16 + gq + 8 * h;
        const int py = p / rin, px = p - py * rin;
        const int gy = y0 - org + py, gx = x0 - org + px;
        if (p < nin && gy >= 0 && gy < H && gx >= 0 && gx < W)
          in_img |= 1u << (2 * i + h);
      }

    // the layer's depthwise taps and biases (read after the first
    // chunk's barrier)
    for (int i = threadIdx.x; i < 20 * L.coutp; i += kThreads)
      taps[i] = __ldg(dw + i);

    uint32_t bh[kMaxKSteps][2], bl[kMaxKSteps][2];
    load_b(frag, 0, ksteps, lane, bh, bl);
    for (int q = 0; q < L.coutp / kChunk; ++q) {
      const int o = q * kChunk + j;

      // pointwise on the tensor cores: P[col][p] = (A . W)[p][col] + pb,
      // 0 outside the image; a warp's M-tiles mt = warp + kWarps i side
      // by side (independent accumulators), unrolled for its tile and
      // k-step counts
      {
        const float pb0 = __ldg(pb + q * 8 + 2 * tq);
        const float pb1 = __ldg(pb + q * 8 + 2 * tq + 1);
        const PointwiseArgs pa{A, cs, P, ps, warp, gq, tq, pb0, pb1, in_img};
        switch ((mtiles - warp + kWarps - 1) / kWarps) {
          case 4: pointwise_k<4>(pa, ksteps, bh, bl); break;
          case 3: pointwise_k<3>(pa, ksteps, bh, bl); break;
          case 2: pointwise_k<2>(pa, ksteps, bh, bl); break;
          case 1: pointwise_k<1>(pa, ksteps, bh, bl); break;
          default: break;
        }
      }
      stamps.at(1);
      __syncthreads();
      stamps.at(2);
      // the next chunk's B fragments, loaded while the taps run
      if (q + 1 < L.coutp / kChunk) load_b(frag, q + 1, ksteps, lane, bh, bl);

      // depthwise taps of both branches, biases, ReLU: a row of the
      // strip at a time, two columns side by side; per output each
      // branch's sum from its bias over the taps, then the two added; the
      // 3 x 4 window of each branch slid down the strip, each new row read
      // as two float2
      if (has_item) {
        float k1[9], k2[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          k1[t] = taps[o * 9 + t];
          k2[t] = taps[(L.coutp + o) * 9 + t];
        }
        const float bias1 = taps[18 * L.coutp + o];
        const float bias2 = taps[19 * L.coutp + o];
        const float* p1 = P + j * ps + x;
        const float* p2 = P + (kChunk + j) * ps + x;
        float w1[3][4], w2[3][4];
        const auto row4 = [](const float* p, float (&w)[4]) {
          const float2 a = *reinterpret_cast<const float2*>(p);
          const float2 c = *reinterpret_cast<const float2*>(p + 2);
          w[0] = a.x;
          w[1] = a.y;
          w[2] = c.x;
          w[3] = c.y;
        };
        row4(p1 + ya * rin, w1[0]);
        row4(p2 + ya * rin, w2[0]);
        row4(p1 + (ya + 1) * rin, w1[1]);
        row4(p2 + (ya + 1) * rin, w2[1]);
#pragma unroll
        for (int it = 0; it < kMaxRows; ++it) {
          const int y = ya + it;
          if (y >= yb) break;
          row4(p1 + (y + 2) * rin, w1[2]);
          row4(p2 + (y + 2) * rin, w2[2]);
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v1 = bias1, v2 = bias2;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                v1 = fmaf(w1[dy][c + dx], k1[dy * 3 + dx], v1);
                v2 = fmaf(w2[dy][c + dx], k2[dy * 3 + dx], v2);
              }
            v[c] = v1 + v2;
            if (L.relu) v[c] = fmaxf(v[c], 0.f);
          }
          if (!last) {
            *reinterpret_cast<float2*>(O + o * cs_out + y * rout + x) =
                make_float2(v[0], v[1]);
          } else if (o < L.cout) {
            const int gy = y0 + y, gx = x0 + x;
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (gy < H && gx + c < W) {
                const size_t at = ((size_t)b * L.cout + o) * HW +
                                  (size_t)gy * W + gx + c;
                out[at] = lms ? v[c] + __ldg(lms + at) : v[c];
              }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            w1[0][c] = w1[1][c];
            w1[1][c] = w1[2][c];
            w2[0][c] = w2[1][c];
            w2[1][c] = w2[2][c];
          }
        }
      }
      stamps.at(3);
      __syncthreads();
      stamps.at(4);
    }
  }
  stamps.end();
}

}  // namespace

// The weight layout this library reads (lightnet_fragments): 2; the
// packed FP32 rows of earlier versions had no such function.
extern "C" int lgteun_lightnet_layout() { return 2; }

// One launch over layers table[0..n) of the stack (n <= kMaxLayers).
// in [B, in_c, H, W] is the first layer's input; out [B, cout, H, W]
// the last layer's output (cout = table[n-1].cout), plus lms
// [B, cout, H, W] when lms is not null. wts is the weight layout of the
// whole stack on the device; table is a HOST array of n rows (cin, cout,
// coutp, relu, off), read before this call returns.
extern "C" int lgteun_lightnet_group(const float* in, int in_c,
                                     const float* lms, const float* wts,
                                     float* out, const int* table, int n,
                                     int B, int H, int W,
                                     cudaStream_t stream) {
  if (n < 1 || n > kMaxLayers) return (int)cudaErrorInvalidValue;
  Group g{};
  g.n = n;
  for (int k = 0; k < n; ++k) {
    const int* r = table + 5 * k;
    g.l[k] = Layer{r[0], r[1], r[2], r[3], r[4]};
    const Layer& L = g.l[k];
    if (L.cin < 1 || L.cin > 8 * kMaxKSteps || L.coutp != ceil8(L.cout) ||
        L.off % 4 || (k > 0 && L.cin != g.l[k - 1].cout))
      return (int)cudaErrorInvalidValue;
    // layer k's input: buffer k % 2 over its region
    const int need = ceil8(L.cin) * act_stride(kT + 2 * (n - k));
    g.buf[k & 1] = std::max(g.buf[k & 1], need);
  }
  // a warp's kMTiles M-tiles cover the first region, a region row fits a
  // warp, and a depthwise strip has at most kMaxRows rows
  const int r0 = kT + 2 * n, rout0 = r0 - 2;
  const int strips0 = std::max(1, kThreads / (kChunk * rout0 / 2));
  if (g.l[0].cin != in_c || (r0 * r0 + 15) / 16 > kWarps * kMTiles ||
      r0 > 32 || (rout0 + strips0 - 1) / strips0 > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = group_smem(g);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lightnet_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory: two blocks fit
  err = cudaFuncSetAttribute(lightnet_group_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  lightnet_group_kernel<<<B * tiles_x * tiles_y, kThreads, smem, stream>>>(
      in, in_c, lms, wts, out, g, H, W, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}
