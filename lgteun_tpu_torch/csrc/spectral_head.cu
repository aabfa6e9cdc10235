// LGB mixer head and global mixer for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/spectral_kernel.py::fused_ln_mixer_head_cm
//           (Pallas `_head_kernel` + `mixer_body`): channel LayerNorm,
//           split, and the FFT amplitude/phase mixer on the second half;
//           lgteun_tpu/ops/spectral_kernel.py::fused_global_mixer_cm
//           (Pallas `_kernel`): the mixer alone, without the LN.
//
// What bounds it here: not HBM. One 128x128 f32 plane is 64 KB in and
// 64 KB out (about 40 ns of the card's 3.35 TB/s), while its 2-D FFT pair
// makes some ten passes over the plane in shared memory, each behind a
// barrier, plus an atan2f/sincosf per half-spectrum bin: latency of
// shared memory and barriers, and the FP32 issue of the passes, bound it.
//
// Design (the TPU kernel's DFT-as-matmul, polynomial atan2 and sin/cos are
// not carried over; the FFT itself is in fft_mixer.cuh):
//  1. ln_split_kernel (head only): one thread per pixel; reads the C
//     channels (coalesced across pixels) once where a plane has 2^16
//     pixels or more (up to 64 held in registers, a kernel for each bound
//     16, 32, 64), else three times, which timed faster on the model's
//     tiles; writes y1 and the normalised second half into y2, which
//     step 2 transforms.
//  2. fft_mixer_kernel: one block per (image, channel) plane, its half
//     spectrum in shared memory (H (W/2 + 1) complex values, 66.6 KB at
//     128^2: two 256-thread blocks an SM, so batch 16 at 128^2 is one
//     wave; 512 threads a block where the planes are fewer than the SMs),
//     read from `in` and written to `out` (the head passes x2 as both),
//     the real rows transformed as N = W/2 complex points, the passes in
//     registers, one barrier a pass (odd W: W complex points, fft_mixer.cuh).
//     It takes a plane whose half spectrum fits in shared memory
//     (fft_mixer_smem <= 232,448 bytes: up to 240 x 240).
//  2c. the cluster route, for a larger plane whose half spectrum the
//     shared memory of a thread-block cluster holds (fft_cluster_plan:
//     the smallest K of 2, 4, 8, 16 whose blocks each hold H / K rows of
//     it and a stage of columns; up to 512^2 at K = 8 and 1024 x 512 at
//     K = 16): fft_mixer_cluster_kernel, one launch, one cluster of K
//     512-thread blocks a plane, one block an SM. Each block runs the W
//     forward of its rows, then its N / K columns a chunk at a time,
//     gathered from the other blocks' rows through distributed shared
//     memory and scattered back, then the W inverse of its rows: the half
//     spectrum never leaves the cluster's shared memory, where the global
//     route crossed HBM with it four times between three launches.
//  2g. the global-memory route, for a plane no cluster holds (1024^2 and
//     up; any H <= 14,514 and W <= 29,026, odd W <= 14,513, at any
//     factorization): the half spectrum in a scratch the caller passes,
//     stored column by column ([planes][W/2 + 1][H]), and three launches
//     on the parts of FftPlaneOf: fft_rows_forward_kernel (a range of rows
//     a block: W forward and split, written out column-wise, each column
//     of the block's rows one run), fft_columns_kernel (a range of
//     columns a block: one contiguous run of the scratch in and out,
//     staged column by column; H forward, amp/phase, H inverse) and
//     fft_rows_inverse_kernel (a range of rows read back column-wise:
//     c2r, W inverse, |.| into `out`); 256-thread blocks, two an SM,
//     where a row (a column) fits half of the shared memory, else 512,
//     one an SM; the lines a block split evenly over whole waves
//     (fft_global_split); the scratch staged with cp.async, every copy
//     of a thread in flight at once; parts (b) and (c) launched as
//     programmatic dependents of the part before. Every route runs the
//     same plan, tables and butterflies as the one-block body;
//     launch_fft_mixer picks the route by the plane's shape
//     (fft_mixer_route).
//  2a. every route's kernels in two forms (FftPlaneOf): planes of even
//     width whose radices are at most kFftMaxPrime, the model's tiles
//     among them, here; planes of odd width or with a larger radix in
//     spectral_head_any.cu (fft_mixer_any), so that the first form
//     holds none of the second's code (compiled in, its calls raised
//     every kernel's stack from 32-80 bytes to 288-568 and its spills).
//  3. fft_tables_kernel: the twiddle and position tables of one (H, W),
//     made once per size by the wrapper (`lgteun_fft_tables`) and read by
//     every plane of every launch.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_mixer.cuh"

namespace {

constexpr int kThreadsLN = 256;
// The pixels a plane needs for the LN split to hold its channels in
// registers (ln_split_held): on an NVIDIA H100 80GB HBM3 at 700.00 W it
// took B1's split from 0.149 to 0.100 ms at [1,32,1024²] and was faster
// from 256² up, but 15-83 % slower at the model's tiles, 64²-144² at
// batch 4 (scripts/torch_kernel_ab.py against the three reads).
constexpr int kLnHeldPixels = 1 << 16;

// ln_split_pixels<1> on pixel p of image b with its C <= kMaxC channels
// read once and held in registers (the same sums in the same order, so
// the same bits): ln_split_pixels reads x three times, once for the
// mean, once for the variance and once for the output.
template <int kMaxC, class TX, class TY>
__device__ __forceinline__ void ln_split_held(
    const TX* x, const float* ln_w, const float* ln_b, TY* y1, float* y2,
    int C, int HW, int b, int p, float eps) {
  const TX* xb = x + (size_t)b * C * HW + p;
  float v[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) v[c] = load_plain(xb + (size_t)c * HW);
  float mu = 0.f, var = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) mu += v[c];
  mu /= (float)C;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) {
      const float d = v[c] - mu;
      var += d * d;
    }
  const float r = rsqrtf(var / (float)C + eps);
  const int C2 = C / 2;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) {
      const float y = (v[c] - mu) * r * ln_w[c] + ln_b[c];
      if (c < C2)
        store_act(y1 + ((size_t)b * C2 + c) * HW + p, y);
      else
        y2[((size_t)b * C2 + (c - C2)) * HW + p] = y;
    }
}

// x, y1 in their storage types (loads.cuh), y2 float; kMaxC > 0: the C
// <= kMaxC channels held in registers (ln_split_held; a kernel of its
// own for each kMaxC, so that fewer channels keep fewer registers and
// more threads in flight), 0: read three times (ln_split_pixels).
template <int kMaxC, class TX, class TY>
__global__ void __launch_bounds__(kThreadsLN)
ln_split_kernel(const TX* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, TY* __restrict__ y1,
                float* __restrict__ y2, int C, int HW, float eps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  if constexpr (kMaxC > 0)
    ln_split_held<kMaxC>(x, ln_w, ln_b, y1, y2, C, HW, blockIdx.y, p, eps);
  else
    ln_split_pixels<1>(x, ln_w, ln_b, y1, y2, C, HW, blockIdx.y, p, 0, HW,
                      eps);
}

// 8 bytes global -> shared, asynchronously (the global route's staging:
// every copy of a thread in flight at once), and the wait for them.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Programmatic dependent launch (Hopper) between the global route's
// parts: a part lets the next one launch once all its blocks have begun,
// so that the next part's blocks take the SMs its last wave leaves idle
// and load their plan meanwhile; the next part waits for the whole of
// the previous one, its writes visible, before it reads the scratch.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// `in` and `out` may alias (no __restrict__): every plane is read whole
// into shared memory before any of it is written. 256 threads, two
// blocks an SM, where the planes fill the card (three blocks at 80
// registers a thread spilled and were no faster); 512 threads, one block
// an SM, where there are fewer planes than SMs. Both allow 128 registers
// a thread, as lgb_block.cu does.
template <int kThreads, int kBlocksPerSM, class TI, class TO, bool kAny>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fft_mixer_kernel(const TI* in, TO* out, const float* __restrict__ amp_w,
                 const float* __restrict__ amp_b,
                 const float* __restrict__ pha_w,
                 const float* __restrict__ pha_b,
                 const float* __restrict__ tables, int C, int HW) {
  extern __shared__ float2 smem[];
  const int plane = blockIdx.x;   // b * C + c
  const int c = plane % C;
  const size_t off = (size_t)plane * HW;
  fft_mixer_plane<TI, TO, kAny>(in + off, out + off, smem, tables, amp_w[c],
                                amp_b[c], pha_w[c], pha_b[c]);
}

// The same with a cluster of two blocks on each plane
// (fft_mixer_plane_pair), where twice the planes still fit on the SMs.
template <class TI, class TO, bool kAny>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(512, 1)
fft_mixer_pair_kernel(const TI* in, TO* out,
                      const float* __restrict__ amp_w,
                      const float* __restrict__ amp_b,
                      const float* __restrict__ pha_w,
                      const float* __restrict__ pha_b,
                      const float* __restrict__ tables, int C, int HW) {
  extern __shared__ float2 smem[];
  const int plane = blockIdx.x / 2;   // b * C + c
  const int c = plane % C;
  const size_t off = (size_t)plane * HW;
  fft_mixer_plane_pair<TI, TO, kAny>(in + off, out + off, smem, tables,
                                     amp_w[c], amp_b[c], pha_w[c], pha_b[c]);
}

// The cluster route (fft_cluster_plan): one plane a cluster of K blocks
// (K from the launch's cluster dimension), each holding its share of the
// half spectrum (fft_mixer_plane_cluster); 512 threads, one block an SM.
constexpr int kFftClusterThreads = 512;

template <class TI, class TO, bool kAny>
__global__ void __launch_bounds__(kFftClusterThreads, 1)
fft_mixer_cluster_kernel(const TI* in, TO* out,
                         const float* __restrict__ amp_w,
                         const float* __restrict__ amp_b,
                         const float* __restrict__ pha_w,
                         const float* __restrict__ pha_b,
                         const float* __restrict__ tables, int C, int HW,
                         int rows, int cols, int chunk, int pitch) {
  extern __shared__ float2 smem[];
  const int plane =
      blockIdx.x / (int)cooperative_groups::this_cluster().num_blocks();
  const int c = plane % C;
  const size_t off = (size_t)plane * HW;
  fft_mixer_plane_cluster<TI, TO, kAny>(in + off, out + off, smem, tables,
                                        rows, cols, chunk, pitch, amp_w[c],
                                        amp_b[c], pha_w[c], pha_b[c]);
}

// The global route (fft_global_plan), part (a): W forward and split of
// rows [r0, r0 + rows) of one plane a block, written column by column
// into spec [planes][W/2 + 1][H] (column c of the half spectrum as the
// one-block body holds it: bins 0..N-1 at fft_pos(row, k), N at N; odd W
// bin k at k): consecutive threads on consecutive rows of a column, so
// each column of the block's rows is one run of rows x 8 bytes.
template <int kThreads, int kBlocks, class TI, bool kAny>
__global__ void __launch_bounds__(kThreads, kBlocks)
fft_rows_forward_kernel(const TI* in, float2* __restrict__ spec,
                        const float* __restrict__ tables, int rows,
                        int row_blocks) {
  extern __shared__ float2 smem[];
  launch_dependents();
  FftPlaneOf<kAny> plane(tables, smem);
  plane.load_plan();
  __syncthreads();
  const int H = plane.get(plane.plan().col.n), W = plane.width();
  const int ld = plane.get(plane.plan().ld), half = plane.cols();
  const int p = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x - p * row_blocks) * rows;
  const int nr = min(rows, H - r0);
  plane.buf = plane.A + rows * ld;
  plane.rows_forward(in + ((size_t)p * H + r0) * W, plane.A, nr);
  __syncthreads();
  float2* dst = spec + (size_t)p * half * H + r0;
  const FftDiv nr_div(nr);
#pragma unroll 4
  for (int i = threadIdx.x; i < nr * half; i += blockDim.x) {
    const int c = nr_div(i), r = i - c * nr;
    dst[(size_t)c * H + r] = plane.A[r * ld + c];
  }
}

// Part (b): columns [c0, c0 + cols) of one plane a block: one contiguous
// run of cols x H values of spec, staged column by column with the odd
// pitch `pitch` (each column's passes on neighbouring elements, as a
// row's): H forward, amp/phase (channel plane % C), H inverse, back into
// spec the same way.
template <int kThreads, int kBlocks, bool kAny>
__global__ void __launch_bounds__(kThreads, kBlocks)
fft_columns_kernel(float2* __restrict__ spec,
                   const float* __restrict__ amp_w,
                   const float* __restrict__ amp_b,
                   const float* __restrict__ pha_w,
                   const float* __restrict__ pha_b,
                   const float* __restrict__ tables, int C, int cols,
                   int pitch, int col_blocks) {
  extern __shared__ float2 smem[];
  launch_dependents();
  FftPlaneOf<kAny> plane(tables, smem);
  plane.load_plan();
  __syncthreads();
  const int H = plane.get(plane.plan().col.n), half = plane.cols();
  const int p = blockIdx.x / col_blocks, c = p % C;
  const int c0 = (blockIdx.x - p * col_blocks) * cols;
  const int nc = min(cols, half - c0);
  plane.buf = plane.A + cols * pitch;
  float2* src = spec + ((size_t)p * half + c0) * H;
  const FftDiv h_div(H);
  wait_for_prerequisites();
#pragma unroll 4
  for (int i = threadIdx.x; i < nc * H; i += blockDim.x) {
    const int k = h_div(i);
    cp_async8(plane.A + k * pitch + i - k * H, src + i);
  }
  cp_async_wait_all();
  __syncthreads();
  plane.columns_in(plane.A, pitch, 1, c0, nc, amp_w[c], amp_b[c], pha_w[c],
                   pha_b[c]);
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < nc * H; i += blockDim.x) {
    const int k = h_div(i);
    src[i] = plane.A[k * pitch + i - k * H];
  }
}

// Part (c): rows [r0, r0 + rows) of one plane a block read back column by
// column from spec, then the c2r, W inverse and |.| / (H W) into out
// (rounded once to TO as stored).
template <int kThreads, int kBlocks, class TO, bool kAny>
__global__ void __launch_bounds__(kThreads, kBlocks)
fft_rows_inverse_kernel(const float2* __restrict__ spec, TO* out,
                        const float* __restrict__ tables, int rows,
                        int row_blocks) {
  extern __shared__ float2 smem[];
  FftPlaneOf<kAny> plane(tables, smem);
  plane.load_plan();
  __syncthreads();
  const int H = plane.get(plane.plan().col.n), W = plane.width();
  const int ld = plane.get(plane.plan().ld), half = plane.cols();
  const int p = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x - p * row_blocks) * rows;
  const int nr = min(rows, H - r0);
  plane.buf = plane.A + rows * ld;
  const float2* src = spec + (size_t)p * half * H + r0;
  const FftDiv nr_div(nr);
  wait_for_prerequisites();
#pragma unroll 4
  for (int i = threadIdx.x; i < nr * half; i += blockDim.x) {
    const int c = nr_div(i), r = i - c * nr;
    cp_async8(plane.A + r * ld + c, src + (size_t)c * H + r);
  }
  cp_async_wait_all();
  __syncthreads();
  plane.rows_inverse(out + ((size_t)p * H + r0) * W, plane.A, nr);
}

// The SMs of the current device, or 0 with the error in *err.
inline int device_sms(cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The parts of the global route at kThreads threads a block, kBlocks an
// SM (fft_global_plan's row_threads / col_threads: 256 and 2, or 512 and
// 1).
template <int kThreads, int kBlocks, bool kAny, class TI>
cudaError_t launch_rows_forward(const TI* in, float2* spec,
                                const float* tables, const FftGlobalPlan& g,
                                int grid, cudaStream_t stream) {
  auto* kernel = fft_rows_forward_kernel<kThreads, kBlocks, TI, kAny>;
  const cudaError_t err = allow_smem(kernel, g.smem_rows);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, g.smem_rows, stream>>>(in, spec, tables, g.rows,
                                                  g.row_blocks);
  return cudaGetLastError();
}

// A launch of `kernel` that may begin before the previous kernel of the
// stream ends (programmatic dependent launch: the kernel waits for it
// with griddepcontrol.wait before reading what it wrote).
template <class Kernel, class... Args>
cudaError_t launch_dependent(Kernel* kernel, int grid, int threads,
                             size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int kThreads, int kBlocks, bool kAny>
cudaError_t launch_columns(float2* spec, const float* amp_w,
                           const float* amp_b, const float* pha_w,
                           const float* pha_b, const float* tables, int C,
                           const FftGlobalPlan& g, int grid,
                           cudaStream_t stream) {
  auto* kernel = fft_columns_kernel<kThreads, kBlocks, kAny>;
  const cudaError_t err = allow_smem(kernel, g.smem_cols);
  if (err != cudaSuccess) return err;
  return launch_dependent(kernel, grid, kThreads, g.smem_cols, stream, spec,
                          amp_w, amp_b, pha_w, pha_b, tables, C, g.cols,
                          g.pitch, g.col_blocks);
}

template <int kThreads, int kBlocks, bool kAny, class TO>
cudaError_t launch_rows_inverse(const float2* spec, TO* out,
                                const float* tables, const FftGlobalPlan& g,
                                int grid, cudaStream_t stream) {
  auto* kernel = fft_rows_inverse_kernel<kThreads, kBlocks, TO, kAny>;
  const cudaError_t err = allow_smem(kernel, g.smem_rows);
  if (err != cudaSuccess) return err;
  return launch_dependent(kernel, grid, kThreads, g.smem_rows, stream, spec,
                          out, tables, g.rows, g.row_blocks);
}

// The global route on B * C planes: parts (a), (b), (c) in three launches
// on `scratch` (B C (W/2 + 1) H float2, fft_global_plan).
template <bool kAny, class TI, class TO>
int launch_fft_mixer_global(const TI* in, TO* out, const float* amp_w,
                            const float* amp_b, const float* pha_w,
                            const float* pha_b, const float* tables,
                            float* scratch, int B, int C, int H, int W,
                            cudaStream_t stream) {
  FftGlobalPlan g;
  const long long planes = (long long)B * C;
  cudaError_t err = cudaSuccess;
  const int sms = device_sms(&err);
  if (err != cudaSuccess) return (int)err;
  if (!fft_global_plan(H, W, planes, sms, &g) || scratch == nullptr ||
      planes * g.row_blocks > 0x7fffffffLL ||
      planes * g.col_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float2* spec = reinterpret_cast<float2*>(scratch);
  const int row_grid = (int)(planes * g.row_blocks);
  const int col_grid = (int)(planes * g.col_blocks);
  const bool rows2 = g.row_threads == 256, cols2 = g.col_threads == 256;
  err = rows2 ? launch_rows_forward<256, 2, kAny>(in, spec, tables, g,
                                                row_grid, stream)
              : launch_rows_forward<512, 1, kAny>(in, spec, tables, g,
                                                row_grid, stream);
  if (err == cudaSuccess)
    err = cols2 ? launch_columns<256, 2, kAny>(spec, amp_w, amp_b, pha_w,
                                               pha_b, tables, C, g, col_grid,
                                               stream)
                : launch_columns<512, 1, kAny>(spec, amp_w, amp_b, pha_w,
                                               pha_b, tables, C, g, col_grid,
                                               stream);
  if (err == cudaSuccess)
    err = rows2 ? launch_rows_inverse<256, 2, kAny>(spec, out, tables, g,
                                                    row_grid, stream)
                : launch_rows_inverse<512, 1, kAny>(spec, out, tables, g,
                                                    row_grid, stream);
  return (int)err;
}

// The cluster route on B * C planes: one launch of B C clusters of k
// blocks (fft_cluster_plan). Clusters above 8 blocks are allowed as
// non-portable; a k whose clusters cannot be resident
// (cudaOccupancyMaxActiveClusters 0) is refused, and so is a launch the
// runtime refuses: the error goes back to the caller, no other route is
// taken.
template <bool kAny, class TI, class TO>
int launch_fft_mixer_cluster(const TI* in, TO* out, const float* amp_w,
                             const float* amp_b, const float* pha_w,
                             const float* pha_b, const float* tables, int B,
                             int C, int H, int W, int k,
                             cudaStream_t stream) {
  FftClusterPlan plan;
  const long long blocks = (long long)B * C * k;
  if (k < 2 || k > kFftMaxCluster || (k & (k - 1)) ||
      !fft_cluster_plan(H, W, k, &plan) || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto* kernel = fft_mixer_cluster_kernel<TI, TO, kAny>;
  cudaError_t err = allow_smem(kernel, plan.smem);
  if (err == cudaSuccess && k > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kFftClusterThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, in, out, amp_w, amp_b, pha_w,
                           pha_b, tables, C, H * W, plan.rows, plan.cols,
                           plan.chunk, plan.pitch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifndef LGTEUN_FFT_ANY_UNIT
// The tables of plan p (fft_mixer.cuh, FftMixerPlan), the plan first.
__global__ void fft_tables_kernel(float* __restrict__ tab, FftMixerPlan p) {
  const int n = p.row.n, H = p.col.n;
  const bool even = p.w % 2 == 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < kFftPlanFloats; ++i) tab[i] = 0.f;  // the padding
    *reinterpret_cast<FftMixerPlan*>(tab) = p;
  }
  float2* tw_row = reinterpret_cast<float2*>(tab + p.tw_row);
  float2* tw_half = reinterpret_cast<float2*>(tab + p.tw_half);
  float2* tw_col = reinterpret_cast<float2*>(tab + p.tw_col);
  int* pos = reinterpret_cast<int*>(tab + p.pos_row);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i <= n || i < H;
       i += gridDim.x * blockDim.x) {
    if (i < n) {
      tw_row[i] = fft_twiddle(i, n);
      pos[i] = fft_pos(p.row, i);
    }
    if (even && i <= n) tw_half[i] = fft_twiddle(i, 2 * n);
    if (i < H) tw_col[i] = fft_twiddle(i, H);
  }
}
#endif  // LGTEUN_FFT_ANY_UNIT

// kernel: one of the fft_mixer kernels, launched with `blocks` blocks of
// `threads` on the planes.
template <class Kernel, class TI, class TO>
cudaError_t launch_fft_mixer_kernel(Kernel* kernel, int blocks, int threads,
                                    const TI* in, TO* out,
                                    const float* amp_w, const float* amp_b,
                                    const float* pha_w, const float* pha_b,
                                    const float* tables, int C, int HW,
                                    size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(in, out, amp_w, amp_b, pha_w,
                                            pha_b, tables, C, HW);
  return cudaGetLastError();
}

// Launch the mixer on B * C planes of storage types TI -> TO (loads.cuh)
// by the route of their shape (fft_mixer_route): one block (or a cluster
// of two) a plane where its half spectrum fits in shared memory, else a
// cluster of blocks that holds it (its size by fft_cluster_size), else
// the global route on `scratch`. `route` other than kFftByShape forces a
// route at any size that route takes (kFftGlobal, or a cluster of that
// many blocks): the checks that hold the routes to each other and to the
// one-block body. kAny: the kernels of planes of odd width or with a
// radix above kFftMaxPrime (FftPlaneOf).
constexpr int kFftByShape = -3;

template <bool kAny, class TI, class TO>
int launch_fft_mixer_routes(const TI* in, TO* out, const float* amp_w,
                            const float* amp_b, const float* pha_w,
                            const float* pha_b, const float* tables,
                            float* scratch, int B, int C, int H, int W,
                            cudaStream_t stream, int route) {
  const int planes = B * C;
  cudaError_t err = cudaSuccess;
  if (route == kFftByShape) {
    route = fft_mixer_route(H, W);
    if (route > kFftSmem) route = fft_cluster_size(route, planes,
                                                   device_sms(&err));
    if (err != cudaSuccess) return (int)err;
  }
  if (route == kFftNone) return (int)cudaErrorInvalidValue;
  if (route == kFftGlobal)
    return launch_fft_mixer_global<kAny>(in, out, amp_w, amp_b, pha_w, pha_b,
                                         tables, scratch, B, C, H, W, stream);
  if (route != kFftSmem)
    return launch_fft_mixer_cluster<kAny>(in, out, amp_w, amp_b, pha_w,
                                          pha_b, tables, B, C, H, W, route,
                                          stream);
  const int sms = device_sms(&err);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fft_mixer_smem(H, W);
  if (2 * planes <= sms)
    return (int)launch_fft_mixer_kernel(fft_mixer_pair_kernel<TI, TO, kAny>,
                                        2 * planes,
                                        512, in, out, amp_w, amp_b, pha_w,
                                        pha_b, tables, C, H * W, smem,
                                        stream);
  if (planes <= sms)
    return (int)launch_fft_mixer_kernel(
        fft_mixer_kernel<512, 1, TI, TO, kAny>, planes, 512, in, out, amp_w,
        amp_b, pha_w, pha_b, tables, C, H * W, smem, stream);
  return (int)launch_fft_mixer_kernel(fft_mixer_kernel<256, 2, TI, TO, kAny>,
                                      planes, 256,
                                      in, out, amp_w, amp_b, pha_w, pha_b,
                                      tables, C, H * W, smem, stream);
}

}  // namespace

// launch_fft_mixer_routes<true> for the storage types the entries take:
// the kernels of planes of odd width or with a radix above kFftMaxPrime,
// built in spectral_head_any.cu, a unit of their own, so that nvcc
// compiles them beside the rest, in parallel.
#define LGTEUN_FFT_MIXER_ANY(TI, TO)                                        \
  int fft_mixer_any(const TI* in, TO* out, const float* amp_w,              \
                    const float* amp_b, const float* pha_w,                 \
                    const float* pha_b, const float* tables,                \
                    float* scratch, int B, int C, int H, int W,             \
                    cudaStream_t stream, int route)
LGTEUN_FFT_MIXER_ANY(float, float);
LGTEUN_FFT_MIXER_ANY(float, __nv_bfloat16);
LGTEUN_FFT_MIXER_ANY(__nv_bfloat16, __nv_bfloat16);

#ifdef LGTEUN_FFT_ANY_UNIT
#define LGTEUN_FFT_MIXER_ANY_BODY(TI, TO)                                   \
  LGTEUN_FFT_MIXER_ANY(TI, TO) {                                            \
    return launch_fft_mixer_routes<true>(in, out, amp_w, amp_b, pha_w,      \
                                         pha_b, tables, scratch, B, C, H,   \
                                         W, stream, route);                 \
  }
LGTEUN_FFT_MIXER_ANY_BODY(float, float)
LGTEUN_FFT_MIXER_ANY_BODY(float, __nv_bfloat16)
LGTEUN_FFT_MIXER_ANY_BODY(__nv_bfloat16, __nv_bfloat16)
#undef LGTEUN_FFT_MIXER_ANY_BODY
#else  // the mixer's entries

namespace {

// launch_fft_mixer_routes on the kernels of the planes' kind. Checks the
// lengths it takes and the pairs' alignment.
template <class TI, class TO>
int launch_fft_mixer(const TI* in, TO* out, const float* amp_w,
                     const float* amp_b, const float* pha_w,
                     const float* pha_b, const float* tables,
                     float* scratch, int B, int C, int H, int W,
                     cudaStream_t stream, int route = kFftByShape) {
  FftMixerPlan p;
  // even W reads and writes the rows as pairs
  if (!fft_mixer_plan(H, W, &p) ||
      (W % 2 == 0 && (reinterpret_cast<size_t>(in) % (2 * sizeof(TI)) ||
                      reinterpret_cast<size_t>(out) % (2 * sizeof(TO)))))
    return (int)cudaErrorInvalidValue;
  if (W % 2 || fft_mixer_gbuf(p))
    return fft_mixer_any(in, out, amp_w, amp_b, pha_w, pha_b, tables,
                         scratch, B, C, H, W, stream, route);
  return launch_fft_mixer_routes<false>(in, out, amp_w, amp_b, pha_w, pha_b,
                                        tables, scratch, B, C, H, W, stream,
                                        route);
}

// The LN split into y1 and y2 (float), then the mixer of y2 into x2 (x2
// may be y2) by `route` (launch_fft_mixer).
template <class TX, class TY>
int ln_mixer_head(const TX* x, const float* ln_w, const float* ln_b,
                  const float* amp_w, const float* amp_b, const float* pha_w,
                  const float* pha_b, const float* tables, float* scratch,
                  TY* y1, float* y2, TY* x2, int B, int C, int H, int W,
                  float eps, cudaStream_t stream, int route = kFftByShape) {
  const int HW = H * W;
  const dim3 grid_ln((HW + kThreadsLN - 1) / kThreadsLN, B);
  auto* ln = HW < kLnHeldPixels ? ln_split_kernel<0, TX, TY>
             : C <= 16            ? ln_split_kernel<16, TX, TY>
             : C <= 32            ? ln_split_kernel<32, TX, TY>
             : C <= 64            ? ln_split_kernel<64, TX, TY>
                                  : ln_split_kernel<0, TX, TY>;
  ln<<<grid_ln, kThreadsLN, 0, stream>>>(x, ln_w, ln_b, y1, y2, C, HW, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fft_mixer(static_cast<const float*>(y2), x2, amp_w, amp_b,
                          pha_w, pha_b, tables, scratch, B, C / 2, H, W,
                          stream, route);
}

}  // namespace

// The plan, twiddles and positions of the mixer of an H x W plane into
// `tables` (`floats` floats; cudaErrorInvalidValue if that is fewer than
// the plan's 28 + 5 (W/2) + 2 H + 2 for even W, 28 + 3 W + 2 H for odd
// W, or the size is not taken).
extern "C" int lgteun_fft_tables(float* tables, int floats, int H, int W,
                                 cudaStream_t stream) {
  FftMixerPlan p;
  if (!fft_mixer_plan(H, W, &p) || floats < p.floats)
    return (int)cudaErrorInvalidValue;
  const int n = (p.row.n + 1 > H ? p.row.n + 1 : H);
  fft_tables_kernel<<<(n + 255) / 256, 256, 0, stream>>>(tables, p);
  return (int)cudaGetLastError();
}

// The layout of the mixer entries' arguments: 4, they take the tables of
// lgteun_fft_tables and the global route's scratch (null where the
// planes take another route; [planes][W/2 + 1][H] float2) after pha_b
// (3: a scratch of [planes][H][ld] float2; 2: the tables only; earlier
// versions: none).
extern "C" int lgteun_fft_mixer_layout() { return 4; }

// Not a launch: the route a launch of `planes` H x W planes on `sms` SMs
// takes (fft_mixer_route, fft_cluster_size): 0 the one-block body, K >=
// 2 a cluster of K blocks, -1 the global route, -2 none.
extern "C" int lgteun_fft_mixer_route(int H, int W, int planes, int sms) {
  const int route = fft_mixer_route(H, W);
  return route > kFftSmem ? fft_cluster_size(route, planes, sms) : route;
}

// y1, x2 = LN(x)[:, :C/2], global_mixer(LN(x)[:, C/2:]) on [B, C, H, W].
// 2 <= H <= 14,514, 2 <= W <= 29,026 (odd W <= 14,513), any factors
// (checked by the wrapper); scratch: B (C/2) (W/2 + 1) H float2 where the
// planes take the global route.
extern "C" int lgteun_ln_mixer_head(const float* x, const float* ln_w,
                                    const float* ln_b, const float* amp_w,
                                    const float* amp_b, const float* pha_w,
                                    const float* pha_b, const float* tables,
                                    float* scratch, float* y1, float* x2,
                                    int B, int C, int H, int W, float eps,
                                    cudaStream_t stream) {
  return ln_mixer_head(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b, tables,
                       scratch, y1, x2, x2, B, C, H, W, eps, stream);
}

// lgteun_ln_mixer_head with its mixer on the global route at any size
// the route takes: for the checks that hold the cluster route to it and
// the timings beside it (not on a model path).
extern "C" int lgteun_ln_mixer_head_global_route(
    const float* x, const float* ln_w, const float* ln_b,
    const float* amp_w, const float* amp_b, const float* pha_w,
    const float* pha_b, const float* tables, float* scratch, float* y1,
    float* x2, int B, int C, int H, int W, float eps, cudaStream_t stream) {
  return ln_mixer_head(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b, tables,
                       scratch, y1, x2, x2, B, C, H, W, eps, stream,
                       kFftGlobal);
}

// out = global_mixer(x) on [B, C, H, W]; per-channel affine [C] each;
// scratch as for lgteun_ln_mixer_head (B C (W/2 + 1) H float2).
extern "C" int lgteun_global_mixer(const float* x, const float* amp_w,
                                   const float* amp_b, const float* pha_w,
                                   const float* pha_b, const float* tables,
                                   float* scratch, float* out, int B, int C,
                                   int H, int W, cudaStream_t stream) {
  return launch_fft_mixer(x, out, amp_w, amp_b, pha_w, pha_b, tables,
                          scratch, B, C, H, W, stream);
}

// lgteun_global_mixer on the global route at any size the route takes,
// planes that fit in shared memory too: for the checks that hold the
// route to the one-block body and to the cluster route (not on a model
// path).
extern "C" int lgteun_global_mixer_global_route(
    const float* x, const float* amp_w, const float* amp_b,
    const float* pha_w, const float* pha_b, const float* tables,
    float* scratch, float* out, int B, int C, int H, int W,
    cudaStream_t stream) {
  return launch_fft_mixer(x, out, amp_w, amp_b, pha_w, pha_b, tables,
                          scratch, B, C, H, W, stream, kFftGlobal);
}

// lgteun_global_mixer on a cluster of k blocks (2, 4, 8 or 16) at any
// size whose shares that many blocks hold, planes that fit one block too:
// for the checks that hold the cluster route to the one-block body (not
// on a model path).
extern "C" int lgteun_global_mixer_cluster_route(
    const float* x, const float* amp_w, const float* amp_b,
    const float* pha_w, const float* pha_b, const float* tables,
    float* out, int B, int C, int H, int W, int k, cudaStream_t stream) {
  if (k < 2) return (int)cudaErrorInvalidValue;
  return launch_fft_mixer(x, out, amp_w, amp_b, pha_w, pha_b, tables,
                          nullptr, B, C, H, W, stream, k);
}

// The bf16 storage entries (LGTEUN_EVAL_DTYPE, loads.cuh): activations as
// __nv_bfloat16, math in float, one rounding to nearest even on store.

// lgteun_ln_mixer_head with y1 and x2 stored as bf16, x as float (x_bf16
// 0) or bf16 (1). The mixer takes the LN's float value: y2 (float, [B,
// C/2, H, W]) holds it between the LN and the mixer.
extern "C" int lgteun_ln_mixer_head_bf16(
    const void* x, const float* ln_w, const float* ln_b, const float* amp_w,
    const float* amp_b, const float* pha_w, const float* pha_b,
    const float* tables, float* scratch, __nv_bfloat16* y1,
    __nv_bfloat16* x2, float* y2, int B, int C, int H, int W, int x_bf16,
    float eps, cudaStream_t stream) {
  if (x_bf16)
    return ln_mixer_head(static_cast<const __nv_bfloat16*>(x), ln_w, ln_b,
                         amp_w, amp_b, pha_w, pha_b, tables, scratch, y1, y2,
                         x2, B, C, H, W, eps, stream);
  return ln_mixer_head(static_cast<const float*>(x), ln_w, ln_b, amp_w,
                       amp_b, pha_w, pha_b, tables, scratch, y1, y2, x2, B, C,
                       H, W, eps, stream);
}

// lgteun_global_mixer with out stored as bf16, x as float (x_bf16 0:
// the level-1 prior feeds the float LN, as the head's mixer takes it) or
// bf16 (1).
extern "C" int lgteun_global_mixer_bf16(const void* x, const float* amp_w,
                                        const float* amp_b,
                                        const float* pha_w,
                                        const float* pha_b,
                                        const float* tables,
                                        float* scratch, __nv_bfloat16* out,
                                        int B, int C, int H, int W,
                                        int x_bf16, cudaStream_t stream) {
  if (x_bf16)
    return launch_fft_mixer(static_cast<const __nv_bfloat16*>(x), out,
                            amp_w, amp_b, pha_w, pha_b, tables, scratch, B,
                            C, H, W, stream);
  return launch_fft_mixer(static_cast<const float*>(x), out, amp_w, amp_b,
                          pha_w, pha_b, tables, scratch, B, C, H, W,
                          stream);
}

#endif  // LGTEUN_FFT_ANY_UNIT
