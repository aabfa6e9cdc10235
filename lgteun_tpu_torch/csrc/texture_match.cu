// INNT's texture match (whole chain) and patch match (search + transfer)
// for Hopper (sm_90a).
//
// Replaces: lgteun_tpu/ops/texture_match_kernel.py::fused_texture_match
//           (Pallas `_kernel` via `_fused_tm_impl`) and
//           lgteun_tpu/ops/patch_match_kernel.py::fused_patch_match
//           (Pallas `_kernel` via `_fused_pm_impl`).
//
// Per patch-image (reference INNT.py:100-143):
//   u = unfold3x3(x) (zero padding 1, features ordered (c, ky, kx)),
//   u_n = u / (||u||_2 + 1e-12),
//   R[i, j] = ref_n[i] . lr_n[j],  s[j] = max_i R[i, j],
//   idx[j] = the first i reaching s[j] (torch.max's first maximum),
//   t = fold3x3(ref_u[:, idx]) / 9   (texture_match; raw ref values),
//   T[:, j] = ref_u[:, idx[j]]       (patch_match).
//
// What bounds it here: R is side^4 * 9C multiply-adds per patch-image
// (11.9 M at side 24, C = 4), against 18 KB in and 11.5 KB out, so it is
// bound by the FP32 cores (about 0.37 ms at batch 4, N = 1024, at
// 67 TFLOP/s). The plain version writes and reads R (1.36 GB at
// batch 4). The TPU kernel built R on the MXU in bf16 passes, found the
// first maximum with an integer min over a [q, q] iota and transferred
// with a one-hot matmul split into two bf16 words; none of that is
// needed here.
//
// Design: one block per patch-image. Shared memory holds the normalised
// ref vectors [Q][KP] (KP = 36 or 72: 9C zero-padded to a multiple of
// four, so the padding adds exact zeros), and for texture_match also the
// raw lr and ref planes [C][Q] and the chosen index per query (about
// 104 KB at side 24, C = 4: two blocks an SM). Each thread owns QPT
// queries, keeps their normalised vectors in registers and walks the Q
// ref vectors, four a step, with a running maximum that moves only on a
// strictly greater value, so the first maximum wins on exact ties; all
// threads read the same ref vector at once (a shared-memory broadcast,
// float4 a load). The loop is bound by how many warps hide its latency:
// at C = 4, 288 threads with two queries each and launch bounds for two
// blocks an SM (96 registers, 18 warps an SM) took 0.80 ms at batch 4,
// against 1.10 ms at one block an SM and 1.50 ms at four queries a
// thread (NVIDIA H100 80GB HBM3, scripts/torch_kernel_ab.py). The fold
// then sums, for each output pixel and channel, the
// nine raw ref values its 3x3 neighbourhood of queries chose, in the
// (ky, kx) order F.fold uses, with 2-D bounds on both the query and the
// ref neighbour. Every f32 op is exact IEEE (division, sqrtf).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSmemMax = 232448;       // per-block shared memory on sm_90

// Queries a thread owns in one pass, the most threads a block has and
// the blocks an SM should hold: at KP = 36, 288 threads (576 queries in
// one pass) and two blocks an SM (at most 113 registers a thread).
template <int KP>
__host__ __device__ constexpr int queries_per_thread() {
  return KP <= 36 ? 2 : 1;
}

template <int KP>
__host__ __device__ constexpr int max_threads() {
  return KP <= 36 ? 288 : 512;
}

template <int KP>
__host__ __device__ constexpr int min_blocks() {
  return KP <= 36 ? 2 : 1;
}

// For each of a thread's QPT query vectors q[t] (KP values, zero past
// the true length), the first maximum of rn[i] . q[t] over the L ref
// vectors rn [L][KP] in shared memory, and its index.
// RB refs a step give RB * QPT independent FMA chains a thread (each dot
// product is one chain, summed in k order); the refs of a step are then
// compared in index order, so the first maximum still wins.
template <int KP, int QPT, int RB>
__device__ __forceinline__ void search_step(const float* __restrict__ rn,
                                            int i0,
                                            const float (&q)[QPT][KP],
                                            float (&best)[QPT],
                                            int (&arg)[QPT]) {
  float d[RB][QPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int t = 0; t < QPT; ++t) d[r][t] = 0.f;
#pragma unroll
  for (int k4 = 0; k4 < KP / 4; ++k4) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float4 v =
          reinterpret_cast<const float4*>(rn + (size_t)(i0 + r) * KP)[k4];
#pragma unroll
      for (int t = 0; t < QPT; ++t) {
        d[r][t] = fmaf(v.x, q[t][4 * k4], d[r][t]);
        d[r][t] = fmaf(v.y, q[t][4 * k4 + 1], d[r][t]);
        d[r][t] = fmaf(v.z, q[t][4 * k4 + 2], d[r][t]);
        d[r][t] = fmaf(v.w, q[t][4 * k4 + 3], d[r][t]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int t = 0; t < QPT; ++t)
      if (d[r][t] > best[t]) {
        best[t] = d[r][t];
        arg[t] = i0 + r;
      }
}

template <int KP, int QPT>
__device__ __forceinline__ void search(const float* __restrict__ rn, int L,
                                       const float (&q)[QPT][KP],
                                       float (&best)[QPT], int (&arg)[QPT]) {
  constexpr int RB = 4;
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    best[t] = -INFINITY;
    arg[t] = 0;
  }
  int i = 0;
  for (; i + RB <= L; i += RB) search_step<KP, QPT, RB>(rn, i, q, best, arg);
  for (; i < L; ++i) search_step<KP, QPT, 1>(rn, i, q, best, arg);
}

// The normalised 3x3 sub-patch of pixel p of a [C][side*side] plane,
// (c, ky, kx) order, zero outside the image and past 9C.
template <int KP>
__device__ __forceinline__ void unfold_normalized(const float* plane, int C,
                                                  int side, int p,
                                                  float (&v)[KP]) {
  const int py = p / side, px = p % side, q = side * side;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int c = k / 9, o = k % 9;
    const int y = py + o / 3 - 1, x = px + o % 3 - 1;
    v[k] = (c < C && y >= 0 && y < side && x >= 0 && x < side)
               ? plane[c * q + y * side + x] : 0.f;
  }
  float n2 = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) n2 = fmaf(v[k], v[k], n2);
  const float nrm = sqrtf(n2) + 1e-12f;
#pragma unroll
  for (int k = 0; k < KP; ++k) v[k] = v[k] / nrm;
}

template <int KP>
__global__ void __launch_bounds__(max_threads<KP>(), min_blocks<KP>())
tm_kernel(const float* __restrict__ lr, const float* __restrict__ ref,
          float* __restrict__ t_out, float* __restrict__ s_out, int C,
          int side) {
  constexpr int QPT = queries_per_thread<KP>();
  extern __shared__ float4 smem_raw[];
  const int Q = side * side;
  float* rn = reinterpret_cast<float*>(smem_raw);   // [Q][KP]
  float* lr_s = rn + (size_t)Q * KP;                 // [C][Q]
  float* ref_s = lr_s + (size_t)C * Q;               // [C][Q]
  int* idx = reinterpret_cast<int*>(ref_s + (size_t)C * Q);  // [Q]

  const size_t base = (size_t)blockIdx.x * C * Q;
  for (int e = threadIdx.x; e < C * Q; e += blockDim.x) {
    lr_s[e] = lr[base + e];
    ref_s[e] = ref[base + e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    float v[KP];
    unfold_normalized<KP>(ref_s, C, side, i, v);
    float4* row = reinterpret_cast<float4*>(rn + (size_t)i * KP);
#pragma unroll
    for (int k4 = 0; k4 < KP / 4; ++k4)
      row[k4] = make_float4(v[4 * k4], v[4 * k4 + 1], v[4 * k4 + 2],
                            v[4 * k4 + 3]);
  }
  __syncthreads();

  for (int j0 = 0; j0 < Q; j0 += blockDim.x * QPT) {
    float q[QPT][KP];
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int j = j0 + t * blockDim.x + threadIdx.x;
      if (j < Q) {
        unfold_normalized<KP>(lr_s, C, side, j, q[t]);
      } else {
#pragma unroll
        for (int k = 0; k < KP; ++k) q[t][k] = 0.f;
      }
    }
    float best[QPT];
    int arg[QPT];
    search<KP, QPT>(rn, Q, q, best, arg);
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int j = j0 + t * blockDim.x + threadIdx.x;
      if (j < Q) {
        idx[j] = arg[t];
        s_out[(size_t)blockIdx.x * Q + j] = best[t];
      }
    }
  }
  __syncthreads();

  // fold: out[c, y, x] = sum over (ky, kx) of the raw ref value at
  // offset (ky-1, kx-1) from the ref pixel chosen by query
  // (y-ky+1, x-kx+1), where both lie in the image; then / 9
  for (int e = threadIdx.x; e < C * Q; e += blockDim.x) {
    const int c = e / Q, p = e % Q, y = p / side, x = p % side;
    float acc = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      const int qy = y - ky + 1;
      if (qy < 0 || qy >= side) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int qx = x - kx + 1;
        if (qx < 0 || qx >= side) continue;
        const int i = idx[qy * side + qx];
        const int iy = i / side + ky - 1, ix = i % side + kx - 1;
        if (iy >= 0 && iy < side && ix >= 0 && ix < side)
          acc += ref_s[c * Q + iy * side + ix];
      }
    }
    t_out[base + e] = acc / 9.f;
  }
}

template <int KP>
__global__ void __launch_bounds__(max_threads<KP>(), min_blocks<KP>())
pm_kernel(const float* __restrict__ lr_n, const float* __restrict__ ref_n,
          const float* __restrict__ ref_u, float* __restrict__ t_out,
          float* __restrict__ s_out, int L, int K) {
  constexpr int QPT = queries_per_thread<KP>();
  extern __shared__ float4 smem_raw[];
  float* rn = reinterpret_cast<float*>(smem_raw);   // [L][KP]
  const size_t base = (size_t)blockIdx.x * L * K;
  const float* lrb = lr_n + base;
  const float* rub = ref_u + base;
  for (int e = threadIdx.x; e < L * KP; e += blockDim.x) {
    const int i = e / KP, k = e % KP;
    rn[e] = k < K ? ref_n[base + (size_t)i * K + k] : 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < L; j0 += blockDim.x * QPT) {
    float q[QPT][KP];
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int j = j0 + t * blockDim.x + threadIdx.x;
#pragma unroll
      for (int k = 0; k < KP; ++k)
        q[t][k] = (j < L && k < K) ? lrb[(size_t)j * K + k] : 0.f;
    }
    float best[QPT];
    int arg[QPT];
    search<KP, QPT>(rn, L, q, best, arg);
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int j = j0 + t * blockDim.x + threadIdx.x;
      if (j >= L) continue;
      s_out[(size_t)blockIdx.x * L + j] = best[t];
      for (int k = 0; k < K; ++k)
        t_out[base + (size_t)k * L + j] = rub[(size_t)k * L + arg[t]];
    }
  }
}

// Threads of a block: as few passes of QPT queries a thread as
// `max_threads` allow, the threads rounded up to whole warps.
int block_threads(int queries, int qpt, int max_threads) {
  const int per_pass = qpt * max_threads;
  const int passes = (queries + per_pass - 1) / per_pass;
  const int threads = (queries + qpt * passes - 1) / (qpt * passes);
  return (threads + 31) / 32 * 32;
}

template <int KP>
int launch_tm(const float* lr, const float* ref, float* t, float* s, int N,
              int C, int side, cudaStream_t stream) {
  const int Q = side * side;
  const size_t smem = sizeof(float) * ((size_t)Q * KP + 2 * (size_t)C * Q
                                       + Q);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tm_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads =
      block_threads(Q, queries_per_thread<KP>(), max_threads<KP>());
  tm_kernel<KP><<<N, threads, smem, stream>>>(lr, ref, t, s, C, side);
  return (int)cudaGetLastError();
}

template <int KP>
int launch_pm(const float* lr_n, const float* ref_n, const float* ref_u,
              float* t, float* s, int N, int L, int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)L * KP;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pm_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads =
      block_threads(L, queries_per_thread<KP>(), max_threads<KP>());
  pm_kernel<KP><<<N, threads, smem, stream>>>(lr_n, ref_n, ref_u, t, s, L,
                                               K);
  return (int)cudaGetLastError();
}

}  // namespace

// (t, s) = texture match of lr, ref [N, C, side*side]; t [N, C,
// side*side], s [N, side*side]; 1 <= C <= 8.
extern "C" int lgteun_texture_match(const float* lr, const float* ref,
                                    float* t, float* s, int N, int C,
                                    int side, cudaStream_t stream) {
  if (N < 0 || C < 1 || C > 8 || side < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return 9 * C <= 36 ? launch_tm<36>(lr, ref, t, s, N, C, side, stream)
                     : launch_tm<72>(lr, ref, t, s, N, C, side, stream);
}

// (T, S) = patch match of lr_n, ref_n [N, L, K] and ref_u [N, K, L];
// T [N, K, L], S [N, L]; 1 <= K <= 72.
extern "C" int lgteun_patch_match(const float* lr_n, const float* ref_n,
                                  const float* ref_u, float* t, float* s,
                                  int N, int L, int K, cudaStream_t stream) {
  if (N < 0 || L < 1 || K < 1 || K > 72) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return K <= 36 ? launch_pm<36>(lr_n, ref_n, ref_u, t, s, N, L, K, stream)
                 : launch_pm<72>(lr_n, ref_n, ref_u, t, s, N, L, K, stream);
}
