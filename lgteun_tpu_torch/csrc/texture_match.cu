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
// (11.9 M at side 24, C = 4), against 18 KB in and 11.5 KB out: it is
// bound by operations. The plain version writes and reads R (1.36 GB at
// batch 4). The TPU kernel built R on the MXU in bf16 passes, found the
// first maximum with an integer min over a [q, q] iota and transferred
// with a one-hot matmul split into two bf16 words; none of that is
// needed here.
//
// Design: one block per patch-image, two branches chosen by shape (the
// wrappers mirror the rule and count each branch; the `_tc` exports
// below give it).
//
// - Tensor cores (vectors of at most 40 values, 9C or K <= 40, where the
//   staging fits in shared memory: INNT's C = 4 at side 24): R as wgmma
//   TF32 with the 3xTF32 split and the first maximum taken from the
//   accumulators (texture_match_tc.cuh), 3 warpgroups a block, one block
//   an SM at side 24. Shared memory holds the normalised ref vectors
//   staged hi/lo in wgmma's core-matrix order ([576][40] x 2, 184 KB at
//   side 24) and for texture_match also the raw lr and ref planes, the
//   query norms and the chosen pixels (207 KB in all); patch_match's
//   warpgroups transfer each finished tile while the others multiply.
//   The products' operations x 3 at 495 TFLOP/s and the rest at 67 bound
//   it at 0.156 / 0.153 ms at batch 4 (texture / patch match); it took
//   0.3614 / 0.3486 ms there (NVIDIA H100 80GB HBM3, 700 W,
//   scripts/torch_kernel_ab.py against the FP32-core body in one run),
//   a block's time going to the staging and the fold, which no other
//   block overlaps, and to the accumulators' folds between products.
// - FP32 cores (the other shapes, C 5-8 or K 41-72, whose hi/lo refs at
//   side 24 would need 332 KB, and sides too large for the tensor-core
//   staging): shared memory holds the normalised ref vectors [Q][KP] (KP
//   = 36 or 72) and for texture_match the planes and the indices; each
//   thread owns QPT queries in registers and walks the refs, four a step,
//   with a running maximum that moves only on a strictly greater value.
//   As the only body it took 0.8047 ms for texture_match at
//   [1024,4,576] and 0.8157 ms for patch_match at [1024,576,36] (NVIDIA
//   H100 80GB HBM3, 700 W; 288 threads with two queries each, two blocks
//   an SM: bound by how many warps hide the loop's latency).
//
// Both branches unfold and normalise with the same exact IEEE code
// (sqrtf, division; a zero value is its own quotient), so the vectors
// entering the split are the FP32 body's. The fold then sums, for each
// output pixel and channel, the nine raw ref values its 3x3
// neighbourhood of queries chose, in the (ky, kx) order F.fold uses, with
// 2-D bounds on both the query and the ref neighbour, then divides by 9.
//
// bf16 storage (LGTEUN_EVAL_DTYPE=bf16, INNT's eval forward in the blanket
// cast, loads.cuh): the inputs are __nv_bfloat16, upcast exactly as they
// are loaded (texture_match's planes into shared memory as float), all
// math is the float32 entries' (the normalised vectors are not exact in
// TF32, so the 3xTF32 split stays), and t and s are rounded once to
// nearest even as they are stored (patch_match's t copies bf16 values,
// exact). The Pallas kernels upcast their loads and round once on store
// the same way (texture_match_kernel.py:112-113, :193;
// patch_match_kernel.py:77, :108). Those entries are built in a unit of
// their own, texture_match_bf16.cu, which defines LGTEUN_BF16_UNIT and
// includes this file.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "loads.cuh"
#ifdef LGTEUN_BF16_UNIT
#undef LGTEUN_SEARCH_STAMPS   // the float32 unit declares the stamps
#endif
#include "texture_match_tc.cuh"

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

// Value k of the 3x3 sub-patch of pixel (py, px) of a [C][side*side]
// plane, (c, ky, kx) order, zero outside the image and past 9C.
__device__ __forceinline__ float unfold_at(const float* plane, int C,
                                           int side, int py, int px, int k) {
  const int c = k / 9, o = k % 9;
  const int y = py + o / 3 - 1, x = px + o % 3 - 1;
  return (c < C && y >= 0 && y < side && x >= 0 && x < side)
             ? plane[(c * side + y) * side + x] : 0.f;
}

// The sub-patch of pixel p into v and its norm + 1e-12 (summed in k
// order; the zero padding past 9C adds exact zeros).
template <int KP>
__device__ __forceinline__ float unfold_norm(const float* plane, int C,
                                             int side, int p,
                                             float (&v)[KP]) {
  const int py = p / side, px = p % side;
#pragma unroll
  for (int k = 0; k < KP; ++k) v[k] = unfold_at(plane, C, side, py, px, k);
  float n2 = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) n2 = fmaf(v[k], v[k], n2);
  return sqrtf(n2) + 1e-12f;
}

// v / nrm for nrm > 0, exact IEEE; a zero v is its own quotient and skips
// the division, whose slow path a zero dividend takes.
__device__ __forceinline__ float normalize(float v, float nrm) {
  return v != 0.f ? v / nrm : v;
}

// The normalised sub-patch of pixel p.
template <int KP>
__device__ __forceinline__ void unfold_normalized(const float* plane, int C,
                                                  int side, int p,
                                                  float (&v)[KP]) {
  const float nrm = unfold_norm<KP>(plane, C, side, p, v);
#pragma unroll
  for (int k = 0; k < KP; ++k) v[k] = normalize(v[k], nrm);
}

// This patch-image's raw lr and ref planes (n floats each) into shared
// memory, every copy in flight at once, then a barrier.
__device__ __forceinline__ void load_planes(const float* __restrict__ lr,
                                            const float* __restrict__ ref,
                                            float* lr_s, float* ref_s,
                                            int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    cp_async4(lr_s + e, lr + e);
    cp_async4(ref_s + e, ref + e);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// The same from bf16 planes, upcast as loaded (a plane holds them as
// float).
__device__ __forceinline__ void load_planes(
    const __nv_bfloat16* __restrict__ lr, const __nv_bfloat16* __restrict__ ref,
    float* lr_s, float* ref_s, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    lr_s[e] = load_act<false>(lr + e);
    ref_s[e] = load_act<false>(ref + e);
  }
  __syncthreads();
}

// Ref pixel i of a side x side image as (row << 16) | column: what the
// searches record for the fold.
__device__ __forceinline__ int pack_pixel(int i, int side) {
  return (i / side) << 16 | (i % side);
}

// fold: out[c, y, x] = sum over (ky, kx) of the raw ref value at offset
// (ky-1, kx-1) from the ref pixel chosen by query (y-ky+1, x-kx+1)
// (`chosen`, pack_pixel), where both lie in the image; then / 9. One
// pixel a thread, every channel (C <= 8) summed in (ky, kx) order; out
// of storage type T, rounded once as stored.
template <class T>
__device__ __forceinline__ void fold_chosen(const float* ref_s,
                                            const int* chosen,
                                            T* __restrict__ out, int C,
                                            int side) {
  const int Q = side * side;
  for (int p = threadIdx.x; p < Q; p += blockDim.x) {
    const int y = p / side, x = p - y * side;
    float acc[8] = {};
    for (int ky = 0; ky < 3; ++ky) {
      const int qy = y - ky + 1;
      if (qy < 0 || qy >= side) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int qx = x - kx + 1;
        if (qx < 0 || qx >= side) continue;
        const int i = chosen[qy * side + qx];
        const int iy = (i >> 16) + ky - 1, ix = (i & 0xFFFF) + kx - 1;
        if (iy < 0 || iy >= side || ix < 0 || ix >= side) continue;
        const float* r = ref_s + iy * side + ix;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < C) acc[c] += r[c * Q];
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < C) store_act(out + c * Q + p, acc[c] / 9.f);
  }
}

// T: the storage type of lr, ref, t and s (float or __nv_bfloat16).
template <int KP, class T>
__global__ void __launch_bounds__(max_threads<KP>(), min_blocks<KP>())
tm_kernel(const T* __restrict__ lr, const T* __restrict__ ref,
          T* __restrict__ t_out, T* __restrict__ s_out, int C, int side) {
  constexpr int QPT = queries_per_thread<KP>();
  extern __shared__ float4 smem_raw[];
  const int Q = side * side;
  float* rn = reinterpret_cast<float*>(smem_raw);   // [Q][KP]
  float* lr_s = rn + (size_t)Q * KP;                 // [C][Q]
  float* ref_s = lr_s + (size_t)C * Q;               // [C][Q]
  int* idx = reinterpret_cast<int*>(ref_s + (size_t)C * Q);  // [Q] packed

  const size_t base = (size_t)blockIdx.x * C * Q;
  load_planes(lr + base, ref + base, lr_s, ref_s, C * Q);
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
        idx[j] = pack_pixel(arg[t], side);
        store_act(s_out + (size_t)blockIdx.x * Q + j, best[t]);
      }
    }
  }
  __syncthreads();
  fold_chosen(ref_s, idx, t_out + base, C, side);
}

template <int KP, class T>
__global__ void __launch_bounds__(max_threads<KP>(), min_blocks<KP>())
pm_kernel(const T* __restrict__ lr_n, const T* __restrict__ ref_n,
          const T* __restrict__ ref_u, T* __restrict__ t_out,
          T* __restrict__ s_out, int L, int K) {
  constexpr int QPT = queries_per_thread<KP>();
  extern __shared__ float4 smem_raw[];
  float* rn = reinterpret_cast<float*>(smem_raw);   // [L][KP]
  const size_t base = (size_t)blockIdx.x * L * K;
  const T* lrb = lr_n + base;
  const T* rub = ref_u + base;
  for (int e = threadIdx.x; e < L * KP; e += blockDim.x) {
    const int i = e / KP, k = e % KP;
    rn[e] = k < K ? load_plain(ref_n + base + (size_t)i * K + k) : 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < L; j0 += blockDim.x * QPT) {
    float q[QPT][KP];
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int j = j0 + t * blockDim.x + threadIdx.x;
#pragma unroll
      for (int k = 0; k < KP; ++k)
        q[t][k] = (j < L && k < K) ? load_plain(lrb + (size_t)j * K + k)
                                   : 0.f;
    }
    float best[QPT];
    int arg[QPT];
    search<KP, QPT>(rn, L, q, best, arg);
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      const int j = j0 + t * blockDim.x + threadIdx.x;
      if (j >= L) continue;
      store_act(s_out + (size_t)blockIdx.x * L + j, best[t]);
      for (int k = 0; k < K; ++k)   // a copy of T values: exact
        t_out[base + (size_t)k * L + j] = rub[(size_t)k * L + arg[t]];
    }
  }
}

// Shared memory (bytes) of the tensor-core kernels: the staged refs (hi,
// lo), and for texture_match the two planes, the query norms and the
// chosen indices; for patch_match the chosen indices.
size_t tm_tc_smem(int C, int side) {
  const size_t q = (size_t)side * side;
  return sizeof(float) *
         (2 * (size_t)search_pad((int)q) * kSearchKP + 2 * C * q + 2 * q);
}

size_t pm_tc_smem(int L) {
  return sizeof(float) * (2 * (size_t)search_pad(L) * kSearchKP + L);
}

// Whether the tensor-core branch takes a shape (the other shapes run the
// FP32-core kernels).
bool tm_tc_takes(int C, int side) {
  return 9 * C <= kSearchKP && tm_tc_smem(C, side) <= (size_t)kSmemMax;
}

bool pm_tc_takes(int K, int L) {
  return K <= kSearchKP && pm_tc_smem(L) <= (size_t)kSmemMax;
}

// A query pixel of texture_match's tensor-core search: its lr plane
// pointer, row, column and the norm of its sub-patch.
struct QueryPixel {
  const float* p;
  int y, x;
  float nrm;
};

template <class T>
__global__ void __launch_bounds__(kSearchWarpgroups * 128, 1)
tm_tc_kernel(const T* __restrict__ lr, const T* __restrict__ ref,
             T* __restrict__ t_out, T* __restrict__ s_out, int C,
             int side) {
  extern __shared__ float4 smem_raw[];
  const int Q = side * side, QP = search_pad(Q);
  float* hi = reinterpret_cast<float*>(smem_raw);   // staged refs
  float* lo = hi + (size_t)QP * kSearchKP;
  float* lr_s = lo + (size_t)QP * kSearchKP;         // [C][Q]
  float* ref_s = lr_s + (size_t)C * Q;               // [C][Q]
  float* nrm = ref_s + (size_t)C * Q;                // [Q] query norms
  int* idx = reinterpret_cast<int*>(nrm + Q);        // [Q] packed

  const SearchStamps st;
  const size_t base = (size_t)blockIdx.x * C * Q;
  load_planes(lr + base, ref + base, lr_s, ref_s, C * Q);
  // the refs (normalised, split, staged; zero vectors past Q), then the
  // queries' norms
  for (int i = threadIdx.x; i < QP + Q; i += blockDim.x) {
    float v[kSearchKP] = {};
    if (i >= QP) {
      nrm[i - QP] = unfold_norm<kSearchKP>(lr_s, C, side, i - QP, v);
      continue;
    }
    if (i < Q) unfold_normalized<kSearchKP>(ref_s, C, side, i, v);
#pragma unroll
    for (int kq = 0; kq < kSearchKQ; ++kq) {
      const float w[4] = {v[4 * kq], v[4 * kq + 1], v[4 * kq + 2],
                          v[4 * kq + 3]};
      search_stage(hi, lo, i, kq, w);
    }
  }
  fence_proxy_async();
  __syncthreads();
  st.at(0);

  // this thread's values k = 4m + t of a sub-patch: channel, row and
  // column offsets, and the plane offset (c, dy, dx) -> c Q + dy side + dx;
  // a query row: its pixel's plane pointer, row, column and norm
  const int t = threadIdx.x & 3;
  int kc[kSearchKQ], kdy[kSearchKQ], kdx[kSearchKQ], koff[kSearchKQ];
#pragma unroll
  for (int m = 0; m < kSearchKQ; ++m) {
    const int k = 4 * m + t, o = k % 9;
    kc[m] = k / 9;
    kdy[m] = o / 3 - 1;
    kdx[m] = o % 3 - 1;
    koff[m] = kc[m] * Q + kdy[m] * side + kdx[m];
  }
  T* s = s_out + (size_t)blockIdx.x * Q;
  search_tc(
      hi, lo, Q,
      [&](int j) {
        const int y = j / side;
        return QueryPixel{lr_s + j, y, j - y * side, j < Q ? nrm[j] : 1.f};
      },
      [&](const QueryPixel& r, int m) -> float {   // unfold_at(.., 4m + t)
        const int y = r.y + kdy[m], x = r.x + kdx[m];
        return kc[m] < C && y >= 0 && y < side && x >= 0 && x < side
                   ? r.p[koff[m]] : 0.f;
      },
      [](const QueryPixel& r, float v) { return normalize(v, r.nrm); },
      [&](int j, float v, int i) {
        idx[j] = pack_pixel(i, side);
        store_act(s + j, v);
      },
      [](int) {}, st);
  __syncthreads();
  st.at(5);
  fold_chosen(ref_s, idx, t_out + base, C, side);
  st.at(6);
  st.end();
}

template <class T>
__global__ void __launch_bounds__(kSearchWarpgroups * 128, 1)
pm_tc_kernel(const T* __restrict__ lr_n, const T* __restrict__ ref_n,
             const T* __restrict__ ref_u, T* __restrict__ t_out,
             T* __restrict__ s_out, int L, int K) {
  extern __shared__ float4 smem_raw[];
  const int LP = search_pad(L);
  float* hi = reinterpret_cast<float*>(smem_raw);   // staged refs
  float* lo = hi + (size_t)LP * kSearchKP;
  int* idx = reinterpret_cast<int*>(lo + (size_t)LP * kSearchKP);  // [L]
  const SearchStamps st;
  const size_t base = (size_t)blockIdx.x * L * K;
  const T* lrb = lr_n + base;
  const T* rnb = ref_n + base;
  const T* rub = ref_u + base;

  // items (k-quad kq, ref i), k-quad-major, so that consecutive threads
  // stage consecutive refs; four items a thread in flight, each one
  // 16-byte load where float rows are 16-byte aligned (bf16 rows: four
  // loads, each upcast)
  const int items = kSearchKQ * LP;
  const bool quads = std::is_same<T, float>::value && K % 4 == 0 &&
                     (reinterpret_cast<size_t>(rnb) & 15) == 0;
  for (int e0 = threadIdx.x; e0 < items; e0 += 4 * blockDim.x) {
    float v[4][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = e0 + h * blockDim.x, kq = e / LP, i = e - kq * LP;
      const T* r = rnb + (size_t)i * K + 4 * kq;
      const bool row = e < items && i < L;
      if (quads) {
        const float4 x = row && 4 * kq < K
                             ? __ldg(reinterpret_cast<const float4*>(r))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        v[h][0] = x.x;
        v[h][1] = x.y;
        v[h][2] = x.z;
        v[h][3] = x.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[h][u] = row && 4 * kq + u < K ? load_act<false>(r + u) : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = e0 + h * blockDim.x, kq = e / LP;
      if (e < items) search_stage(hi, lo, e - kq * LP, kq, v[h]);
    }
  }
  fence_proxy_async();
  __syncthreads();
  st.at(0);

  const int t = threadIdx.x & 3, wg = threadIdx.x >> 7;
  T* s = s_out + (size_t)blockIdx.x * L;
  search_tc(
      hi, lo, L, [&](int j) { return lrb + (size_t)j * K; },
      [&](const T* r, int m) -> float {
        const int k = 4 * m + t;
        return k < K ? load_act<false>(r + k) : 0.f;
      },
      [](const T*, float v) { return v; },
      [&](int j, float v, int i) {
        idx[j] = i;
        store_act(s + j, v);
      },
      [&](int tile) {
        // T[:, j] = ref_u[:, idx[j]] for the tile's queries, by its
        // warpgroup while the others multiply; rows of 64 in order,
        // six gathers in flight a thread
        warpgroup_sync(wg);
        const int j0 = tile * kSearchTile, n = K * kSearchTile;
        for (int e0 = threadIdx.x & 127; e0 < n; e0 += 6 * 128) {
          float v[6];
#pragma unroll
          for (int h = 0; h < 6; ++h) {
            const int e = e0 + 128 * h, j = j0 + (e & 63);
            v[h] = e < n && j < L
                       ? load_act<false>(rub + (size_t)(e >> 6) * L + idx[j])
                       : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 6; ++h) {
            const int e = e0 + 128 * h, j = j0 + (e & 63);
            if (e < n && j < L)   // a T value and back: exact
              store_act(t_out + base + (size_t)(e >> 6) * L + j, v[h]);
          }
        }
      },
      st);
  st.at(6);
  st.end();
}

// Threads of a block: as few passes of QPT queries a thread as
// `max_threads` allow, the threads rounded up to whole warps.
int block_threads(int queries, int qpt, int max_threads) {
  const int per_pass = qpt * max_threads;
  const int passes = (queries + per_pass - 1) / per_pass;
  const int threads = (queries + qpt * passes - 1) / (qpt * passes);
  return (threads + 31) / 32 * 32;
}

template <int KP, class T>
int launch_tm(const T* lr, const T* ref, T* t, T* s, int N, int C, int side,
              cudaStream_t stream) {
  const int Q = side * side;
  const size_t smem = sizeof(float) * ((size_t)Q * KP + 2 * (size_t)C * Q
                                       + Q);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tm_kernel<KP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads =
      block_threads(Q, queries_per_thread<KP>(), max_threads<KP>());
  tm_kernel<KP, T><<<N, threads, smem, stream>>>(lr, ref, t, s, C, side);
  return (int)cudaGetLastError();
}

template <int KP, class T>
int launch_pm(const T* lr_n, const T* ref_n, const T* ref_u, T* t, T* s,
              int N, int L, int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)L * KP;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pm_kernel<KP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads =
      block_threads(L, queries_per_thread<KP>(), max_threads<KP>());
  pm_kernel<KP, T><<<N, threads, smem, stream>>>(lr_n, ref_n, ref_u, t, s,
                                                  L, K);
  return (int)cudaGetLastError();
}

// Tensor-core launches: one block of up to kSearchWarpgroups warpgroups
// (one a query tile) per patch-image.
int search_tc_threads(int L) {
  const int tiles = search_pad(L) / kSearchTile;
  return 128 * (tiles < kSearchWarpgroups ? tiles : kSearchWarpgroups);
}

template <class T>
int launch_tm_tc(const T* lr, const T* ref, T* t, T* s, int N, int C,
                 int side, cudaStream_t stream) {
  const size_t smem = tm_tc_smem(C, side);
  const cudaError_t err = cudaFuncSetAttribute(
      tm_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tm_tc_kernel<T><<<N, search_tc_threads(side * side), smem, stream>>>(
      lr, ref, t, s, C, side);
  return (int)cudaGetLastError();
}

template <class T>
int launch_pm_tc(const T* lr_n, const T* ref_n, const T* ref_u, T* t, T* s,
                 int N, int L, int K, cudaStream_t stream) {
  const size_t smem = pm_tc_smem(L);
  const cudaError_t err = cudaFuncSetAttribute(
      pm_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pm_tc_kernel<T><<<N, search_tc_threads(L), smem, stream>>>(
      lr_n, ref_n, ref_u, t, s, L, K);
  return (int)cudaGetLastError();
}

// The texture match of lr, ref [N, C, side*side] of storage type T into
// t [N, C, side*side] and s [N, side*side]; 1 <= C <= 8.
template <class T>
int texture_match(const T* lr, const T* ref, T* t, T* s, int N, int C,
                  int side, cudaStream_t stream) {
  if (N < 0 || C < 1 || C > 8 || side < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (tm_tc_takes(C, side))
    return launch_tm_tc(lr, ref, t, s, N, C, side, stream);
  return 9 * C <= 36 ? launch_tm<36>(lr, ref, t, s, N, C, side, stream)
                     : launch_tm<72>(lr, ref, t, s, N, C, side, stream);
}

// The patch match of lr_n, ref_n [N, L, K] and ref_u [N, K, L] of storage
// type T into T [N, K, L] and S [N, L]; 1 <= K <= 72.
template <class T>
int patch_match(const T* lr_n, const T* ref_n, const T* ref_u, T* t, T* s,
                int N, int L, int K, cudaStream_t stream) {
  if (N < 0 || L < 1 || K < 1 || K > 72) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (pm_tc_takes(K, L))
    return launch_pm_tc(lr_n, ref_n, ref_u, t, s, N, L, K, stream);
  return K <= 36 ? launch_pm<36>(lr_n, ref_n, ref_u, t, s, N, L, K, stream)
                 : launch_pm<72>(lr_n, ref_n, ref_u, t, s, N, L, K, stream);
}

}  // namespace

#ifndef LGTEUN_BF16_UNIT
// (t, s) = texture match of lr, ref [N, C, side*side]; t [N, C,
// side*side], s [N, side*side]; 1 <= C <= 8.
extern "C" int lgteun_texture_match(const float* lr, const float* ref,
                                    float* t, float* s, int N, int C,
                                    int side, cudaStream_t stream) {
  return texture_match(lr, ref, t, s, N, C, side, stream);
}

// (T, S) = patch match of lr_n, ref_n [N, L, K] and ref_u [N, K, L];
// T [N, K, L], S [N, L]; 1 <= K <= 72.
extern "C" int lgteun_patch_match(const float* lr_n, const float* ref_n,
                                  const float* ref_u, float* t, float* s,
                                  int N, int L, int K, cudaStream_t stream) {
  return patch_match(lr_n, ref_n, ref_u, t, s, N, L, K, stream);
}

// 1 where lgteun_texture_match runs the tensor-core branch for C channels
// at side x side, else 0 (the FP32-core branch).
extern "C" int lgteun_texture_match_tc(int C, int side) {
  return tm_tc_takes(C, side) ? 1 : 0;
}

// 1 where lgteun_patch_match runs the tensor-core branch for L vectors of
// K values, else 0.
extern "C" int lgteun_patch_match_tc(int K, int L) {
  return pm_tc_takes(K, L) ? 1 : 0;
}
#else  // LGTEUN_BF16_UNIT: texture_match_bf16.cu

// The bf16 storage entries: lgteun_texture_match and lgteun_patch_match
// with every tensor __nv_bfloat16 (upcast as loaded, rounded once as
// stored), on the same branches by the same rule.
extern "C" int lgteun_texture_match_bf16(const __nv_bfloat16* lr,
                                         const __nv_bfloat16* ref,
                                         __nv_bfloat16* t, __nv_bfloat16* s,
                                         int N, int C, int side,
                                         cudaStream_t stream) {
  return texture_match(lr, ref, t, s, N, C, side, stream);
}

extern "C" int lgteun_patch_match_bf16(const __nv_bfloat16* lr_n,
                                       const __nv_bfloat16* ref_n,
                                       const __nv_bfloat16* ref_u,
                                       __nv_bfloat16* t, __nv_bfloat16* s,
                                       int N, int L, int K,
                                       cudaStream_t stream) {
  return patch_match(lr_n, ref_n, ref_u, t, s, N, L, K, stream);
}
#endif  // LGTEUN_BF16_UNIT
