// The INNT searches' body on the tensor cores, shared by texture_match.cu's
// tensor-core kernels (B10 texture_match, B11 patch_match): for L queries
// and L refs, vectors of K <= 40 values, the first maximum over the refs
// of R[i][j] = ref[i] . query[j] for each query j, and its index.
//
// R runs as wgmma m64n64k8 TF32 with the 3xTF32 split (tc_tf32.cuh), K
// zero-padded to kSearchKP = 40 (5 k-steps; the padding adds exact
// zeros):
//
// - Queries are the M dimension: a warpgroup takes a tile of 64 queries,
//   loaded straight into its A fragments (lane 4g + t of warp w: queries
//   16 w + g and + 8, k-slots t and t + 4 of each k-step) and split into
//   hi/lo as loaded; the tiles of a block go round its warpgroups.
// - Refs are the N dimension, in chunks of 64: B from shared memory,
//   K-major, staged once a block in wgmma's core-matrix order (8 refs x 4
//   k, 128 contiguous bytes; the next k-quad 128 bytes on, the next 8 refs
//   kSearchKQ x 128 bytes on), hi and lo apart. Refs past L are zero
//   vectors and are never compared.
// - A query's R values of a chunk lie in one thread's accumulator (rows g
//   and g + 8, columns 8j + 2t and + 1) and in the 3 other lanes of its
//   quad. Each thread takes a row's first maximum of the chunk by a tree
//   in which the later of two neighbouring ranges wins only on a strictly
//   greater value, and keeps a running maximum that the chunks (in
//   increasing index) replace only when strictly greater; the quad then
//   takes the larger value and, on equal values, the smaller index:
//   torch.max's first maximum, with no cross-warp step, and R never
//   leaves the registers.
// - Three warpgroups a block share the tensor cores: while one folds its
//   accumulator, builds its next tile's fragments or (patch_match)
//   transfers its finished tile, the others' products run.
//
// Exact ties stay exact: identical ref vectors have identical hi/lo parts
// and give the same bits through the same passes, and an all-zero query
// gives R = 0 against every ref, so ref 0 wins.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_tf32.cuh"

// Clock stamps of the phases (thread 0 of each block, warpgroup 0's),
// read by lgteun_read_search_stamps: only where LGTEUN_SEARCH_STAMPS (the
// blocks stamped) is defined, as scripts/torch_kernel_ab.py
// --search-phases does. Phases: 0 staging (planes, refs, norms), 1 A
// fragments, 2 products (issue to wait), 3 folding the accumulators, 4
// the quad's merge, the writes and the tile's epilogue (patch_match's
// transfer), 5 the barrier after the search, 6 the fold; 7 the chunks;
// 8, 9 the block's start and end on the global timer (ns); 10 its SM;
// 11 its clocks.
#ifdef LGTEUN_SEARCH_STAMPS
__device__ long long lgteun_search_stamps[LGTEUN_SEARCH_STAMPS][12];
extern "C" int lgteun_read_search_stamps(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, lgteun_search_stamps,
                                   sizeof(lgteun_search_stamps));
}
#endif

namespace {

constexpr int kSearchKS = 5;                  // k-steps of 8
constexpr int kSearchKP = 8 * kSearchKS;      // K padded: 40
constexpr int kSearchKQ = kSearchKP / 4;      // k-quads (core matrices)
constexpr int kSearchTile = 64;               // queries a tile, refs a chunk
constexpr int kSearchWarpgroups = 3;          // at most, a block
constexpr uint32_t kSearchSbo = kSearchKQ * 128;  // bytes between n-groups

#ifdef LGTEUN_SEARCH_STAMPS
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct SearchStamps {
  long long* ph;  // [12], then the last stamp
  __device__ SearchStamps() {
    __shared__ long long st[13];
    ph = st;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 12; ++i) ph[i] = 0;
      ph[8] = global_ns();
      ph[12] = ph[11] = clock64();
    }
  }
  __device__ void at(int i) const {
    if (threadIdx.x == 0) {
      const long long n = clock64();
      ph[i] += n - ph[12];
      ph[7] += i == 2;
      ph[12] = n;
    }
  }
  __device__ void end() const {
    if (threadIdx.x == 0 && blockIdx.x < LGTEUN_SEARCH_STAMPS) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      ph[11] = clock64() - ph[11];
      ph[9] = global_ns();
      ph[10] = sm;
      for (int i = 0; i < 12; ++i) lgteun_search_stamps[blockIdx.x][i] = ph[i];
    }
  }
};
#else
struct SearchStamps {
  __device__ void at(int) const {}
  __device__ void end() const {}
};
#endif

// L rounded up to whole chunks.
__host__ __device__ constexpr int search_pad(int L) {
  return (L + kSearchTile - 1) / kSearchTile * kSearchTile;
}

// Float offset of ref i's k-quad kq in a staged part ([L / 8 n-groups]
// [kSearchKQ][8][4]).
__device__ __forceinline__ int search_ref_offset(int i, int kq) {
  return (i >> 3) * (kSearchKQ * 32) + kq * 32 + (i & 7) * 4;
}

// Stage v = ref i's values 4 kq .. 4 kq + 3 as their TF32 hi and lo
// parts (16 bytes each: a quarter-warp of consecutive refs writes one
// whole core matrix, free of bank conflicts).
__device__ __forceinline__ void search_stage(float* hi, float* lo, int i,
                                             int kq, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) split_tf32(v[u], h[u], l[u]);
  const int o = search_ref_offset(i, kq);
  *reinterpret_cast<float4*>(hi + o) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo + o) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// The first maximum of one row's 16 values of a chunk in this thread
// (v[j][u]: column 8j + u + 2t), as (value, 8j + u): a tree over
// neighbouring ranges in which the later range wins only on a strictly
// greater value (4 compares deep, where a running scan is 16).
__device__ __forceinline__ void search_row_max(float (&v)[8][2],
                                               int (&i)[8][2]) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1)
#pragma unroll
    for (int a = 0; a < 16; a += 2 * s) {
      const int b = a + s;
      if (v[b >> 1][b & 1] > v[a >> 1][a & 1]) {
        v[a >> 1][a & 1] = v[b >> 1][b & 1];
        i[a >> 1][a & 1] = i[b >> 1][b & 1];
      }
    }
}

// Fold one chunk's accumulator into the thread's running maxima (row g:
// q 0, 1; row g + 8: q 2, 3); c0 = the chunk's first ref + 2t. The
// chunk's first maximum of a row replaces the running one only when
// strictly greater (the chunks come in increasing index). kRagged: the
// columns at or past L count as -inf.
template <bool kRagged>
__device__ __forceinline__ void search_fold(const float (&d)[8][4], int c0,
                                            int L, float (&bv)[2],
                                            int (&bi)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[8][2];
    int i[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        v[j][u] = kRagged && c0 + 8 * j + u >= L ? -INFINITY
                                                 : d[j][2 * r + u];
        i[j][u] = 8 * j + u;
      }
    search_row_max(v, i);
    if (v[0][0] > bv[r]) {
      bv[r] = v[0][0];
      bi[r] = c0 + i[0][0];
    }
  }
}

// The first maximum of ref . query over the L refs staged at hi / lo
// (search_stage, zero vectors up to search_pad(L)) for every query of the
// tiles this warpgroup takes (tiles wg, wg + nwg, ...). Value 4m + (lane
// & 3) of query j < L (m < kSearchKQ; zero past its length) is
// scale(r, load(r, m)) with r = row(j), made once a row: the tile's 20
// loads a thread are issued before any scaling. found(j, value, index) is
// called once for each query j, by one thread, and then done(tile) by the
// whole warpgroup. Called by all threads of the block, whole warpgroups.
template <class Row, class Load, class Scale, class Found, class Done>
__device__ __forceinline__ void search_tc(const float* hi, const float* lo,
                                          int L, const Row& row,
                                          const Load& load,
                                          const Scale& scale,
                                          const Found& found, const Done& done,
                                          const SearchStamps& st) {
  const int wg = threadIdx.x >> 7, nwg = blockDim.x >> 7;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16;
  const int chunks = search_pad(L) / kSearchTile;
  for (int tile = wg; tile < chunks; tile += nwg) {
    const int j0 = tile * kSearchTile + row0 + g;   // rows j0 and j0 + 8
    // register q of k-step ks: row g + 8 (q % 2), value 8 ks + t + 4 (q / 2)
    const auto r0 = row(j0), r1 = row(j0 + 8);
    float a[kSearchKS][4];
#pragma unroll
    for (int ks = 0; ks < kSearchKS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[ks][q] = j0 + 8 * (q & 1) < L
                       ? load(q & 1 ? r1 : r0, 2 * ks + (q >> 1)) : 0.f;
    uint32_t ah[kSearchKS][4], al[kSearchKS][4];
#pragma unroll
    for (int ks = 0; ks < kSearchKS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32(scale(q & 1 ? r1 : r0, a[ks][q]), ah[ks][q], al[ks][q]);
    st.at(1);
    float bv[2] = {-INFINITY, -INFINITY};
    int bi[2] = {0, 0};
    for (int c = 0; c < chunks; ++c) {
      float d[8][4] = {};
      const int b = c * kSearchTile * kSearchKP;
      wgmma_fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSearchKS; ++ks)
        mma3(d, ah[ks], al[ks], hi + b + 64 * ks, lo + b + 64 * ks,
             kSearchSbo);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(d);
      st.at(2);
      const int c0 = c * kSearchTile + 2 * t;
      if ((c + 1) * kSearchTile <= L)
        search_fold<false>(d, c0, L, bv, bi);
      else
        search_fold<true>(d, c0, L, bv, bi);
      st.at(3);
    }
    // the quad's four column sets: the larger value; on equal values the
    // smaller index
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, bv[r], o);
        const int i = __shfl_xor_sync(0xffffffffu, bi[r], o);
        if (v > bv[r] || (v == bv[r] && i < bi[r])) {
          bv[r] = v;
          bi[r] = i;
        }
      }
    if (t == 0) {
      if (j0 < L) found(j0, bv[0], bi[0]);
      if (j0 + 8 < L) found(j0 + 8, bv[1], bi[1]);
    }
    done(tile);
    st.at(4);
  }
}

}  // namespace
