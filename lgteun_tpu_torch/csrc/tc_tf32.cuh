// Tensor-core primitives of the FP32-accurate products of the block tail
// (block_tail.cuh), the window attention (window_attention_tc.cuh), the
// INNT searches (texture_match_tc.cuh), LightNet's stack (lightnet.cu) and
// MDCUN's neighbourhood attention (neighborhood_attention.cu): the TF32
// rounding of the 3xTF32 split, the warpgroup-wide wgmma m64nNk8 TF32
// product (A from registers, B from shared memory, FP32 accumulation)
// with its fences, the warp-wide mma.sync m16n8k8 TF32 product, and the
// cp.async copies that stage weight slabs in shared memory.
//
// 3xTF32: an FP32 value a is a_hi = tf32_rna(a) plus a_lo = tf32_rna(a -
// a_hi) (round to nearest, as cvt.rna.tf32); a product a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each pass exact in the tensor core
// (11-bit significands) and summed in FP32, which keeps about FP32's
// accuracy (a_lo.b_lo is below 2^-22 of a.b).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Round to the nearest TF32 value (ties away from zero); the low 13
// mantissa bits of the result are zero. The same bits as PTX
// cvt.rna.tf32.f32 for every finite v, in two integer instructions: ptxas
// expands cvt.rna to four (an inf/NaN guard the finite activations do not
// need), and the tail is faster this way (PERF.md §6).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// Shared-memory matrix descriptor of wgmma for a K-major operand without
// swizzle: core matrices of 8 rows x 16 bytes (4 TF32 along K), each 128
// contiguous bytes; `lbo` bytes between core matrices adjacent in K,
// `sbo` bytes between core matrices adjacent in N (PTX ISA, "Matrix
// Descriptor Format").
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

// d += A . B for one warpgroup: A 64x8 TF32 in registers (warp w % 4 of
// the group holds rows 16 (w % 4) ..; lane 4g + t: {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}), B 8xN from the descriptor (K-major: B[k][n]
// at row n, column k), d 64xN FP32 (d[j] = {D[g][8j+2t], D[g][8j+2t+1],
// D[g+8][8j+2t], D[g+8][8j+2t+1]} of the warp's 16 rows). Asynchronous:
// issue after wgmma_fence(), then wgmma_commit() and wgmma_wait().
__device__ __forceinline__ void wgmma_tf32(float (&d)[1][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[2][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// v as its TF32 parts: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// v as hi = tf32(v) and lo = v - hi passed whole: mma.sync and wgmma read
// a TF32 operand's top 19 bits and ignore the low 13, so lo enters the
// product truncated (|lo - trunc(lo)| <= 2^-10 |lo| <= 2^-21 |v|, as
// CUTLASS's 3xTF32 rounds its small part toward zero), two instructions
// fewer than rounding it (LightNet's stack and the neighbourhood
// attention, which split every operand as it is loaded).
__device__ __forceinline__ void split_tf32_trunc(float v, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += A . B (3xTF32) for one k-step: A's hi/lo fragments, B's hi and lo
// parts at bh / bl (two core matrices along K, 128 bytes apart), `sbo`
// bytes between n-groups.
template <int NJ>
__device__ __forceinline__ void mma3(float (&d)[NJ][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float* bh,
                                     const float* bl, uint32_t sbo) {
  const uint64_t dh = wgmma_desc(bh, 128, sbo), dl = wgmma_desc(bl, 128, sbo);
  wgmma_tf32(d, al, dh);
  wgmma_tf32(d, ah, dl);
  wgmma_tf32(d, ah, dh);
}

// d += A . B for one warp, mma.sync m16n8k8 TF32 (FP32 accumulation):
// lane 4g + t holds a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b0 = B[t][g], b1 = B[t+4][g] and d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]} (PTX ISA, "Matrix Fragments for mma.m16n8k8").
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A . B (3xTF32) for one warp and k-step of mma.sync m16n8k8: A's
// hi/lo fragments, B's hi (bh0, bh1) and lo (bl0, bl1) fragments; the
// passes in mma3's order (lo.hi, hi.lo, hi.hi).
__device__ __forceinline__ void mma3_sync(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (as CUTLASS's warpgroup_fence_operand).
template <int NJ>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(d[j][q])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier of the 128 threads of warpgroup `wg` (named barrier 1 + wg; 0
// is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Make this thread's earlier shared-memory writes (st.shared, cp.async)
// visible to wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, asynchronously (L2 only: the weight slabs
// are read once per block).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

// 4 bytes global -> shared, asynchronously, or 4 zero bytes where not
// `valid` (gmem is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
