// Loads and stores of activations for the device code shared by the
// kernels. A standalone kernel reads its inputs through the read-only path
// (they do not change during the launch); lgb_block.cu reads its scratch,
// which an earlier item of the same launch wrote on other SMs, through L2
// only (ld.global.cg), never from a possibly stale L1 or read-only cache
// line.
//
// Storage types (LGTEUN_EVAL_DTYPE, ops/__init__.py::storage_dtype): an
// activation lies in memory as float or as __nv_bfloat16. Every load
// upcasts to float (exact), all math is float, and a store rounds once to
// nearest even (__float2bfloat16_rn, what torch's .to(torch.bfloat16) and
// JAX's astype do). Bf16InF32 is a float slot that holds a value rounded to
// bf16: the whole-block kernel's scratch under branch rounding, so that its
// float loads keep working and level 3 rounds where level 2 stores bf16.
// Weights stay float in every mode.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Bf16InF32 {
  float v;
};
struct alignas(8) Bf16InF32x2 {
  float x, y;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 bits (the upper half of a float) as float, exactly
__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float((unsigned)u << 16);
}

template <bool kCoherent>
__device__ __forceinline__ float load_act(const float* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

template <bool kCoherent>
__device__ __forceinline__ float load_act(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return bf16_bits(kCoherent ? __ldcg(u) : __ldg(u));
}

// A plain (generic) load, as a standalone kernel's LN reads x.
__device__ __forceinline__ float load_plain(const float* p) { return *p; }
__device__ __forceinline__ float load_plain(const __nv_bfloat16* p) {
  return bf16_bits(*reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void store_act(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_act(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_act(Bf16InF32* p, float v) {
  p->v = round_bf16(v);
}

// Pairs of consecutive values (the FFT mixer reads a real row as complex
// points): float2, __nv_bfloat162 (4 bytes, element 0 in the low half) or
// Bf16InF32x2, read through L2 (the mixer's plane may have been written
// earlier in the same launch).
template <class T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct PairOf<Bf16InF32> {
  using type = Bf16InF32x2;
};

__device__ __forceinline__ float2 load_pair(const float2* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat162* p) {
  const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void store_pair(float2* p, float2 v) { *p = v; }
__device__ __forceinline__ void store_pair(__nv_bfloat162* p, float2 v) {
  *p = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store_pair(Bf16InF32x2* p, float2 v) {
  *reinterpret_cast<float2*>(p) = make_float2(round_bf16(v.x),
                                              round_bf16(v.y));
}

}  // namespace
