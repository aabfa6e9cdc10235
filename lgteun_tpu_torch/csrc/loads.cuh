// Loads of activations for the device code shared by the kernels: a
// standalone kernel reads its inputs through the read-only path (they do
// not change during the launch); lgb_block.cu reads its scratch, which an
// earlier item of the same launch wrote on other SMs, through L2 only
// (ld.global.cg), never from a possibly stale L1 or read-only cache line.

#pragma once

#include <cuda_runtime.h>

namespace {

template <bool kCoherent>
__device__ __forceinline__ float load_act(const float* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

}  // namespace
