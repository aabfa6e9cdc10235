// C ABI helper of the kernel library (no kernel): the message for a
// CUDA error code that a launch entry returned.

#include <cuda_runtime.h>

extern "C" const char* lgteun_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
