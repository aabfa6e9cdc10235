// The bf16 storage entries of texture_match.cu (B10 texture_match and B11
// patch_match with __nv_bfloat16 tensors), built as a unit of their own
// so that nvcc compiles their instantiations beside the float32 ones, in
// parallel.

#define LGTEUN_BF16_UNIT
#include "texture_match.cu"
