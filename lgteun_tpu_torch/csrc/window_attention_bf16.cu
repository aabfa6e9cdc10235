// The bf16 storage entries of window_attention.cu (B2 and B6 with
// __nv_bfloat16 in and out), built as a unit of their own so that nvcc
// compiles their instantiations beside the float32 ones, in parallel.

#define LGTEUN_BF16_UNIT
#include "window_attention.cu"
