// The bf16 storage entry of neighborhood_attention.cu (B12 with
// __nv_bfloat16 x and out), built as a unit of its own so that nvcc
// compiles its instantiations beside the float32 ones, in parallel.

#define LGTEUN_BF16_UNIT
#include "neighborhood_attention.cu"
