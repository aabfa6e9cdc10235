// The bf16 storage entries of block_tail.cu (B3 and B5 with
// __nv_bfloat16 activations), built as a unit of their own so that nvcc
// compiles their instantiations beside the float32 ones, in parallel.

#define LGTEUN_BF16_UNIT
#include "block_tail.cu"
