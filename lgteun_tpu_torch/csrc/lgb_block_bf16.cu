// The bf16 storage entry of lgb_block.cu (B8 with __nv_bfloat16 or float
// activations and bf16-rounded branches), built as a unit of its own so
// that nvcc compiles the whole-block kernel's instantiations in parallel.

#define LGTEUN_BF16_UNIT
#include "lgb_block.cu"
