// The FFT mixer's kernels for planes of odd width or with a radix above
// kFftMaxPrime (spectral_head.cu's routes on FftPlaneOf<true>, reached
// through fft_mixer_any), built as a unit of their own so that nvcc
// compiles them beside the kernels of the other planes, in parallel.

#define LGTEUN_FFT_ANY_UNIT
#include "spectral_head.cu"
