// LGB mixer head for Hopper (sm_90a): channel LayerNorm, split, and the
// FFT amplitude/phase global mixer on the second half of the channels.
//
// Replaces: lgteun_tpu/ops/spectral_kernel.py::fused_ln_mixer_head_cm
//           (Pallas `_head_kernel` + `mixer_body`).
//
// What bounds it here: not HBM. One 128x128 f32 plane is 64 KB in and
// 64 KB out (about 40 ns of the card's 3.35 TB/s), while its 2-D FFT pair
// is 28 radix-2 stages of 4-8 K butterflies through shared memory, each
// stage behind a __syncthreads, plus an atan2f/sincosf per half-spectrum
// bin. The plane needs 128 KB of shared memory as complex f32, so one
// block runs per SM: latency of shared memory and barriers bounds it.
//
// Design (two launches; the TPU kernel's DFT-as-matmul, polynomial
// atan2 and sin/cos are not carried over):
//  1. ln_split_kernel: one thread per pixel; reads the C channels
//     (coalesced across pixels), writes y1 and the normalised second half
//     into x2, which step 2 transforms in place.
//  2. fft_mixer_kernel: one block per (image, channel) plane held whole in
//     shared memory. Forward decimation-in-frequency FFTs along W then H
//     (natural order in, bit-reversed out: no permutation pass), the
//     amp/phase chain on the W/2+1 columns the half spectrum needs, the
//     inverse decimation-in-time FFT along H (bit-reversed in, natural
//     out), a hermitian fill that makes the W inverse a c2r (the
//     imaginary parts of columns 0 and W/2 are dropped, as irfft does),
//     and the inverse along W. Twiddles are computed in double with
//     sincospi and exact zeros snapped, so the four self-conjugate bins
//     have an exactly zero imaginary part; `im + 0.0f` maps -0 to +0
//     before atan2f, which puts the branch cut on +pi as numpy/torch do
//     (the learned phase scale turns a 2*pi ambiguity into a value
//     change). Built without fast-math for the same reason.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsLN = 256;
constexpr int kThreadsFFT = 512;

__global__ void __launch_bounds__(kThreadsLN)
ln_split_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, float* __restrict__ y1,
                float* __restrict__ y2, int C, int HW, float eps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= HW) return;
  const float* xp = x + (size_t)b * C * HW + p;
  float mu = 0.f;
  for (int c = 0; c < C; ++c) mu += xp[(size_t)c * HW];
  mu /= (float)C;
  float var = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = xp[(size_t)c * HW] - mu;
    var += d * d;
  }
  var /= (float)C;
  const float r = rsqrtf(var + eps);
  const int C2 = C / 2;
  float* o1 = y1 + (size_t)b * C2 * HW + p;
  float* o2 = y2 + (size_t)b * C2 * HW + p;
  for (int c = 0; c < C; ++c) {
    const float v = (xp[(size_t)c * HW] - mu) * r * ln_w[c] + ln_b[c];
    if (c < C2) o1[(size_t)c * HW] = v;
    else o2[(size_t)(c - C2) * HW] = v;
  }
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// tw[j] = exp(-2 pi i j / n) for j < n/2, exact zeros kept exact (+0).
__device__ void make_twiddles(float2* tw, int n) {
  for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * j / n, &s, &c);
    tw[j] = make_float2(fabs(c) < 1e-12 ? 0.f : (float)c,
                        fabs(s) < 1e-12 ? 0.f : (float)-s);
  }
}

// Line l of a row transform starts at l * ld (elements contiguous).
struct RowLines {
  int ld;
  __device__ int operator()(int l) const { return l * ld; }
};

// After the forward DIF along W, position p of a row holds bin
// k = bitrev(p). The half spectrum k < W/2 sits at the even positions
// (k = bitrev(2l)) and k = W/2 at position 1: line l < W/2 -> 2l,
// line W/2 -> 1.
struct HalfSpectrumColumns {
  int half_w;
  __device__ int operator()(int l) const { return l < half_w ? 2 * l : 1; }
};

// Radix-2 decimation in frequency on `nlines` lines of n points
// (element stride es): natural order in, bit-reversed order out.
// kLineFastest maps neighbouring threads to neighbouring lines (for
// column transforms, where elements are a row apart).
template <bool kLineFastest, class Lines>
__device__ void fft_dif(float2* A, const float2* tw, int n, int nlines,
                        int es, Lines lines) {
  const int nbf = n >> 1;
  for (int half = nbf, ts = 1; half >= 1; half >>= 1, ts <<= 1) {
    for (int t = threadIdx.x; t < nlines * nbf; t += blockDim.x) {
      const int line = kLineFastest ? t % nlines : t / nbf;
      const int bf = kLineFastest ? t / nlines : t % nbf;
      const int j = bf & (half - 1);
      const int i0 = ((bf - j) << 1) + j;
      float2* a = A + lines(line) + i0 * es;
      float2* b = a + half * es;
      const float2 u = *a, v = *b;
      *a = cadd(u, v);
      *b = cmul(csub(u, v), tw[j * ts]);
    }
    __syncthreads();
  }
}

// Inverse radix-2 decimation in time (twiddles conjugated, no 1/n):
// bit-reversed order in, natural order out.
template <bool kLineFastest, class Lines>
__device__ void fft_dit_inverse(float2* A, const float2* tw, int n,
                                int nlines, int es, Lines lines) {
  const int nbf = n >> 1;
  for (int half = 1, ts = nbf; half < n; half <<= 1, ts >>= 1) {
    for (int t = threadIdx.x; t < nlines * nbf; t += blockDim.x) {
      const int line = kLineFastest ? t % nlines : t / nbf;
      const int bf = kLineFastest ? t / nlines : t % nbf;
      const int j = bf & (half - 1);
      const int i0 = ((bf - j) << 1) + j;
      float2* a = A + lines(line) + i0 * es;
      float2* b = a + half * es;
      const float2 u = *a, v = cmulc(*b, tw[j * ts]);
      *a = cadd(u, v);
      *b = csub(u, v);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreadsFFT)
fft_mixer_kernel(float* __restrict__ planes, const float* __restrict__ amp_w,
                 const float* __restrict__ amp_b,
                 const float* __restrict__ pha_w,
                 const float* __restrict__ pha_b, int C2, int H, int W,
                 int log_w) {
  extern __shared__ float2 smem[];
  float2* A = smem;               // [H][W] complex plane
  float2* tw_w = A + H * W;       // [W/2]
  float2* tw_h = tw_w + W / 2;    // [H/2]
  const int plane = blockIdx.x;   // b * C2 + c
  const int c = plane % C2;
  float* g = planes + (size_t)plane * H * W;

  make_twiddles(tw_w, W);
  make_twiddles(tw_h, H);
  for (int i = threadIdx.x; i < H * W; i += blockDim.x)
    A[i] = make_float2(g[i], 0.f);
  __syncthreads();

  const int half_w = W / 2, nk = half_w + 1;
  const HalfSpectrumColumns cols{half_w};
  fft_dif<false>(A, tw_w, W, H, 1, RowLines{W});
  fft_dif<true>(A, tw_h, H, nk, W, cols);

  // amp/phase chain with the reference's zero-bin convention and epsilons
  const float aw = amp_w[c], ab = amp_b[c], pw = pha_w[c], pb = pha_b[c];
  for (int t = threadIdx.x; t < H * nk; t += blockDim.x) {
    float2* z = A + (t / nk) * W + cols(t % nk);
    const float re = z->x;
    const float im = z->y + 0.0f;  // -0 -> +0: branch cut at +pi
    const bool zero = (re == 0.0f) && (im == 0.0f);
    float amp = zero ? 0.0f : sqrtf(re * re + im * im);
    float pha = zero ? 0.0f : atan2f(im, re);
    amp = amp * aw + ab;
    pha = pha * pw + pb;
    float sn, cs;
    sincosf(pha, &sn, &cs);
    *z = make_float2(amp * cs + 1e-8f + 1e-8f, amp * sn + 1e-8f);
  }
  __syncthreads();

  fft_dit_inverse<true>(A, tw_h, H, nk, W, cols);

  // hermitian fill: bins k > W/2 of each row are conj(bin W - k); the
  // imaginary parts of bins 0 and W/2 are dropped (c2r semantics)
  for (int t = threadIdx.x; t < H * W; t += blockDim.x) {
    const int row = t / W, p = t % W;
    const int k = __brev(p) >> (32 - log_w);
    float2* z = A + row * W + p;
    if (k == 0 || k == half_w) {
      z->y = 0.f;
    } else if (k > half_w) {
      const int q = __brev(W - k) >> (32 - log_w);
      const float2 s = A[row * W + q];
      *z = make_float2(s.x, -s.y);
    }
  }
  __syncthreads();

  fft_dit_inverse<false>(A, tw_w, W, H, 1, RowLines{W});
  const float norm = 1.0f / (float)(H * W);
  for (int i = threadIdx.x; i < H * W; i += blockDim.x)
    g[i] = fabsf(A[i].x * norm);
}

}  // namespace

// y1, x2 = LN(x)[:, :C/2], global_mixer(LN(x)[:, C/2:]) on [B, C, H, W].
// H and W powers of two, H*W <= 16384 (checked by the Python wrapper).
extern "C" int lgteun_ln_mixer_head(const float* x, const float* ln_w,
                                    const float* ln_b, const float* amp_w,
                                    const float* amp_b, const float* pha_w,
                                    const float* pha_b, float* y1, float* x2,
                                    int B, int C, int H, int W, float eps,
                                    cudaStream_t stream) {
  const int HW = H * W, C2 = C / 2;
  const dim3 grid_ln((HW + kThreadsLN - 1) / kThreadsLN, B);
  ln_split_kernel<<<grid_ln, kThreadsLN, 0, stream>>>(x, ln_w, ln_b, y1, x2,
                                                      C, HW, eps);
  const size_t smem = sizeof(float2) * ((size_t)HW + H / 2 + W / 2);
  const cudaError_t err = cudaFuncSetAttribute(
      fft_mixer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int log_w = 0;
  while ((1 << log_w) < W) ++log_w;
  fft_mixer_kernel<<<B * C2, kThreadsFFT, smem, stream>>>(
      x2, amp_w, amp_b, pha_w, pha_b, C2, H, W, log_w);
  return (int)cudaGetLastError();
}
