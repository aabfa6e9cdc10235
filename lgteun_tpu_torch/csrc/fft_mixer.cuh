// Device code shared by spectral_head.cu (mixer head B1, global mixer B4)
// and lgb_block.cu (whole LGB block B8): the channel LayerNorm + split of
// one pixel, and the FFT amplitude/phase mixer of one [H, W] plane held
// whole in shared memory.
//
// The mixer (semantics of lgteun_tpu_torch/ops/spectral_kernel.py::
// global_mixer_ref): forward FFTs along W then H on the W/2+1 columns the
// half spectrum needs, the amp/phase chain, the inverse along H, a
// hermitian fill that makes the W inverse a c2r (the imaginary parts of
// columns 0 and W/2 are dropped, as irfft does), and the inverse along W.
//
// Lengths: any n = p * m with p = 2^a >= 2 and m odd (the scene engine's
// 48, 72, 80, 144, ... as well as the powers of two). A forward pass is a
// radix-m decimation-in-frequency stage (a direct m-point DFT per group,
// skipped when m = 1) followed by radix-2 DIF stages on the m interleaved
// p-point sub-lines: natural order in, and bin k = m * bitrev(q) + s out
// at position s * p + q. The inverse runs the transposed passes (radix-2
// decimation in time, then the radix-m stage), so it takes that order in
// and gives natural order out; no permutation pass either way.
//
// Exactness the mixer relies on (the learned phase scale turns a 2*pi
// ambiguity into a value change): twiddles are computed in double with
// sincospi and exact zeros snapped; the four self-conjugate bins get an
// exactly zero imaginary part; `im + 0.0f` maps -0 to +0 before atan2f,
// which puts the branch cut on +pi as numpy/torch do; the radix-m stage
// sums (x_j - x_0) * w^jk for the bins k != 0 (the w^jk sum to zero), so a
// plane that is constant along an axis keeps exactly zero bins there at
// any length. Built without fast-math for the same reason.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// Transform length n = p * m, p = 2^log_p >= 2, m odd.
struct FftLen {
  int p, m, log_p;
};

inline FftLen fft_len(int n) {
  FftLen f{1, n, 0};
  while (f.m % 2 == 0) {
    f.m /= 2;
    f.p *= 2;
    ++f.log_p;
  }
  return f;
}

__device__ __forceinline__ int bitrev(int q, int log_p) {
  return (int)(__brev((unsigned)q) >> (32 - log_p));
}
// Position of bin k after a forward pass, and the bin at position q.
__device__ __forceinline__ int bin_pos(int k, FftLen f) {
  if (f.m == 1) return bitrev(k, f.log_p);
  return f.p * (k % f.m) + bitrev(k / f.m, f.log_p);
}
__device__ __forceinline__ int pos_bin(int q, FftLen f) {
  return f.m * bitrev(q & (f.p - 1), f.log_p) + (q >> f.log_p);
}

// tw[j] = exp(-2 pi i j / n) for j < n, exact zeros kept exact (+0).
__device__ __forceinline__ void make_twiddles(float2* tw, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
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

// The columns of the half spectrum (W-bins 0..W/2) in increasing
// position, from a table in shared memory: neighbouring threads of a
// column pass then touch neighbouring columns (in bin order they would
// sit at bit-reversed positions, many on one bank).
struct HalfSpectrumColumns {
  const int* pos;
  __device__ int operator()(int l) const { return pos[l]; }
};

// After the radix-m stage a line holds m interleaved p-point sub-lines;
// sub-line s = (line, k) starts at lines(line) + k * p * es. With
// kLineFastest neighbouring s are neighbouring lines.
template <bool kLineFastest, class Lines>
struct SubLines {
  Lines lines;
  int nlines, m, span;
  __device__ int operator()(int s) const {
    if (m == 1) return lines(s);
    return kLineFastest ? lines(s % nlines) + (s / nlines) * span
                        : lines(s / m) + (s % m) * span;
  }
};

// Radix-2 decimation in frequency on `nsub` sub-lines of p points
// (element stride es): natural order in, bit-reversed order out.
// kLineFastest maps neighbouring threads to neighbouring sub-lines (for
// column transforms, where elements are a row apart).
template <bool kLineFastest, class Sub>
__device__ __forceinline__ void fft_dif(float2* A, const float2* tw,
                                        FftLen f, int nsub, int es,
                                        Sub sub) {
  const int nbf = f.p >> 1;
  for (int half = nbf, ts = f.m; half >= 1; half >>= 1, ts <<= 1) {
    for (int t = threadIdx.x; t < nsub * nbf; t += blockDim.x) {
      const int s = kLineFastest ? t % nsub : t >> (f.log_p - 1);
      const int bf = kLineFastest ? t / nsub : t & (nbf - 1);
      const int j = bf & (half - 1);
      const int i0 = ((bf - j) << 1) + j;
      float2* a = A + sub(s) + i0 * es;
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
template <bool kLineFastest, class Sub>
__device__ __forceinline__ void fft_dit_inverse(float2* A, const float2* tw,
                                                FftLen f, int nsub, int es,
                                                Sub sub) {
  const int nbf = f.p >> 1;
  for (int half = 1, ts = nbf * f.m; half < f.p; half <<= 1, ts >>= 1) {
    for (int t = threadIdx.x; t < nsub * nbf; t += blockDim.x) {
      const int s = kLineFastest ? t % nsub : t >> (f.log_p - 1);
      const int bf = kLineFastest ? t / nsub : t & (nbf - 1);
      const int j = bf & (half - 1);
      const int i0 = ((bf - j) << 1) + j;
      float2* a = A + sub(s) + i0 * es;
      float2* b = a + half * es;
      const float2 u = *a, v = cmulc(*b, tw[j * ts]);
      *a = cadd(u, v);
      *b = csub(u, v);
    }
    __syncthreads();
  }
}

// The radix-m stage, in place. Group (line, j1) holds the m elements
// j1 + p * j2; output k lands on element j1 + p * k:
//   forward  y_k = w_n^(j1 k) * sum_j2 x_j2 w_m^(j2 k)
//   inverse  x_j = sum_k conj(w_m^(j k) w_n^(j1 k)) y_k
// One thread per output; a pass takes whole groups (blockDim / m of
// them), reads them into registers, syncs, and writes them back. `root`
// holds w_m^e = tw[p * e] for e < m contiguously: read from `tw` at
// stride p, the m roots a warp needs would sit on one bank.
template <bool kInverse, bool kLineFastest, class Lines>
__device__ __forceinline__ void fft_odd_stage(float2* A, const float2* tw,
                                              const float2* root, FftLen f,
                                              int nlines, int es,
                                              Lines lines) {
  const int m = f.m, p = f.p;
  const int groups = nlines * p, per = blockDim.x / m;
  const int t = threadIdx.x;
  for (int g0 = 0; g0 < groups; g0 += per) {
    const int g = g0 + t / m, k = t % m;
    const bool active = t < per * m && g < groups;
    float2 acc = make_float2(0.f, 0.f);
    float2* base = A;
    if (active) {
      const int line = kLineFastest ? g % nlines : g / p;
      const int j1 = kLineFastest ? g / nlines : g % p;
      base = A + lines(line) + j1 * es;
      const int step = p * es;
      if (kInverse) {
        int e = 0;  // (k * j2) mod m with k the output index
        for (int j2 = 0; j2 < m; ++j2) {
          const float2 y = cmulc(base[j2 * step], tw[j1 * j2]);
          acc = cadd(acc, cmulc(y, root[e]));
          e += k;
          if (e >= m) e -= m;
        }
      } else if (k == 0) {
        for (int j2 = 0; j2 < m; ++j2) acc = cadd(acc, base[j2 * step]);
      } else {
        const float2 x0 = base[0];
        int e = k;
        for (int j2 = 1; j2 < m; ++j2) {
          acc = cadd(acc, cmul(csub(base[j2 * step], x0), root[e]));
          e += k;
          if (e >= m) e -= m;
        }
        acc = cmul(acc, tw[j1 * k]);
      }
    }
    __syncthreads();
    if (active) base[k * p * es] = acc;
    __syncthreads();
  }
}

template <bool kLineFastest, class Lines>
__device__ __forceinline__ void fft_forward(float2* A, const float2* tw,
                                            const float2* root, FftLen f,
                                            int nlines, int es, Lines lines) {
  if (f.m > 1)
    fft_odd_stage<false, kLineFastest>(A, tw, root, f, nlines, es, lines);
  const SubLines<kLineFastest, Lines> sub{lines, nlines, f.m, f.p * es};
  fft_dif<kLineFastest>(A, tw, f, nlines * f.m, es, sub);
}

template <bool kLineFastest, class Lines>
__device__ __forceinline__ void fft_inverse(float2* A, const float2* tw,
                                            const float2* root, FftLen f,
                                            int nlines, int es, Lines lines) {
  const SubLines<kLineFastest, Lines> sub{lines, nlines, f.m, f.p * es};
  fft_dit_inverse<kLineFastest>(A, tw, f, nlines * f.m, es, sub);
  if (f.m > 1)
    fft_odd_stage<true, kLineFastest>(A, tw, root, f, nlines, es, lines);
}

// Shared memory the mixer of one H x W plane needs: the complex plane,
// the two twiddle tables, the two tables of m-th roots and the half
// spectrum's column positions.
inline size_t fft_mixer_smem(int H, int W) {
  return sizeof(float2) * ((size_t)H * W + H + W + fft_len(H).m +
                           fft_len(W).m) +
         sizeof(int) * (W / 2 + 1);
}

// out = global mixer of the plane `in` (both [H, W]; they may alias, and
// `in` may have been written earlier in the same launch: it is read
// through L2),
// with the channel's affine (aw, ab) on the amplitude and (pw, pb) on the
// phase. `sm` holds fft_mixer_smem(H, W) bytes.
__device__ __forceinline__ void fft_mixer_plane(
    const float* in, float* out, float2* sm, int H, int W, FftLen fh,
    FftLen fw, float aw, float ab, float pw, float pb) {
  const int half_w = W / 2, half_h = H / 2, nk = half_w + 1;
  float2* A = sm;                 // [H][W] complex plane
  float2* tw_w = A + H * W;       // [W]
  float2* tw_h = tw_w + W;        // [H]
  float2* root_w = tw_h + H;      // [m of W]
  float2* root_h = root_w + fw.m;  // [m of H]
  int* colpos = reinterpret_cast<int*>(root_h + fh.m);  // [W/2 + 1]
  make_twiddles(tw_w, W);
  make_twiddles(tw_h, H);
  make_twiddles(root_w, fw.m);
  make_twiddles(root_h, fh.m);
  if (threadIdx.x < 32) {  // warp 0: a ballot prefix over the positions
    for (int q0 = 0, l = 0; q0 < W; q0 += 32) {
      const int q = q0 + threadIdx.x;
      const bool half = q < W && pos_bin(q, fw) <= half_w;
      const unsigned mask = __ballot_sync(0xffffffffu, half);
      if (half) colpos[l + __popc(mask & ((1u << threadIdx.x) - 1u))] = q;
      l += __popc(mask);
    }
  }
  for (int i = threadIdx.x; i < H * W; i += blockDim.x)
    A[i] = make_float2(__ldcg(in + i), 0.f);  // L2: see loads.cuh
  __syncthreads();

  const HalfSpectrumColumns cols{colpos};
  fft_forward<false>(A, tw_w, root_w, fw, H, 1, RowLines{W});
  fft_forward<true>(A, tw_h, root_h, fh, nk, W, cols);

  // amp/phase chain with the reference's zero-bin convention and epsilons
  for (int t = threadIdx.x; t < H * nk; t += blockDim.x) {
    const int r = t / nk, l = t % nk;
    float2* z = A + r * W + cols(l);
    const float re = z->x;
    float im = z->y;
    const int kw = pos_bin(cols(l), fw);
    if (kw == 0 || kw == half_w) {
      const int kh = pos_bin(r, fh);
      if (kh == 0 || kh == half_h) im = 0.f;  // self-conjugate: real
    }
    im = im + 0.0f;  // -0 -> +0: branch cut at +pi
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

  fft_inverse<true>(A, tw_h, root_h, fh, nk, W, cols);

  // hermitian fill: bins k > W/2 of each row are conj(bin W - k); the
  // imaginary parts of bins 0 and W/2 are dropped (c2r semantics)
  for (int t = threadIdx.x; t < H * W; t += blockDim.x) {
    const int row = t / W, q = t % W;
    const int k = pos_bin(q, fw);
    float2* z = A + row * W + q;
    if (k == 0 || k == half_w) {
      z->y = 0.f;
    } else if (k > half_w) {
      const float2 s = A[row * W + bin_pos(W - k, fw)];
      *z = make_float2(s.x, -s.y);
    }
  }
  __syncthreads();

  fft_inverse<false>(A, tw_w, root_w, fw, H, 1, RowLines{W});
  const float norm = 1.0f / (float)(H * W);
  for (int i = threadIdx.x; i < H * W; i += blockDim.x)
    out[i] = fabsf(A[i].x * norm);
}

// y1 = LN(x)[:C/2], y2 = LN(x)[C/2:] at pixel p of image b ([B, C, H*W]
// in, [B, C/2, H*W] out).
__device__ __forceinline__ void ln_split_pixel(
    const float* x, const float* ln_w, const float* ln_b, float* y1,
    float* y2, int C, int HW, int b, int p, float eps) {
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

}  // namespace
