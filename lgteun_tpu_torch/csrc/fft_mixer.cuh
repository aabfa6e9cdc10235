// Device code shared by spectral_head.cu (mixer head B1, global mixer B4)
// and lgb_block.cu (whole LGB block B8): the channel LayerNorm + split of
// one pixel, and the FFT amplitude/phase mixer of one [H, W] plane held
// in shared memory as its half spectrum.
//
// The mixer (semantics of lgteun_tpu_torch/ops/spectral_kernel.py::
// global_mixer_ref) on real data:
//  - W forward as a real transform. Even W: row r read as N = W/2 complex
//    values z[n] = x[2n] + i x[2n+1] (the row itself, as float2), an
//    N-point complex FFT, then the split into the half spectrum X[0..N]:
//    X[k] = E[k] + w_W^k O[k], E = (Z[k] + conj Z[N-k]) / 2, O = (Z[k] -
//    conj Z[N-k]) / 2i, with X[0] = Re Z0 + Im Z0 and X[N] = Re Z0 - Im Z0
//    written as exactly real. Each row takes the same arithmetic, so equal
//    rows give equal bits (a plane constant along H keeps exactly zero
//    H-bins); a constant row gives Z[k != 0] = 0 and Re Z0 = Im Z0 bit for
//    bit, so X[k != 0] = 0 exactly. Odd W: the row as W complex points
//    with imaginary part 0 (not two rows packed as one: bins k and W - k
//    of such a pair come out of different twiddle paths, and a constant
//    row would no longer give exactly zero bins), a W-point transform in
//    decimation in time (the row loaded into digit-reversed positions,
//    the bins out in natural order), of which bins 0..(W-1)/2 are kept in
//    columns 0..(W-1)/2.
//  - H forward on the W/2 + 1 columns, the amp/phase chain, H inverse.
//  - W inverse. Even W: a c2r of the same half length: the imaginary
//    parts of X[0] and X[N] are dropped (irfft's semantics), Z'[k] = (X[k]
//    + conj X[N-k]) + i conj(w_W^k) (X[k] - conj X[N-k]), an N-point
//    inverse FFT, and x[2n], x[2n+1] = Re, Im z'[n]. Odd W: the half
//    spectrum extended by X[W-k] = conj X[k] with the imaginary part of
//    X[0] dropped, a W-point inverse in decimation in frequency (natural
//    order in, digit-reversed out), x[t] = Re z'[pos(t)].
//
// Transforms: mixed-radix passes, decimation in frequency forward (natural
// order in, digit-reversed out) and in time inverse (the transposed
// passes), so no permutation pass either way (odd W's rows the other way
// round, as above). A pass of radix r over span L (stride s = L / r) gives
// each thread whole groups: it loads the r elements j + s t of a group
// into registers, runs the r-point DFT there, applies the twiddles
// w_L^(jk) and stores them back; one barrier a pass. Radices 2, 4, 8 and
// 16 run as radix-2 stages in registers, 3, 5, 7 and 9 as a direct DFT in
// the symmetric form (pairs t, r - t); a larger odd prime factor takes a
// pass of one thread per output (fft_pass_generic: up to kFftMaxPrime
// with two outputs a thread and two barriers a round; above it,
// fft_pass_prime: the same terms, each output of four groups at once
// with the r twiddles in a line buffer of shared memory, up to eight
// such items a thread a round). The first W pass reads the plane from
// global memory and the last W inverse pass writes the output there
// (even W); the amp/phase chain takes one bin a thread between the H
// passes. At 128^2: 10 barriers a plane.
//
// Twiddles come from tables made once per (H, W) by fft_tables_kernel
// (spectral_head.cu) and read through the read-only cache; the radix-2^k
// stages in registers use the correctly rounded constants of w_16.
//
// Exactness the mixer relies on (the learned phase scale turns a 2*pi
// ambiguity into a value change): table twiddles are computed in double
// with sincospi and exact zeros snapped; the self-conjugate bins (W-bins 0
// and W/2 of even W, 0 of odd W, times H-bins 0 and H/2 of even H, 0 of
// odd H) get an exactly zero imaginary part; `im + 0.0f` maps -0 to +0
// before atan2f, which puts the branch cut on +pi as numpy/torch do;
// every butterfly works on differences (a - b in radix 2; x_t - x_0 at
// odd radices, where the w^tk sum to zero) and the DC path only on sums,
// so a plane that is constant along an axis keeps exactly zero bins there
// at any length (in decimation in time too: the groups that take a
// twiddle then hold exact zeros). Built without fast-math for the same
// reason.
//
// Shared memory: the half spectrum [H][ld] of float2, ld = N + 1 rounded
// up to odd (odd W: ld = W, the whole row during its transform), so that
// threads on neighbouring rows hit distinct banks; column passes give
// neighbouring threads neighbouring columns; then, where a radix is above
// kFftMaxPrime, the line buffer.
//
// A plane whose half spectrum does not fit one block's shared memory
// (fft_mixer_smem > kFftSmemBytes, e.g. above 240 x 240) takes the
// cluster route where the shared memory of a thread-block cluster of K
// blocks holds it (fft_cluster_plan, K = 2 to 16: up to 512^2 and 1024 x
// 512): one launch, block k holding rows [k rows, (k + 1) rows) of the
// half spectrum, its range of columns gathered from every block's rows
// through distributed shared memory a chunk at a time
// (fft_mixer_plane_cluster). A plane no cluster holds (1024^2 and up)
// takes the global-memory route (fft_global_plan, spectral_head.cu): the
// half spectrum in a device scratch between three launches, stored
// column by column ([W/2 + 1][H] a plane): (a) the W forward and split of
// a range of rows a block, written out column-wise, (b) the H forward,
// amp/phase and H inverse of a range of columns a block, each column one
// contiguous run in and out, (c) the c2r and W inverse of a range of rows
// a block, read back column-wise. All run the same plan, tables and parts
// (FftPlaneOf), so each value takes the arithmetic it takes in one block
// (fft_mixer_route picks the route).
//
// Sizes: every H <= kFftMaxH (14,514) and W <= kFftMaxW (29,026; odd W <=
// kFftMaxWOdd, 14,513), any factorization: the global route holds a row
// and a column of each with the line buffer (fft_global_plan).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <utility>

#include "loads.cuh"

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
__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

constexpr int kFftMaxPass = 8;
// fft_pass_generic gives each thread two outputs of whole groups a round
// (blocks of 256 threads or more); a larger radix takes fft_pass_prime,
// with a line buffer of r float2 in shared memory
constexpr int kFftMaxPrime = 512;
// the largest sides: the global route holds a row and a column of each,
// with the line buffer, at any factorization (fft_global_plan)
constexpr int kFftMaxH = 14514, kFftMaxW = 29026, kFftMaxWOdd = 14513;

// The passes of an n-point transform in decimation-in-frequency order.
struct FftPlan {
  int n, npass;
  int radix[kFftMaxPass];
};

__host__ __device__ __forceinline__ bool fft_register_radix(int r) {
  return r == 2 || r == 4 || r == 8 || r == 16 || r == 3 || r == 5 ||
         r == 7 || r == 9;
}

// The plan of an n-point transform: the power of two in ceil(a / 4)
// passes of 2^3-2^4 (as even as they go, larger first), then the odd part
// as 9s, 3s, 5s, 7s and its other primes (a row's first pass, which reads
// global memory, is then a register radix wherever W % 4 == 0). npass =
// -1 when the passes exceed kFftMaxPass.
inline FftPlan fft_plan(int n) {
  FftPlan p{};
  p.n = n;
  int a = 0, m = n;
  while (m % 2 == 0) {
    m /= 2;
    ++a;
  }
  int odd[kFftMaxPass + 1], nodd = 0;
  for (int r : {9, 3, 5, 7})
    while (m % r == 0 && nodd <= kFftMaxPass) {
      odd[nodd++] = r;
      m /= r;
    }
  for (int q = 11; m > 1 && nodd <= kFftMaxPass; q += 2)
    while (m % q == 0 && nodd <= kFftMaxPass) {
      odd[nodd++] = q;
      m /= q;
    }
  const int np2 = (a + 3) / 4;
  if (m > 1 || np2 + nodd > kFftMaxPass) {
    p.npass = -1;
    return p;
  }
  int pow2[kFftMaxPass];
  for (int i = 0; i < np2; ++i) pow2[i] = 1 << (a / np2 + (i < a % np2));
  p.npass = np2 + nodd;
  for (int i = 0; i < np2; ++i) p.radix[i] = pow2[i];
  for (int i = 0; i < nodd; ++i) p.radix[np2 + i] = odd[i];
  return p;
}

// Position of bin k after the forward passes of plan p: digit i of k (in
// the mixed radix of the passes, first pass least significant) weighs
// n / (r_1 ... r_i).
__host__ __device__ __forceinline__ int fft_pos(const FftPlan& p, int k) {
  int span = p.n, pos = 0;
  for (int i = 0; i < p.npass; ++i) {
    const int r = p.radix[i];
    span /= r;
    pos += (k % r) * span;
    k /= r;
  }
  return pos;
}

// Everything the mixer of an H x W plane needs: the row plan (n = W/2
// points for even W, W for odd W), the column plan (H points), the row
// pitch, the position qh of H-bin H/2 (-1 for odd H: there is none), the
// float offsets in its tables (fft_tables_kernel), which begin with this
// plan itself (kFftPlanFloats floats), then hold the row twiddles w_n^j
// (n float2), the half twiddles w_W^k (N + 1 for even W; none for odd W),
// the column twiddles w_H^j (H) and the row positions fft_pos(row, k) (n
// ints), and the width W. Each block copies the plan into the head of
// its shared memory and reads it from there where it is used: held in
// registers, in a kernel's parameters or behind read-only loads (which
// the compiler merges into one register for the whole kernel), its values
// spilled at 128 registers a thread or moved the parameters to local
// memory.
struct FftMixerPlan {
  FftPlan row, col;
  int ld, qh;
  int tw_row, tw_half, tw_col, pos_row, floats;
  int w;
};
constexpr int kFftPlanFloats = 28;
static_assert(sizeof(FftMixerPlan) <= 4 * kFftPlanFloats, "plan header");

inline bool fft_mixer_plan(int H, int W, FftMixerPlan* p) {
  if (H < 2 || W < 2 || H > kFftMaxH || W > (W % 2 ? kFftMaxWOdd : kFftMaxW))
    return false;
  const int n = W % 2 ? W : W / 2;
  p->row = fft_plan(n);
  p->col = fft_plan(H);
  if (p->row.npass < 0 || p->col.npass < 0) return false;
  p->ld = W % 2 ? W : (n + 1) % 2 ? n + 1 : n + 2;
  p->qh = H % 2 ? -1 : fft_pos(p->col, H / 2);
  p->tw_row = kFftPlanFloats;
  p->tw_half = p->tw_row + 2 * n;
  p->tw_col = p->tw_half + (W % 2 ? 0 : 2 * n + 2);
  p->pos_row = p->tw_col + 2 * H;
  p->floats = p->pos_row + n;
  p->w = W;
  return true;
}

// The line buffer fft_pass_prime needs (float2): the largest radix
// above kFftMaxPrime of the row and column plans, else 0.
inline int fft_mixer_gbuf(const FftMixerPlan& p) {
  int g = 0;
  for (const FftPlan* f : {&p.row, &p.col})
    for (int i = 0; i < f->npass; ++i)
      if (f->radix[i] > kFftMaxPrime && f->radix[i] > g) g = f->radix[i];
  return g;
}

// Shared memory the mixer of one H x W plane needs in one block: the
// plan, the half spectrum, the line buffer (none without a plan).
inline size_t fft_mixer_smem(int H, int W) {
  FftMixerPlan p;
  if (!fft_mixer_plan(H, W, &p)) return ~(size_t)0;
  return sizeof(float) * kFftPlanFloats +
         sizeof(float2) * ((size_t)H * p.ld + fft_mixer_gbuf(p));
}

// Shared memory one block may hold on the H100 (227 KB): a plane whose
// fft_mixer_smem exceeds it takes the cluster or the global route.
constexpr size_t kFftSmemBytes = 232448;
// Two blocks an SM hold half of it each.
constexpr size_t kFftGlobalSmem = kFftSmemBytes / 2;

// The blocks a plane's n rows (or columns) split into on the global
// route, at most `most` lines a block, for `planes` planes on `slots`
// resident blocks: of the counts from the fewest up to four times that,
// the one whose waves (rounded up) times a block's lines (plus
// kFftBlockLines for a block's own cost: its plan, its barriers) is
// least. The fewest alone left the last wave mostly idle (16 planes of
// 1024^2: 592 blocks, 2.24 waves of 264 run as 3).
constexpr int kFftBlockLines = 2;

inline int fft_global_split(int n, int most, long long planes, int slots) {
  const int fewest = (n + most - 1) / most;
  int best = fewest;
  long long best_cost = -1;
  for (int nb = fewest; nb <= 4 * fewest && nb <= n; ++nb) {
    const long long waves = (planes * nb + slots - 1) / slots;
    const long long cost = waves * ((n + nb - 1) / nb + kFftBlockLines);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = nb;
    }
  }
  return (n + best - 1) / best;  // lines a block
}

// The global route of `planes` H x W planes on `sms` SMs: `rows` rows a
// block of parts (a) and (c), `row_blocks` such blocks a plane, of
// `row_threads` threads (256, two blocks an SM, where a row and the line
// buffer fit half of the shared memory; else 512, one an SM); `cols`
// columns a block of part (b), `col_blocks` such blocks a plane, of
// `col_threads` threads (the same rule), each column staged with the odd
// pitch `pitch` (H rounded up to odd); the lines a block as many as its
// shared memory holds, split evenly over the waves (fft_global_split);
// the shared memory of each (the plan, the rows or columns, the line
// buffer). The scratch holds [planes][W/2 + 1][H] float2: a plane's half
// spectrum column by column. False where there is no plan (every plane
// within kFftMaxH, kFftMaxW and kFftMaxWOdd has one, and this route holds
// it).
struct FftGlobalPlan {
  int rows, row_blocks, row_threads;
  int cols, pitch, col_blocks, col_threads;
  size_t smem_rows, smem_cols;
};

inline bool fft_global_plan(int H, int W, long long planes, int sms,
                            FftGlobalPlan* g) {
  FftMixerPlan p;
  if (!fft_mixer_plan(H, W, &p) || planes < 1 || sms < 1) return false;
  const size_t head = sizeof(float) * kFftPlanFloats +
                      sizeof(float2) * (size_t)fft_mixer_gbuf(p);
  const size_t row = sizeof(float2) * (size_t)p.ld;
  const int half = W / 2 + 1;
  g->pitch = H | 1;
  const size_t col = sizeof(float2) * (size_t)g->pitch;
  if (head + row > kFftSmemBytes || head + col > kFftSmemBytes) return false;
  const bool rows2 = head + row <= kFftGlobalSmem;
  const bool cols2 = head + col <= kFftGlobalSmem;
  g->row_threads = rows2 ? 256 : 512;
  g->col_threads = cols2 ? 256 : 512;
  const size_t rows = ((rows2 ? kFftGlobalSmem : kFftSmemBytes) - head) / row;
  const size_t cols = ((cols2 ? kFftGlobalSmem : kFftSmemBytes) - head) / col;
  g->rows = fft_global_split(H, rows < (size_t)H ? (int)rows : H, planes,
                             rows2 ? 2 * sms : sms);
  g->row_blocks = (H + g->rows - 1) / g->rows;
  g->cols = fft_global_split(half, cols < (size_t)half ? (int)cols : half,
                             planes, cols2 ? 2 * sms : sms);
  g->col_blocks = (half + g->cols - 1) / g->cols;
  g->smem_rows = head + row * g->rows;
  g->smem_cols = head + col * g->cols;
  return true;
}

// The largest cluster the route takes: 8 blocks are portable, 16 need
// cudaFuncAttributeNonPortableClusterSizeAllowed (the H100 has them).
constexpr int kFftMaxCluster = 16;

// The cluster route of an H x W plane on k blocks: `rows` rows of the
// half spectrum a block (block j: [j rows, (j + 1) rows) of H), `cols` of
// its W/2 + 1 columns a block likewise, run `chunk` columns at a time,
// staged with the odd row pitch `pitch`; each block's shared memory (the
// plan, its rows, the stage, the line buffer). False where there is no
// plan, or a block's rows and one staged column exceed kFftSmemBytes.
struct FftClusterPlan {
  int k, rows, cols, chunk, pitch;
  size_t smem;
};

inline bool fft_cluster_plan(int H, int W, int k, FftClusterPlan* c) {
  FftMixerPlan p;
  if (k < 1 || !fft_mixer_plan(H, W, &p)) return false;
  const int half = W / 2 + 1, rows = (H + k - 1) / k;
  const size_t mine = sizeof(float) * kFftPlanFloats +
                      sizeof(float2) *
                          ((size_t)rows * p.ld + fft_mixer_gbuf(p));
  const size_t col = sizeof(float2) * (size_t)H;
  if (mine + col > kFftSmemBytes) return false;
  // the widest stage that fits, odd (the pitch is the chunk rounded up
  // to odd), at most W/2 + 2
  size_t fit = (kFftSmemBytes - mine) / col;
  if (fit > (size_t)half + 1) fit = half + 1;
  const int widest = fit % 2 ? (int)fit : (int)fit - 1;
  c->k = k;
  c->rows = rows;
  c->cols = (half + k - 1) / k;
  const int chunks = (c->cols + widest - 1) / widest;
  c->chunk = (c->cols + chunks - 1) / chunks;
  c->pitch = c->chunk | 1;
  c->smem = mine + col * c->pitch;
  return true;
}

// The routes of the mixer of one H x W plane, chosen by its shape: the
// one-block body where its half spectrum fits (kFftSmem), else a cluster
// of the smallest K (a power of two up to kFftMaxCluster) whose blocks
// hold it (the value K), else the global route (kFftGlobal); kFftNone
// where there is no plan.
constexpr int kFftNone = -2, kFftGlobal = -1, kFftSmem = 0;

inline int fft_mixer_route(int H, int W) {
  FftGlobalPlan g;
  FftClusterPlan c;
  if (!fft_global_plan(H, W, 1, 1, &g)) return kFftNone;
  if (fft_mixer_smem(H, W) <= kFftSmemBytes) return kFftSmem;
  for (int k = 2; k <= kFftMaxCluster; k *= 2)
    if (fft_cluster_plan(H, W, k, &c)) return k;
  return kFftGlobal;
}

// The cluster size a launch of `planes` planes on `sms` SMs takes: the
// smallest k that holds a plane (fft_mixer_route), doubled while the
// clusters still take at most half of the SMs (one block an SM). Fewer
// blocks leave SMs idle where the planes are few; more split a plane
// thinner than a block's threads (on the H100 at 256^2-512^2, 1 to 512
// planes, half of the SMs timed best).
inline int fft_cluster_size(int k, long long planes, int sms) {
  while (2 * k <= kFftMaxCluster && planes * 4 * k <= sms) k *= 2;
  return k;
}

// exp(-2 pi i j / n) in double, exact zeros kept exact (+0).
__device__ __forceinline__ float2 fft_twiddle(int j, int n) {
  double s, c;
  sincospi(2.0 * j / n, &s, &c);
  return make_float2(fabs(c) < 1e-12 ? 0.f : (float)c,
                     fabs(s) < 1e-12 ? 0.f : (float)-s);
}

// z * w_16^e for e < 8: the correctly rounded roots; e = 0 and 4 exact.
__device__ __forceinline__ float2 mul_root16(float2 z, int e) {
  constexpr float c1 = 0.923879532511286756f, s1 = 0.382683432365089772f,
                  h = 0.707106781186547524f;
  switch (e) {
    case 0: return z;
    case 1: return cmul(z, make_float2(c1, -s1));
    case 2: return cmul(z, make_float2(h, -h));
    case 3: return cmul(z, make_float2(s1, -c1));
    case 4: return make_float2(z.y, -z.x);
    case 5: return cmul(z, make_float2(-s1, -c1));
    case 6: return cmul(z, make_float2(-h, -h));
    default: return cmul(z, make_float2(-c1, -s1));
  }
}

// log2(R) and the bit reversal of I in B bits as template constants: a
// recursive constexpr function called in device code was evaluated at run
// time, which put the registers it indexes into local memory.
template <int R>
struct Log2 {
  static constexpr int value = 1 + Log2<R / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};
template <int I, int B>
struct BitRev {
  static constexpr int value = ((I & 1) << (B - 1)) |
                               BitRev<(I >> 1), B - 1>::value;
};
template <int I>
struct BitRev<I, 0> {
  static constexpr int value = 0;
};

template <int R, int... I>
__device__ __forceinline__ void bit_reverse(float2 (&v)[R],
                                            std::integer_sequence<int, I...>) {
  const float2 t[R] = {v[BitRev<I, Log2<R>::value>::value]...};
  ((v[I] = t[I]), ...);
}

// In-place R-point DFT in registers, natural order in and out: radix-2
// decimation-in-frequency stages, then the bit reversal as a renaming.
template <int R>
__device__ __forceinline__ void dft_pow2(float2 (&v)[R]) {
#pragma unroll
  for (int st = 0; st < Log2<R>::value; ++st) {
    const int half = R >> (st + 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & half) continue;
      const float2 u = v[i], w = v[i + half];
      v[i] = cadd(u, w);
      v[i + half] = mul_root16(csub(u, w), (i & (half - 1)) * (8 / half));
    }
  }
  bit_reverse(v, std::make_integer_sequence<int, R>{});
}

// In-place R-point DFT for odd R, w[e - 1] = w_R^e for e <= (R - 1) / 2:
// y_0 = sum x_t; for k != 0, with d_t = x_t - x_0, a_t = d_t + d_(R-t)
// and b_t = d_t - d_(R-t): y_k = A_k - i B_k and y_(R-k) = A_k + i B_k,
// A_k = sum_t a_t cos(2 pi t k / R), B_k = sum_t b_t sin(2 pi t k / R).
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&v)[R], const float2 (&w)[4]) {
  constexpr int Q = (R - 1) / 2;
  float2 a[Q], b[Q];
  float2 y0 = v[0];
#pragma unroll
  for (int t = 1; t < R; ++t) y0 = cadd(y0, v[t]);
#pragma unroll
  for (int t = 1; t <= Q; ++t) {
    const float2 d1 = csub(v[t], v[0]), d2 = csub(v[R - t], v[0]);
    a[t - 1] = cadd(d1, d2);
    b[t - 1] = csub(d1, d2);
  }
#pragma unroll
  for (int k = 1; k <= Q; ++k) {
    float2 A = make_float2(0.f, 0.f), B = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 1; t <= Q; ++t) {
      const int e = t * k % R;
      // cos and sin of 2 pi e / R from w_R^min(e, R-e) = (cos, -sin);
      // e = 0 where R is composite (9)
      const float c = e == 0 ? 1.f : e <= Q ? w[e - 1].x : w[R - e - 1].x;
      const float s = e == 0 ? 0.f : e <= Q ? -w[e - 1].y : w[R - e - 1].y;
      A = make_float2(A.x + a[t - 1].x * c, A.y + a[t - 1].y * c);
      B = make_float2(B.x + b[t - 1].x * s, B.y + b[t - 1].y * s);
    }
    v[k] = make_float2(A.x + B.y, A.y - B.x);
    v[R - k] = make_float2(A.x - B.y, A.y + B.x);
  }
  v[0] = y0;
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R], const float2 (&w)[4]) {
  if constexpr ((R & (R - 1)) == 0)
    dft_pow2<R>(v);
  else
    dft_odd<R>(v, w);
}

// The inverse (conjugate roots, no 1/R): conj(DFT(conj(v))).
template <int R>
__device__ __forceinline__ void idft(float2 (&v)[R], const float2 (&w)[4]) {
#pragma unroll
  for (int t = 0; t < R; ++t) v[t] = cconj(v[t]);
  dft<R>(v, w);
#pragma unroll
  for (int t = 0; t < R; ++t) v[t] = cconj(v[t]);
}

// The lines a pass runs over: line l starts at l * lstride, its
// elements es apart (float2 of shared memory); line_fast gives
// neighbouring threads neighbouring lines, else neighbouring groups of
// one line.
struct FftLines {
  int count, lstride, es;
  bool line_fast;
};

// Where a pass reads and writes: shared memory only, the plane's rows
// from global memory into shared memory (first forward row pass), or
// shared memory to |.| * norm in global memory (last inverse row pass).
enum FftIo { kFftShared, kFftLoad, kFftStore };

// x / d for 0 <= x < 2^20 by a float reciprocal, in place of an integer
// division: (x + 0.5) / d lies at least 0.5 / d from an integer, more than
// the rounding error of the product (below 2^20 / d * 2^-23).
struct FftDiv {
  int d;
  float inv;
  __device__ explicit FftDiv(int divisor)
      : d(divisor), inv(1.0f / (float)divisor) {}
  __device__ __forceinline__ int operator()(int x) const {
    return __float2int_rz(((float)x + 0.5f) * inv);
  }
};

// The groups of a pass of span L and stride s over lines ln, n / R of a
// line.
struct FftGroups {
  FftDiv count, per_line, s;
  int L;
  bool line_fast;
  __device__ FftGroups(const FftLines& ln, int n, int R, int span)
      : count(ln.count), per_line(n / R), s(span / R), L(span),
        line_fast(ln.line_fast) {}
  // group g: its line, the element index of its first element (b L + j),
  // and j
  __device__ __forceinline__ void operator()(int g, int* line, int* e0,
                                             int* j) const {
    int q;
    if (line_fast) {
      q = count(g);
      *line = g - q * count.d;
    } else {
      *line = per_line(g);
      q = g - *line * per_line.d;
    }
    const int b = s(q);
    *j = q - b * s.d;
    *e0 = b * L + *j;
  }
};

// T itself, in a context where it is not deduced (a null gin or gout
// keeps its default pair type).
template <class T>
struct FftSame {
  using type = T;
};

// One radix-R pass over span L of n-point lines: forward or inverse
// (kInv: the conjugate twiddles and the inverse DFT), in decimation in
// frequency (kDit false: the DFT, then the twiddles w_L^(jk)) or in time
// (the twiddles, then the DFT). The rows and columns run forward in
// frequency and inverse in time (kDit = kInv), odd W's rows the other way
// round. `tw` holds w_n^i for i < n; gin / gout are the plane's rows as
// pairs (n a row; loads.cuh: float2, or bf16 pairs) for kFftLoad /
// kFftStore.
template <int R, bool kInv, int kIo, class GI = float2, class GO = float2,
          bool kDit = kInv>
__device__ __forceinline__ void fft_pass(float2* A, const FftLines ln,
                                         int n, int L, const float2* tw,
                                         const typename FftSame<GI>::type* gin,
                                         typename FftSame<GO>::type* gout,
                                         float norm) {
  const int s = L / R, twstep = n / L;
  const int groups = ln.count * (n / R);
  const FftGroups group(ln, n, R, L);
  float2 w[4] = {};
  if constexpr ((R & (R - 1)) != 0) {
#pragma unroll
    for (int e = 1; e <= (R - 1) / 2; ++e) w[e - 1] = __ldg(tw + e * (n / R));
  }
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    int line, e0, j;
    group(g, &line, &e0, &j);
    float2* base = A + line * ln.lstride + e0 * ln.es;
    const int step = s * ln.es;
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t)
      v[t] = kIo == kFftLoad ? load_pair(gin + line * n + e0 + s * t)
                             : base[t * step];
    if (kDit && j) {
#pragma unroll
      for (int k = 1; k < R; ++k)
        v[k] = kInv ? cmulc(v[k], __ldg(tw + j * k * twstep))
                    : cmul(v[k], __ldg(tw + j * k * twstep));
    }
    if (kInv)
      idft<R>(v, w);
    else
      dft<R>(v, w);
    if (!kDit && j) {
#pragma unroll
      for (int k = 1; k < R; ++k)
        v[k] = kInv ? cmulc(v[k], __ldg(tw + j * k * twstep))
                    : cmul(v[k], __ldg(tw + j * k * twstep));
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (kIo == kFftStore)
        store_pair(gout + line * n + e0 + s * t,
                   make_float2(fabsf(v[t].x * norm), fabsf(v[t].y * norm)));
      else
        base[t * step] = v[t];
    }
  }
}

// Output k of the radix-r group at `base` (elements `step` apart; j its
// index in the span, twstep = n / L, rs = n / r) in the direct form of
// fft_pass_generic: forward in frequency, w_L^(jk) * (sum_t x_t for k =
// 0, else sum_(t>=1) (x_t - x_0) w_r^(tk)); forward in time, the same on
// x'_t = w_L^(jt) x_t; inverse in time, sum_t conj(w_r^(tk) w_L^(jt))
// x_t; inverse in frequency, conj(w_L^(jk)) sum_t conj(w_r^(tk)) x_t.
template <bool kInv, bool kDit>
__device__ __forceinline__ float2 fft_generic_output(const float2* base,
                                                     int step, int r, int rs,
                                                     int j, int twstep, int k,
                                                     const float2* tw) {
  float2 a = make_float2(0.f, 0.f);
  if (kInv) {
    for (int t = 0, e = 0; t < r; ++t) {
      const float2 y = kDit ? cmulc(base[t * step], __ldg(tw + j * t * twstep))
                            : base[t * step];
      a = cadd(a, cmulc(y, __ldg(tw + e * rs)));
      e += k;
      if (e >= r) e -= r;
    }
    if (!kDit && j) a = cmulc(a, __ldg(tw + j * k * twstep));
    return a;
  }
  auto in = [&](int t) {
    const float2 x = base[t * step];
    return kDit && j ? cmul(x, __ldg(tw + j * t * twstep)) : x;
  };
  if (k == 0) {
    for (int t = 0; t < r; ++t) a = cadd(a, in(t));
  } else {
    const float2 x0 = in(0);
    for (int t = 1, e = k; t < r; ++t) {
      a = cadd(a, cmul(csub(in(t), x0), __ldg(tw + e * rs)));
      e += k;
      if (e >= r) e -= r;
    }
    if (!kDit) a = cmul(a, __ldg(tw + j * k * twstep));
  }
  return a;
}

// A pass of odd prime radix r > 9 (<= kFftMaxPrime): one thread per
// output, two outputs a thread, whole groups a round; each round reads
// into registers, syncs, writes and syncs (fft_generic_output).
template <bool kInv, bool kDit>
__device__ __noinline__ void fft_pass_generic(float2* A, const FftLines ln,
                                              int n, int L, int r,
                                              const float2* tw) {
  const int s = L / r, twstep = n / L, rs = n / r;
  const int groups = ln.count * (n / r);
  const int per = 2 * (int)blockDim.x / r;  // whole groups a round
  const FftGroups group(ln, n, r, L);
  for (int g0 = 0; g0 < groups; g0 += per) {
    float2 acc[2];
    int dst[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int o = threadIdx.x + u * blockDim.x;
      const int g = g0 + o / r, k = o % r;
      dst[u] = -1;
      if (o >= per * r || g >= groups) continue;
      int line, e0, j;
      group(g, &line, &e0, &j);
      const float2* base = A + line * ln.lstride + e0 * ln.es;
      acc[u] = fft_generic_output<kInv, kDit>(base, s * ln.es, r, rs, j,
                                              twstep, k, tw);
      dst[u] = line * ln.lstride + (e0 + s * k) * ln.es;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (dst[u] >= 0) A[dst[u]] = acc[u];
    __syncthreads();
  }
}

// A radix above kFftMaxPrime: the plan puts it last (the largest prime
// factor; a side below 521^2 has at most one), so its span is r itself:
// groups of r neighbouring elements, j = 0, no twiddles w_L. Output k of
// a group takes fft_generic_output's terms with j = 0, in its order:
// forward, the inputs' sum for k = 0, else sum_(t>=1) (x_t - x_0)
// w_r^(tk); inverse, sum_t x_t conj(w_r^(tk)); so exact zeros stay exact.
// An item is output k of Q groups (at A + off[q], elements es apart),
// which share each term's twiddle w_r^e = w[e]; its sums are kept in
// registers and stored into `out` at the end.
template <bool kInv, int Q>
__device__ __forceinline__ void fft_prime_item(const float2* A,
                                               const int (&off)[Q], int es,
                                               int r, int k, const float2* w,
                                               float2* out) {
  float2 a[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) a[q] = make_float2(0.f, 0.f);
  if (kInv) {
    for (int t = 0, e = 0; t < r; ++t) {
      const float2 wt = w[e];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        a[q] = cadd(a[q], cmulc(A[off[q] + t * es], wt));
      e += k;
      if (e >= r) e -= r;
    }
  } else if (k == 0) {
    for (int t = 0; t < r; ++t)
#pragma unroll
      for (int q = 0; q < Q; ++q) a[q] = cadd(a[q], A[off[q] + t * es]);
  } else {
    float2 x0[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) x0[q] = A[off[q]];
    for (int t = 1, e = k; t < r; ++t) {
      const float2 wt = w[e];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        a[q] = cadd(a[q], cmul(csub(A[off[q] + t * es], x0[q]), wt));
      e += k;
      if (e >= r) e -= r;
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) out[q] = a[q];
}

// fft_pass_prime's items a thread a round, groups an item covers (each
// term's twiddle read once for them), and the largest radix that form
// takes on blocks of 256 threads or more (every route's); above it a
// thread keeps up to kFftPrimeSlots outputs of one group (any radix of a
// side within kFftMaxH, kFftMaxW and kFftMaxWOdd).
constexpr int kFftPrimeItems = 8, kFftPrimeSet = 4;
constexpr int kFftPrimeTiled = kFftPrimeItems * 256;
constexpr int kFftPrimeSlots = (kFftMaxH + 255) / 256;
static_assert(kFftPrimeSlots >= kFftPrimeItems * kFftPrimeSet &&
                  256 * kFftPrimeSlots >= kFftMaxW / 2 &&
                  256 * kFftPrimeSlots >= kFftMaxWOdd,
              "fft_pass_prime's outputs");

// The pass of a radix r above kFftMaxPrime (span r, fft_prime_item) over
// ln's n-point lines: the twiddles w_r^e into the line buffer `buf` (r
// float2 of shared memory); then, up to kFftPrimeTiled, rounds of whole
// sets of kFftPrimeSet groups, as many as kFftPrimeItems items a thread
// hold (neighbouring threads on neighbouring outputs of a set: each
// input read is one address for most warps); above it, a group a round.
// A thread runs its items one after another and keeps their outputs in
// its local memory (a stack array: in registers they took the registers
// of every kernel that calls the pass) until a barrier, then writes them
// into the groups' places, a barrier. Each output takes the same terms
// in the same order either way, so the bits do not depend on the route.
template <bool kInv>
__device__ __noinline__ void fft_pass_prime(float2* A, const FftLines ln,
                                            int n, int r, const float2* tw,
                                            float2* buf) {
  const int rs = n / r, es = ln.es;
  const int groups = ln.count * (n / r);
  const FftGroups group(ln, n, r, r);
  // the offset in A of group g's first element
  auto offset = [&](int g) {
    int line, e0, j;
    group(g, &line, &e0, &j);
    return line * ln.lstride + e0 * es;
  };
  for (int e = threadIdx.x; e < r; e += blockDim.x)
    buf[e] = __ldg(tw + e * rs);
  __syncthreads();
  float2 acc[kFftPrimeSlots];
  if (r > kFftPrimeTiled) {
    for (int g = 0; g < groups; ++g) {
      const int off[1] = {offset(g)};
#pragma unroll 1
      for (int u = 0, k = threadIdx.x; k < r; ++u, k += blockDim.x)
        fft_prime_item<kInv, 1>(A, off, es, r, k, buf, acc + u);
      __syncthreads();
#pragma unroll 1
      for (int u = 0, k = threadIdx.x; k < r; ++u, k += blockDim.x)
        A[off[0] + k * es] = acc[u];
      __syncthreads();
    }
    return;
  }
  const int sets = (groups + kFftPrimeSet - 1) / kFftPrimeSet;
  const int per = kFftPrimeItems * (int)blockDim.x / r;  // sets a round
  const FftDiv r_div(r);
  for (int s0 = 0; s0 < sets; s0 += per) {
    const int items = min(per, sets - s0) * r;
#pragma unroll 1
    for (int u = 0; u < kFftPrimeItems; ++u) {
      const int i = threadIdx.x + u * (int)blockDim.x;
      if (i >= items) break;
      const int set = r_div(i), k = i - set * r;
      int off[kFftPrimeSet];
#pragma unroll
      for (int q = 0; q < kFftPrimeSet; ++q)  // past the last group: a copy
        off[q] = offset(min((s0 + set) * kFftPrimeSet + q, groups - 1));
      fft_prime_item<kInv, kFftPrimeSet>(A, off, es, r, k, buf,
                                         acc + u * kFftPrimeSet);
    }
    __syncthreads();
#pragma unroll 1
    for (int u = 0; u < kFftPrimeItems; ++u) {
      const int i = threadIdx.x + u * (int)blockDim.x;
      if (i >= items) break;
      const int set = r_div(i), k = i - set * r;
#pragma unroll
      for (int q = 0; q < kFftPrimeSet; ++q) {
        const int g = (s0 + set) * kFftPrimeSet + q;
        if (g < groups) A[offset(g) + k * es] = acc[u * kFftPrimeSet + q];
      }
    }
    __syncthreads();
  }
}

// fft_pass for the radix r of a plan (kFftLoad / kFftStore only for the
// register radices: the mixer reads and writes global memory in separate
// sweeps otherwise); `buf`: the line buffer of a radix above
// kFftMaxPrime, which only kAny takes (FftPlaneOf).
template <bool kInv, int kIo, class GI = float2, class GO = float2,
          bool kDit = kInv, bool kAny = false>
__device__ __forceinline__ void fft_pass_any(int r, float2* A,
                                             const FftLines& ln, int n,
                                             int L, const float2* tw,
                                             const typename FftSame<GI>::type* gin,
                                             typename FftSame<GO>::type* gout,
                                             float norm, float2* buf) {
  switch (r) {
#define LGTEUN_RADIX(R)                                                     \
  case R:                                                                   \
    fft_pass<R, kInv, kIo, GI, GO, kDit>(A, ln, n, L, tw, gin, gout, norm); \
    break;
    LGTEUN_RADIX(2) LGTEUN_RADIX(4) LGTEUN_RADIX(8) LGTEUN_RADIX(16)
    LGTEUN_RADIX(3) LGTEUN_RADIX(5) LGTEUN_RADIX(7) LGTEUN_RADIX(9)
#undef LGTEUN_RADIX
    default:
      if (kIo != kFftShared) break;
      if constexpr (kAny) {
        if (r > kFftMaxPrime) {
          fft_pass_prime<kInv>(A, ln, n, r, tw, buf);
          break;
        }
      }
      fft_pass_generic<kInv, kDit>(A, ln, n, L, r, tw);
  }
}

// The amp/phase chain on one bin, with the reference's zero-bin
// convention and epsilons; self_conj: one of the four self-conjugate bins
// (exactly real). Each bin is its own item: the chain's atan2f and sincosf
// are most of a plane's instructions, so they are spread over all threads
// evenly.
__device__ __forceinline__ float2 mix_bin(float2 z, bool self_conj, float aw,
                                          float ab, float pw, float pb) {
  const float re = z.x;
  float im = self_conj ? 0.f : z.y;
  im = im + 0.0f;  // -0 -> +0: branch cut at +pi
  const bool zero = (re == 0.0f) && (im == 0.0f);
  float amp = zero ? 0.0f : sqrtf(re * re + im * im);
  float pha = zero ? 0.0f : atan2f(im, re);
  amp = amp * aw + ab;
  pha = pha * pw + pb;
  float sn, cs;
  sincosf(pha, &sn, &cs);
  return make_float2(amp * cs + 1e-8f + 1e-8f, amp * sn + 1e-8f);
}

// One plane's mixer in three parts over ranges of rows or of columns, so
// that one block runs all of it (fft_mixer_plane), a cluster of two
// blocks splits it (fft_mixer_plane_pair), a cluster of K blocks that
// hold it once between them splits it (fft_mixer_plane_cluster) or
// three launches do (the global route, spectral_head.cu). A part begins
// after, and ends before, a point where its caller synchronises. The
// plan stays in the tables (FftMixerPlan). kAny: the plane may have an
// odd width or a radix above kFftMaxPrime (fft_mixer_any); without it the
// body holds only the even rows and the passes up to kFftMaxPrime, so
// that the kernels of those planes, the model's tiles among them, pay
// nothing for the others (their calls, which took registers from every
// pass, are not compiled in).
template <bool kAny>
struct FftPlaneOf {
  // the tables, and shared memory: the plan's copy, then the half
  // spectrum; every value of the plan is read where it is used
  const float* tab;
  const FftMixerPlan* hdr;
  float2* A;   // [H][ld]: W-bins 0..N-1 at fft_pos(row, k), N at N (odd
               // W: bin k at k)
  // the line buffer of a radix above kFftMaxPrime (fft_mixer_gbuf
  // float2), placed by the route after its rows or columns
  float2* buf = nullptr;

  __device__ FftPlaneOf(const float* tables, float2* sm)
      : tab(tables),
        hdr(reinterpret_cast<const FftMixerPlan*>(sm)),
        A(sm + kFftPlanFloats / 2) {}

  // the plan into shared memory (the caller syncs before using it)
  __device__ __forceinline__ void load_plan() const {
    float* dst = reinterpret_cast<float*>(const_cast<FftMixerPlan*>(hdr));
    for (int i = threadIdx.x; i < kFftPlanFloats; i += blockDim.x)
      dst[i] = __ldg(tab + i);
  }
  __device__ __forceinline__ const FftMixerPlan& plan() const { return *hdr; }
  __device__ __forceinline__ int get(const int& field) const { return field; }
  __device__ __forceinline__ const float2* twiddles(const int& offset) const {
    return reinterpret_cast<const float2*>(tab + get(offset));
  }
  __device__ __forceinline__ int width() const { return get(plan().w); }
  __device__ __forceinline__ bool odd() const {
    return kAny && (width() & 1);
  }
  // the half spectrum's columns, W/2 + 1
  __device__ __forceinline__ int cols() const { return width() / 2 + 1; }
  // the first W pass reads, the last writes global memory (even W)
  __device__ __forceinline__ bool fused() const {
    return !odd() && get(plan().row.npass) > 0 &&
           fft_register_radix(get(plan().row.radix[0]));
  }

  // W forward (and split) of nr rows: `in` the first row's W values
  // (their storage type, loads.cuh), into rows [0, nr) at Ar
  template <class TI>
  __device__ __forceinline__ void rows_forward(const TI* in, float2* Ar,
                                               int nr) const {
    if constexpr (kAny) {
      if (odd()) {
        rows_forward_odd(in, Ar, nr);
        return;
      }
    }
    using GI = typename PairOf<TI>::type;
    const int N = get(plan().row.n), ld = get(plan().ld);
    const bool fused = this->fused();
    const float2* tw_row = twiddles(plan().tw_row);
    const GI* inr = reinterpret_cast<const GI*>(in);
    FftLines rows{nr, ld, 1, false};

    // W forward: the N-point FFT of each row read as complex, its first
    // pass reading the plane from global memory (neighbouring threads on
    // neighbouring elements)
    if (!fused) {
      for (int i = threadIdx.x; i < nr * N; i += blockDim.x)
        Ar[i / N * ld + i % N] = load_pair(inr + i);
      __syncthreads();
    }
    for (int i = 0, L = N, passes = get(plan().row.npass); i < passes; ++i) {
      const int r = get(plan().row.radix[i]);
      rows.line_fast = i > 0 && L / r < 16;
      if (i == 0 && fused)
        fft_pass_any<false, kFftLoad, GI, float2, false, kAny>(
            r, Ar, rows, N, L, tw_row, inr, nullptr, 0.f, buf);
      else
        fft_pass_any<false, kFftShared, float2, float2, false, kAny>(
            r, Ar, rows, N, L, tw_row, nullptr, nullptr, 0.f, buf);
      __syncthreads();
      L /= r;
    }

    // split: the half spectrum X[0..N] of each real row, pairs (k, N - k)
    const float2* tw_half = twiddles(plan().tw_half);
    const int* pos = reinterpret_cast<const int*>(twiddles(plan().pos_row));
    const FftDiv rows_div(nr);
#pragma unroll 4
    for (int t = threadIdx.x; t < nr * (N / 2 + 1); t += blockDim.x) {
      const int k = rows_div(t);
      float2* a = Ar + (t - k * nr) * ld;
      if (k == 0) {
        const float2 z = a[0];
        a[0] = make_float2(z.x + z.y, 0.f);
        a[N] = make_float2(z.x - z.y, 0.f);
        continue;
      }
      const int pk = __ldg(pos + k), pm = __ldg(pos + N - k);
      const float2 zk = a[pk], zm = a[pm];
      const float2 e = make_float2((zk.x + zm.x) * 0.5f, (zk.y - zm.y) * 0.5f);
      // o = (zk - conj zm) / 2i
      const float2 o = make_float2((zk.y + zm.y) * 0.5f, (zm.x - zk.x) * 0.5f);
      const float2 wo = cmul(__ldg(tw_half + k), o);
      a[pk] = cadd(e, wo);
      if (pm != pk) a[pm] = cconj(csub(e, wo));
    }
  }

  // odd W: each row as W complex points (imaginary part 0) loaded into
  // their digit-reversed positions, the W-point forward passes in
  // decimation in time, bins in natural order (0..(W-1)/2 are kept); a
  // call of its own, so that the even rows' registers do not pay for it
  template <class TI>
  __device__ __noinline__ void rows_forward_odd(const TI* in, float2* Ar,
                                                int nr) const {
    const int n = get(plan().row.n), ld = get(plan().ld);
    const float2* tw_row = twiddles(plan().tw_row);
    const int* pos = reinterpret_cast<const int*>(twiddles(plan().pos_row));
    FftLines rows{nr, ld, 1, false};
    const FftDiv n_div(n);
#pragma unroll 4
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
      const int r = n_div(i);
      Ar[r * ld + __ldg(pos + i - r * n)] =
          make_float2(load_act<true>(in + i), 0.f);
    }
    __syncthreads();
    for (int i = get(plan().row.npass) - 1, L = 1; i >= 0; --i) {
      const int r = get(plan().row.radix[i]);
      L *= r;
      rows.line_fast = i > 0 && L / r < 16;
      fft_pass_any<false, kFftShared, float2, float2, true, kAny>(
          r, Ar, rows, n, L, tw_row, nullptr, nullptr, 0.f, buf);
      __syncthreads();
    }
  }

  // H forward, amp/phase and H inverse of columns [c0, c0 + nc)
  __device__ __forceinline__ void columns(int c0, int nc, float aw, float ab,
                                          float pw, float pb) const {
    columns_in(A + c0, 1, get(plan().ld), c0, nc, aw, ab, pw, pb);
  }

  // The same on columns held at Ac: position q of column c0 + c at Ac[c *
  // lstride + q * es] (the half spectrum itself, or a range of its
  // columns staged by the cluster route: lstride 1, es the row pitch; or
  // staged column by column by the global route: lstride the column
  // pitch, es 1)
  __device__ __forceinline__ void columns_in(float2* Ac, int lstride, int es,
                                             int c0, int nc, float aw,
                                             float ab, float pw,
                                             float pb) const {
    const int H = get(plan().col.n);
    const int passes = get(plan().col.npass);
    const float2* tw_col = twiddles(plan().tw_col);
    FftLines cols{nc, lstride, es, true};

    // H forward on the columns
    int L = H;
    for (int i = 0; i < passes; ++i) {
      const int r = get(plan().col.radix[i]);
      cols.line_fast = es != 1 || L / r < 16;
      fft_pass_any<false, kFftShared, float2, float2, false, kAny>(
          r, Ac, cols, H, L, tw_col, nullptr, nullptr, 0.f, buf);
      __syncthreads();
      L /= r;
    }

    // amp/phase, one bin a thread; W-bins 0 and W/2 (even W: column N)
    // and H-bins 0 and H/2 (position qh; -1 for odd H) are the
    // self-conjugate ones
    const FftDiv cols_div(nc);
    const int qh = get(plan().qh);
    const int wh = odd() ? -1 : get(plan().row.n);
#pragma unroll 4
    for (int t = threadIdx.x; t < H * nc; t += blockDim.x) {
      const int q = cols_div(t), c = t - q * nc;
      float2* z = Ac + c * lstride + q * es;
      const bool edge = c0 + c == 0 || c0 + c == wh;
      *z = mix_bin(*z, edge && (q == 0 || q == qh), aw, ab, pw, pb);
    }
    __syncthreads();

    // H inverse: the passes transposed, in reverse order
    for (int i = passes - 1; i >= 0; --i) {
      const int r = get(plan().col.radix[i]);
      L *= r;
      cols.line_fast = es != 1 || L / r < 16;
      fft_pass_any<true, kFftShared, float2, float2, true, kAny>(
          r, Ac, cols, H, L, tw_col, nullptr, nullptr, 0.f, buf);
      if (i > 0) __syncthreads();
    }
  }

  // c2r, W inverse and |.| / (H W) of rows [0, nr) at Ar into `out`, the
  // first row's W values (their storage type, rounded once as stored)
  template <class TO>
  __device__ __forceinline__ void rows_inverse(TO* out, float2* Ar,
                                               int nr) const {
    if constexpr (kAny) {
      if (odd()) {
        rows_inverse_odd(out, Ar, nr);
        return;
      }
    }
    using GO = typename PairOf<TO>::type;
    const int N = get(plan().row.n), ld = get(plan().ld);
    GO* outr = reinterpret_cast<GO*>(out);
    FftLines rows{nr, ld, 1, false};
    const float2* tw_half = twiddles(plan().tw_half);
    const int* pos = reinterpret_cast<const int*>(twiddles(plan().pos_row));

    // c2r: Z'[k] = (X[k] + conj X[N-k]) + i conj(w_W^k) (X[k] - conj
    // X[N-k]) with the imaginary parts of X[0] and X[N] dropped
    const FftDiv rows_div(nr);
#pragma unroll 4
    for (int t = threadIdx.x; t < nr * (N / 2 + 1); t += blockDim.x) {
      const int k = rows_div(t);
      float2* a = Ar + (t - k * nr) * ld;
      if (k == 0) {
        const float x0 = a[0].x, xn = a[N].x;
        a[0] = make_float2(x0 + xn, x0 - xn);
        continue;
      }
      const int pk = __ldg(pos + k), pm = __ldg(pos + N - k);
      const float2 xk = a[pk], xm = a[pm];
      const float2 e = make_float2(xk.x + xm.x, xk.y - xm.y);
      const float2 o = cmulc(make_float2(xk.x - xm.x, xk.y + xm.y),
                             __ldg(tw_half + k));
      a[pk] = make_float2(e.x - o.y, e.y + o.x);
      if (pm != pk) a[pm] = make_float2(e.x + o.y, o.x - e.y);
    }
    __syncthreads();

    // W inverse: the row passes transposed, in reverse order; the last one
    // writes x[2n], x[2n+1] = |Re|, |Im| z'[n] / (H W) to global memory
    const float norm = 1.0f / (float)(get(plan().col.n) * 2 * N);
    const bool fused = this->fused();
    const float2* tw_row = twiddles(plan().tw_row);
    for (int i = get(plan().row.npass) - 1, L = 1; i >= 0; --i) {
      const int r = get(plan().row.radix[i]);
      L *= r;
      rows.line_fast = i > 0 && L / r < 16;
      if (i == 0 && fused) {
        fft_pass_any<true, kFftStore, float2, GO, true, kAny>(
            r, Ar, rows, N, L, tw_row, nullptr, outr, norm, buf);
      } else {
        fft_pass_any<true, kFftShared, float2, float2, true, kAny>(
            r, Ar, rows, N, L, tw_row, nullptr, nullptr, 0.f, buf);
        __syncthreads();
      }
    }
    if (!fused)
      for (int i = threadIdx.x; i < nr * N; i += blockDim.x) {
        const float2 z = Ar[i / N * ld + i % N];
        store_pair(outr + i, make_float2(fabsf(z.x * norm), fabsf(z.y * norm)));
      }
  }

  // odd W: the half spectrum extended by X[W-k] = conj X[k] (columns
  // (W+1)/2..W-1) with the imaginary part of X[0] dropped, the W-point
  // inverse passes in decimation in frequency (natural order in,
  // digit-reversed out), x[t] = |Re z'[pos(t)]| / (H W); a call of its
  // own as rows_forward_odd
  template <class TO>
  __device__ __noinline__ void rows_inverse_odd(TO* out, float2* Ar,
                                                int nr) const {
    const int n = get(plan().row.n), ld = get(plan().ld), half = cols();
    const float2* tw_row = twiddles(plan().tw_row);
    const int* pos = reinterpret_cast<const int*>(twiddles(plan().pos_row));
    FftLines rows{nr, ld, 1, false};
    const FftDiv half_div(half);
#pragma unroll 4
    for (int t = threadIdx.x; t < nr * half; t += blockDim.x) {
      const int r = half_div(t), k = t - r * half;
      float2* a = Ar + r * ld;
      if (k == 0)
        a[0].y = 0.f;
      else
        a[n - k] = cconj(a[k]);
    }
    __syncthreads();
    for (int i = 0, L = n, passes = get(plan().row.npass); i < passes; ++i) {
      const int r = get(plan().row.radix[i]);
      rows.line_fast = i > 0 && L / r < 16;
      fft_pass_any<true, kFftShared, float2, float2, false, kAny>(
          r, Ar, rows, n, L, tw_row, nullptr, nullptr, 0.f, buf);
      __syncthreads();
      L /= r;
    }
    const float norm = 1.0f / (float)(get(plan().col.n) * n);
    const FftDiv n_div(n);
#pragma unroll 4
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
      const int r = n_div(i);
      store_act(out + i,
                fabsf(Ar[r * ld + __ldg(pos + i - r * n)].x * norm));
    }
  }
};

// out = global mixer of the plane `in` (both [H, W] of their storage
// types, loads.cuh, aligned to a pair; they may alias, and `in` may have
// been written earlier in the same launch: it is read through L2), with
// the channel's affine (aw, ab) on the amplitude and (pw, pb) on the
// phase. `sm` holds fft_mixer_smem(H, W) bytes; `tab` the tables of
// fft_tables_kernel for (H, W).
template <class TI, class TO, bool kAny = false>
__device__ __forceinline__ void fft_mixer_plane(const TI* in, TO* out,
                                                float2* sm, const float* tab,
                                                float aw, float ab, float pw,
                                                float pb) {
  FftPlaneOf<kAny> plane(tab, sm);
  plane.load_plan();
  __syncthreads();
  const int H = plane.get(plane.plan().col.n);
  plane.buf = plane.A + H * plane.get(plane.plan().ld);
  plane.rows_forward(in, plane.A, H);
  __syncthreads();
  plane.columns(0, plane.cols(), aw, ab, pw, pb);
  __syncthreads();
  plane.rows_inverse(out, plane.A, H);
}

// The same on a cluster of two blocks, each with its own copy of the
// half spectrum in `sm`: block `rank` takes rows [0, (H + 1) / 2) or the
// rest, and the first or the second half of the columns, and after each
// part hands the other block the values it will read (its columns of my
// rows, then its rows of my columns) through distributed shared memory.
template <class TI, class TO, bool kAny = false>
__device__ __forceinline__ void fft_mixer_plane_pair(
    const TI* in, TO* out, float2* sm, const float* tab, float aw,
    float ab, float pw, float pb) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  FftPlaneOf<kAny> plane(tab, sm);
  plane.load_plan();
  cluster.sync();  // the other block runs: its shared memory may be written
  const int H = plane.get(plane.plan().col.n), W = plane.width();
  const int ld = plane.get(plane.plan().ld), half = plane.cols();
  const int h0 = (H + 1) / 2, r0 = rank ? h0 : 0, nr = rank ? H - h0 : h0;
  const int hc = (half + 1) / 2, c0 = rank ? hc : 0;
  const int nc = rank ? half - hc : hc;
  float2* A = plane.A;
  plane.buf = A + H * ld;
  float2* peer = cluster.map_shared_rank(A, rank ^ 1);
  plane.rows_forward(in + (size_t)r0 * W, A + r0 * ld, nr);
  __syncthreads();
  // my rows of the other block's columns
  const int pc0 = rank ? 0 : hc, pnc = half - nc;
  const FftDiv pnc_div(pnc);
  for (int t = threadIdx.x; t < nr * pnc; t += blockDim.x) {
    const int r = pnc_div(t), i = (r0 + r) * ld + pc0 + t - r * pnc;
    peer[i] = A[i];
  }
  cluster.sync();
  plane.columns(c0, nc, aw, ab, pw, pb);
  __syncthreads();
  // my columns of the other block's rows
  const int pr0 = rank ? 0 : h0, pnr = H - nr;
  const FftDiv nc_div(nc);
  for (int t = threadIdx.x; t < pnr * nc; t += blockDim.x) {
    const int r = nc_div(t), i = (pr0 + r) * ld + c0 + t - r * nc;
    peer[i] = A[i];
  }
  cluster.sync();
  plane.rows_inverse(out + (size_t)r0 * W, A + r0 * ld, nr);
}

// The plane on a cluster of blocks that together hold its half
// spectrum once (fft_cluster_plan: `rows`, `cols`, `chunk`, `pitch`):
// block `rank` keeps rows [rank rows, (rank + 1) rows) at the head of its
// half spectrum (`sm`: the plan, the rows, a stage of H x pitch, the line
// buffer). It runs the W forward and split of its rows; after the
// cluster syncs, its columns [rank cols, (rank + 1) cols) `chunk` at a
// time: gathered from every block's rows through distributed shared
// memory into the stage, the H forward, amp/phase and H inverse there,
// scattered back (each block reads and writes only its own columns of
// the others' rows); after the cluster syncs again, the c2r and W inverse
// of its rows. `in` and `out` may alias: a block writes only its own
// rows of `out`, after every block has read its rows of `in`.
template <class TI, class TO, bool kAny = false>
__device__ __forceinline__ void fft_mixer_plane_cluster(
    const TI* in, TO* out, float2* sm, const float* tab, int rows, int cols,
    int chunk, int pitch, float aw, float ab, float pw, float pb) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  FftPlaneOf<kAny> plane(tab, sm);
  const int rank = (int)cluster.block_rank();
  plane.load_plan();
  __syncthreads();
  const int H = plane.get(plane.plan().col.n), W = plane.width();
  const int ld = plane.get(plane.plan().ld), half = plane.cols();
  const int r0 = min(rank * rows, H), nr = min(rows, H - r0);
  float2* stage = plane.A + rows * ld;
  plane.buf = stage + H * pitch;
  plane.rows_forward(in + (size_t)r0 * W, plane.A, nr);
  const int c_end = min((rank + 1) * cols, half);
  const FftDiv rows_div(rows);
  cluster.sync();  // every block's rows are in its shared memory
  for (int c0 = rank * cols; c0 < c_end; c0 += chunk) {
    const int nc = min(chunk, c_end - c0);
    const FftDiv nc_div(nc);
    // row q of the stage is row q - j rows of block j = q / rows; the
    // remote loads of a thread are independent, so unrolled they overlap
#pragma unroll 4
    for (int t = threadIdx.x; t < H * nc; t += blockDim.x) {
      const int q = nc_div(t), c = t - q * nc, j = rows_div(q);
      stage[q * pitch + c] =
          cluster.map_shared_rank(plane.A, j)[(q - j * rows) * ld + c0 + c];
    }
    __syncthreads();
    plane.columns_in(stage, 1, pitch, c0, nc, aw, ab, pw, pb);
    __syncthreads();
#pragma unroll 4
    for (int t = threadIdx.x; t < H * nc; t += blockDim.x) {
      const int q = nc_div(t), c = t - q * nc, j = rows_div(q);
      cluster.map_shared_rank(plane.A, j)[(q - j * rows) * ld + c0 + c] =
          stage[q * pitch + c];
    }
    __syncthreads();  // the stage is read before the next chunk fills it
  }
  cluster.sync();  // every block's columns are back in their rows
  plane.rows_inverse(out + (size_t)r0 * W, plane.A, nr);
}

// y1 = LN(x)[:C/2], y2 = LN(x)[C/2:] at the kP pixels p + k stride of
// image b (k < kP; those at or past `end` computed on a pixel inside and
// not stored; [B, C, H*W] in, [B, C/2, H*W] out). x and y1 in their
// storage types (loads.cuh), y2 float: the mixer takes the LN's float
// value, whatever y1 is stored as. Each pixel's arithmetic
// is the same for any kP; the kP loads of a channel are independent, so
// their latencies overlap (kP = 4 in lgb_block.cu's LN items, on one
// 512-thread block an SM).
template <int kP, class TX, class TY>
__device__ __forceinline__ void ln_split_pixels(
    const TX* x, const float* ln_w, const float* ln_b, TY* y1,
    float* y2, int C, int HW, int b, int p, int stride, int end, float eps) {
  const TX* xb = x + (size_t)b * C * HW;
  int q[kP];
  float mu[kP], var[kP], r[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    q[k] = min(p + k * stride, end - 1);
    mu[k] = var[k] = 0.f;
  }
  for (int c = 0; c < C; ++c) {
    float v[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) v[k] = load_plain(xb + (size_t)c * HW + q[k]);
#pragma unroll
    for (int k = 0; k < kP; ++k) mu[k] += v[k];
  }
#pragma unroll
  for (int k = 0; k < kP; ++k) mu[k] /= (float)C;
  for (int c = 0; c < C; ++c) {
    float v[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) v[k] = load_plain(xb + (size_t)c * HW + q[k]);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const float d = v[k] - mu[k];
      var[k] += d * d;
    }
  }
#pragma unroll
  for (int k = 0; k < kP; ++k) r[k] = rsqrtf(var[k] / (float)C + eps);
  const int C2 = C / 2;
  for (int c = 0; c < C; ++c) {
    float v[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) v[k] = load_plain(xb + (size_t)c * HW + q[k]);
    TY* o1 = y1 + ((size_t)b * C2 + c) * HW;
    float* o2 = y2 + ((size_t)b * C2 + (c - C2)) * HW;
    const float w = ln_w[c], bias = ln_b[c];
#pragma unroll
    for (int k = 0; k < kP; ++k)
      if (p + k * stride < end) {
        const float y = (v[k] - mu[k]) * r[k] * w + bias;
        if (c < C2)
          store_act(o1 + q[k], y);
        else
          o2[q[k]] = y;
      }
  }
}

}  // namespace
