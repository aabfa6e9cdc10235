"""The arithmetic of the FFT mixer's half-spectrum body, on the CPU.

The kernel (`csrc/fft_mixer.cuh::fft_mixer_plane`, B1 / B4 / B8's
planes) reads each real row of W values as N = W/2 complex points, runs
mixed-radix passes in registers (decimation in frequency forward,
digit-reversed order out; the transposed passes inverse), splits the
rows into the half spectrum X[0..N], transforms its N + 1 columns along
H, mixes amplitude and phase, and goes back with a c2r of the same half
length. These tests emulate those passes in torch, in float64 and in
float32, with the kernel's own plan (`fft_plan`, `fft_mixer_plan`), index
maps, twiddle indices and butterfly formulas, and hold each stage
against `torch.fft` and the whole against `global_mixer_ref` at every
length class the wrapper takes (powers of two; odd parts 3, 5, 7, 9, 21;
a non-square plane; odd primes above 9 on the generic pass). On float32
planes constant along H or along W they assert that the bins which are
zero in exact arithmetic are exactly zero, that the split's
self-conjugate bins are exactly real and that -0 and +0 give the same
phase. The card runs the same plan (`chip_smoke.py` holds its tables to
`fft_tables_ref`) and is held to the plain version there.
"""

import math

import numpy as np
import pytest
import torch

from lgteun_tpu_torch.ops.spectral_kernel import (FFT_MAX_PASS,
                                                  FFT_MAX_PRIME,
                                                  FFT_PLAN_FLOATS,
                                                  FFT_SMEM_BYTES,
                                                  _check_plane,
                                                  fft_mixer_plan, fft_plan,
                                                  fft_pos, fft_tables_ref,
                                                  global_mixer_ref)

# (H, W): the lengths the scene engine and the blocks use, and 22 x 26
# (radix 11 and 13: the generic pass)
SIZES = [(8, 8), (48, 48), (64, 64), (72, 72), (80, 80), (128, 128),
         (144, 144), (168, 168), (40, 56), (22, 26)]
REGISTER_RADICES = (2, 4, 8, 16, 3, 5, 7, 9)
PARAMS = (0.9, 0.05, 1.3, 0.1)  # amp_w, amp_b, pha_w, pha_b


# complex values as [..., 2] (re, im), with the kernel's formulas
def cmul(a, b):
    return torch.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                        a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], -1)


def cmulc(a, b):
    """a * conj(b)"""
    return torch.stack([a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1],
                        a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]], -1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], -1)


def _twiddles(count, length, dtype):
    """exp(-2 pi i j / length) for j < count, exact zeros snapped."""
    ang = 2.0 * np.arange(count, dtype=np.longdouble) / length
    c = np.cos(np.pi * ang).astype(np.float64)
    s = -np.sin(np.pi * ang).astype(np.float64)
    c[np.abs(c) < 1e-12], s[np.abs(s) < 1e-12] = 0.0, 0.0
    return torch.from_numpy(np.stack([c, s], 1)).to(dtype)


def _tables(h, w, dtype):
    """(row, half, column twiddles, row positions): in float32 the
    kernel's tables (`fft_tables_ref`), in float64 the same in float64
    (odd W: the row twiddles of W points, no half twiddles)."""
    plan = fft_mixer_plan(h, w)
    n = w if w % 2 else w // 2
    half = 0 if w % 2 else n + 1
    if dtype == torch.float32:
        tab = fft_tables_ref(h, w)
        part = lambda off, cnt: tab[off:off + 2 * cnt].view(cnt, 2)
        tw = (part(plan["tw_row"], n), part(plan["tw_half"], half),
              part(plan["tw_col"], h))
    else:
        tw = (_twiddles(n, n, dtype), _twiddles(half, w, dtype),
              _twiddles(h, h, dtype))
    pos = torch.tensor([fft_pos(plan["row"], n, k) for k in range(n)])
    return tw + (pos,)


def _root16(e, dtype):
    """w_16^e as the kernel's float constants (e = 4: -i, exact)."""
    return _twiddles(16, 16, torch.float64)[e].to(dtype)


def _mul_root16(z, e):
    if e == 0:
        return z
    if e == 4:
        return torch.stack([z[..., 1], -z[..., 0]], -1)
    return cmul(z, _root16(e, z.dtype))


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def dft_pow2(v):
    """dft_pow2<R>: radix-2 DIF stages in registers on v [..., R, 2],
    then the bit reversal as a renaming."""
    r = v.shape[-2]
    x = list(v.unbind(-2))
    half = r // 2
    while half:
        for i in range(r):
            if i & half:
                continue
            u, w = x[i], x[i + half]
            x[i] = u + w
            x[i + half] = _mul_root16(u - w, (i & (half - 1)) * (8 // half))
        half //= 2
    bits = r.bit_length() - 1
    return torch.stack([x[_bitrev(i, bits)] for i in range(r)], -2)


def dft_odd(v, roots):
    """dft_odd<R>: the symmetric form on differences, roots[e - 1] =
    w_R^e for e <= (R - 1) / 2."""
    r = v.shape[-2]
    q = (r - 1) // 2
    x = v.unbind(-2)
    y0 = x[0]
    for t in range(1, r):
        y0 = y0 + x[t]
    a = [(x[t] - x[0]) + (x[r - t] - x[0]) for t in range(1, q + 1)]
    b = [(x[t] - x[0]) - (x[r - t] - x[0]) for t in range(1, q + 1)]
    out = [y0] + [None] * (r - 1)
    for k in range(1, q + 1):
        acc_a = torch.zeros_like(y0)
        acc_b = torch.zeros_like(y0)
        for t in range(1, q + 1):
            e = t * k % r
            if e == 0:
                c, s = 1.0, 0.0
            elif e <= q:
                c, s = roots[e - 1][0], -roots[e - 1][1]
            else:
                c, s = roots[r - e - 1][0], roots[r - e - 1][1]
            acc_a = acc_a + a[t - 1] * c
            acc_b = acc_b + b[t - 1] * s
        out[k] = torch.stack([acc_a[..., 0] + acc_b[..., 1],
                              acc_a[..., 1] - acc_b[..., 0]], -1)
        out[r - k] = torch.stack([acc_a[..., 0] - acc_b[..., 1],
                                  acc_a[..., 1] + acc_b[..., 0]], -1)
    return torch.stack(out, -2)


def dft(v, roots):
    r = v.shape[-2]
    return dft_pow2(v) if r & (r - 1) == 0 else dft_odd(v, roots)


def idft(v, roots):
    return conj(dft(conj(v), roots))


def fft_pass(a, n, span, r, tw, inverse, dit=None):
    """One pass of radix r over span `span` of the lines a [lines, n, 2]:
    group (b, j) holds elements b span + j + s t (s = span / r); the
    twiddles w_span^(jk) = tw[j k n / span] for j, k >= 1 (conjugate
    inverse) after the DFT in decimation in frequency (`dit` False; the
    default forward) or before it in decimation in time (`dit` True; the
    default inverse); inverse the inverse DFT. Radices above 9 take
    fft_pass_generic's formulas (one output at a time; fft_pass_prime, on
    a radix above 512, computes the same terms in the same order)."""
    dit = inverse if dit is None else dit
    s = span // r
    b = torch.arange(n // span)[:, None, None]
    j = torch.arange(s)[None, :, None]
    k = torch.arange(r)[None, None, :]
    idx = b * span + j + s * k
    v = a[:, idx]
    twv = tw[j * k * (n // span)]
    roots = [tw[e * (n // r)] for e in range(1, (r - 1) // 2 + 1)]
    if r in REGISTER_RADICES:
        mask = ((j >= 1) & (k >= 1))[..., None]
        turn = cmulc if inverse else cmul
        if dit:
            v = torch.where(mask, turn(v, twv), v)
        v = idft(v, roots) if inverse else dft(v, roots)
        if not dit:
            v = torch.where(mask, turn(v, twv), v)
    else:
        v = _generic_pass(v, tw, n, r, twv, inverse, dit, (j >= 1)[..., None])
    out = a.clone()
    out[:, idx] = v
    return out


def _generic_pass(v, tw, n, r, twv, inverse, dit, jmask):
    """fft_pass_generic (fft_generic_output) on the groups v [lines, nb,
    s, r, 2], every output at once, the terms in the kernel's order;
    jmask: j >= 1 [1, s, 1, 1]."""
    rs = n // r
    ks = torch.arange(r)
    if dit:   # x'_t = w_L^(jt) x_t (forward where j >= 1; inverse always)
        v = cmulc(v, twv) if inverse else torch.where(jmask, cmul(v, twv), v)
    acc = torch.zeros_like(v)
    if inverse:
        for t in range(r):
            acc = acc + cmulc(v[..., t:t + 1, :], tw[t * ks % r * rs])
        return acc if dit else torch.where(jmask, cmulc(acc, twv), acc)
    for t in range(1, r):
        acc = acc + cmul(v[..., t:t + 1, :] - v[..., :1, :],
                         tw[t * ks % r * rs])
    if not dit:
        acc = cmul(acc, twv)
    acc0 = torch.zeros_like(v[..., 0, :])
    for t in range(r):
        acc0 = acc0 + v[..., t, :]
    acc[..., 0, :] = acc0
    return acc


def mix_bin(z, self_conj, prm):
    """fft_mixer.cuh::mix_bin on z [..., 2]."""
    aw, ab, pw, pb = prm
    re = z[..., 0]
    im = torch.where(self_conj, torch.zeros_like(re), z[..., 1]) + 0.0
    zero = (re == 0) & (im == 0)
    amp = torch.where(zero, torch.zeros_like(re), torch.sqrt(re * re + im * im))
    pha = torch.where(zero, torch.zeros_like(re), torch.atan2(im, re))
    amp = amp * aw + ab
    pha = pha * pw + pb
    return torch.stack([amp * torch.cos(pha) + 1e-8 + 1e-8,
                        amp * torch.sin(pha) + 1e-8], -1)


def split(z, tw_half, pos):
    """The half spectrum [h, n + 1, 2] of the forward rows z [h, n, 2]
    (Z[k] at position pos[k]), in the kernel's layout: X[k] at column
    pos[k], X[n] at column n; X[0], X[n] exactly real."""
    h, n = z.shape[:2]
    out = torch.zeros(h, n + 1, 2, dtype=z.dtype)
    out[:, :n] = z
    k = torch.arange(1, n // 2 + 1)
    pk, pm = pos[k], pos[n - k]
    zk, zm = z[:, pk], z[:, pm]
    e = torch.stack([(zk[..., 0] + zm[..., 0]) * 0.5,
                     (zk[..., 1] - zm[..., 1]) * 0.5], -1)
    o = torch.stack([(zk[..., 1] + zm[..., 1]) * 0.5,
                     (zm[..., 0] - zk[..., 0]) * 0.5], -1)
    wo = cmul(tw_half[k], o)
    out[:, pm] = conj(e - wo)
    out[:, pk] = e + wo     # k = n - k: the kernel writes this one only
    z0 = z[:, 0]
    zero = torch.zeros_like(z0[:, 0])
    out[:, 0] = torch.stack([z0[:, 0] + z0[:, 1], zero], -1)
    out[:, n] = torch.stack([z0[:, 0] - z0[:, 1], zero], -1)
    return out


def combine(x, tw_half, pos):
    """The c2r's input [h, n, 2] (Z'[k] at position pos[k]) from the half
    spectrum x [h, n + 1, 2] in the kernel's layout; the imaginary parts
    of X[0] and X[n] are dropped."""
    n = x.shape[1] - 1
    out = x[:, :n].clone()
    k = torch.arange(1, n // 2 + 1)
    pk, pm = pos[k], pos[n - k]
    xk, xm = x[:, pk], x[:, pm]
    e = torch.stack([xk[..., 0] + xm[..., 0], xk[..., 1] - xm[..., 1]], -1)
    o = cmulc(torch.stack([xk[..., 0] - xm[..., 0],
                           xk[..., 1] + xm[..., 1]], -1), tw_half[k])
    out[:, pm] = torch.stack([e[..., 0] + o[..., 1], o[..., 0] - e[..., 1]],
                             -1)
    out[:, pk] = torch.stack([e[..., 0] - o[..., 1], e[..., 1] + o[..., 0]],
                             -1)
    x0, xn = x[:, 0, 0], x[:, n, 0]
    out[:, 0] = torch.stack([x0 + xn, x0 - xn], -1)
    return out


def rows_inverse(z, plan, tw_row):
    """The W inverse passes (transposed, in reverse order) on z [h, n, 2]
    in position order -> natural order."""
    n, span = z.shape[1], 1
    for r in reversed(plan["row"]):
        span *= r
        z = fft_pass(z, n, span, r, tw_row, True)
    return z


def rows_forward(x, plan, tw_row, tw_half, pos):
    """The W forward of the rows x [h, W] -> (the row transform [h, n,
    2], the half spectrum [h, W/2 + 1, 2] in the kernel's layout). Even
    W: the rows as n = W/2 complex points, the passes in frequency, the
    split. Odd W: each row as W complex points (imaginary part 0) put at
    their digit-reversed positions pos, the passes in time in reverse
    order (natural order out), bins 0..(W-1)/2 kept."""
    h, w = x.shape
    if w % 2 == 0:
        n, span = w // 2, w // 2
        z = x.reshape(h, n, 2)
        for r in plan["row"]:
            z = fft_pass(z, n, span, r, tw_row, False)
            span //= r
        return z, split(z, tw_half, pos)
    z = torch.zeros(h, w, 2, dtype=x.dtype)
    z[:, pos, 0] = x
    span = 1
    for r in reversed(plan["row"]):
        span *= r
        z = fft_pass(z, w, span, r, tw_row, False, dit=True)
    return z, z[:, :w // 2 + 1].clone()


def rows_back(half, plan, tw_row, tw_half, pos, norm):
    """The W inverse of the half spectrum rows [h, W/2 + 1, 2] -> |x| *
    norm [h, W]. Even W: the c2r combination and the inverse passes. Odd
    W: the hermitian extension X[W-k] = conj X[k] with Im X[0] dropped,
    the inverse passes in frequency (digit-reversed out), x[t] = Re
    z'[pos[t]]."""
    h, m = half.shape[:2]
    w = plan["w"]
    if w % 2 == 0:
        z = rows_inverse(combine(half, tw_half, pos), plan, tw_row)
        return (z * norm).abs().reshape(h, w)
    z = torch.empty(h, w, 2, dtype=half.dtype)
    z[:, :m] = half
    z[:, 0, 1] = 0
    z[:, m:] = conj(half[:, 1:]).flip(1)
    span = w
    for r in plan["row"]:
        z = fft_pass(z, w, span, r, tw_row, True, dit=False)
        span //= r
    return (z[:, pos, 0] * norm).abs()


def edge_bins(plan, h, c0, nc):
    """The self-conjugate bins of columns [c0, c0 + nc) [nc, h]: W-bins 0
    and W/2 (even W: column n) times H-bins 0 and H/2 (position qh; none
    for odd H), as the plain version's `amp_phase` sets them real."""
    w = plan["w"]
    q = torch.arange(h).view(1, h)
    c = torch.arange(c0, c0 + nc).view(nc, 1)
    wh = -1 if w % 2 else w // 2
    return ((c == 0) | (c == wh)) & ((q == 0) | (q == plan["qh"]))


def emulate(x, prm=PARAMS):
    """The kernel's mixer on one plane x [H, W] (float32 or float64),
    stage by stage: rows (forward, position order; odd W natural order),
    half (the half spectrum), spec (after the H forward passes, column
    layout [W/2 + 1, H] in position order), out."""
    h, w = x.shape
    dtype = x.dtype
    plan = fft_mixer_plan(h, w)
    tw_row, tw_half, tw_col, pos = _tables(h, w, dtype)
    st = {}
    st["rows"], st["half"] = rows_forward(x, plan, tw_row, tw_half, pos)
    cols, span = st["half"].transpose(0, 1), h
    for r in plan["col"]:
        cols = fft_pass(cols, h, span, r, tw_col, False)
        span //= r
    st["spec"] = cols
    cols = mix_bin(cols, edge_bins(plan, h, 0, w // 2 + 1), prm)
    for r in reversed(plan["col"]):
        span *= r
        cols = fft_pass(cols, h, span, r, tw_col, True)
    norm = torch.tensor(1.0 / (h * w), dtype=dtype)
    st["out"] = rows_back(cols.transpose(0, 1), plan, tw_row, tw_half, pos,
                          norm)
    return st


def _positions(radices, n):
    return torch.tensor([fft_pos(radices, n, k) for k in range(n)])


def _complex(t):
    return torch.complex(t[..., 0], t[..., 1])


def _rel(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return float((got - want).abs().max() / want.abs().max())


def _plane(h, w, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((h, w))).to(dtype)


@pytest.mark.parametrize("n,radices", [
    (1, []), (4, [4]), (24, [8, 3]), (32, [8, 4]), (36, [4, 9]),
    (40, [8, 5]), (64, [8, 8]), (72, [8, 9]), (84, [4, 3, 7]),
    (128, [16, 8]), (144, [16, 9]), (168, [8, 3, 7]), (26, [2, 13]),
    (8192, [16, 8, 8, 8]), (250, [2, 5, 5, 5]), (45, [9, 5])])
def test_radix_plan(n, radices):
    """The plan of each length class: the power of two in passes of 8 or
    16 first (a row's first pass, which reads global memory, is then a
    register radix), the odd part as 9, 3, 5, 7 and its other primes; the
    radices multiply to n, and fft_pos is a permutation."""
    assert fft_plan(n) == radices
    assert math.prod(radices) == n and len(radices) <= FFT_MAX_PASS
    assert sorted(_positions(radices, n).tolist()) == list(range(n))


@pytest.mark.parametrize("h,w", SIZES)
def test_plane_plan(h, w):
    """The plane's plan: rows of N = W/2 points, columns of H points, an
    odd row pitch, the position of H-bin H/2, shared memory 112 + 8 H ld
    (the plan's copy, then the half spectrum), and
    tables of 28 + 5 N + 2 H + 2 floats laid out as `fft_tables_ref`
    fills them: the plan first (the device code reads it from there), as
    the struct FftMixerPlan lays it out."""
    p, n = fft_mixer_plan(h, w), w // 2
    assert p["row"] == fft_plan(n) and p["col"] == fft_plan(h)
    assert p["ld"] % 2 == 1
    assert p["ld"] in (n + 1, n + 2)
    assert p["smem"] == 4 * FFT_PLAN_FLOATS + 8 * h * p["ld"]
    assert p["qh"] == _positions(p["col"], h)[h // 2]
    tab = fft_tables_ref(h, w)
    assert tab.numel() == p["floats"] == FFT_PLAN_FLOATS + 5 * n + 2 * h + 2
    head = tab[:FFT_PLAN_FLOATS].view(torch.int32).tolist()
    pad = lambda r: r + [0] * (FFT_MAX_PASS - len(r))
    assert head[:10] == [n, len(p["row"])] + pad(p["row"])
    assert head[10:20] == [h, len(p["col"])] + pad(p["col"])
    assert head[20:27] == [p[k] for k in ("ld", "qh", "tw_row", "tw_half",
                                          "tw_col", "pos_row", "floats")]
    tw_row, tw_half, tw_col, pos = _tables(h, w, torch.float32)
    assert torch.equal(tab[p["pos_row"]:].view(torch.int32), pos.int())
    for got, (cnt, length) in ((tw_row, (n, n)), (tw_half, (n + 1, w)),
                               (tw_col, (h, h))):
        want = _twiddles(cnt, length, torch.float64)
        assert float((got.double() - want).abs().max()) <= 6e-8
        assert torch.equal(got == 0, want == 0)


@pytest.mark.parametrize("h,w", SIZES)
def test_forward_stages_match_torch_fft(h, w):
    """float64: the row passes leave Z[k] = fft(z)[k] at position
    fft_pos(k); the split gives rfft(x) (bins 0 and W/2 exactly real);
    the column passes give rfft2(x) with H-bin k at fft_pos(col, k)."""
    x = _plane(h, w)
    st = emulate(x)
    p, n = fft_mixer_plan(h, w), w // 2
    pos = _positions(p["row"], n)
    want_z = torch.fft.fft(_complex(x.reshape(h, n, 2)), dim=1)
    assert _rel(_complex(st["rows"][:, pos]), want_z) <= 1e-13
    cols = torch.cat([pos, torch.tensor([n])])
    want_x = torch.fft.rfft(x, dim=1)
    assert _rel(_complex(st["half"][:, cols]), want_x) <= 1e-13
    assert torch.all(st["half"][:, [0, n], 1] == 0)
    posh = _positions(p["col"], h)
    got = _complex(st["spec"][cols][:, posh]).transpose(0, 1)
    assert _rel(got, torch.fft.rfft2(x)) <= 1e-13


@pytest.mark.parametrize("h,w", SIZES)
def test_emulated_mixer_matches_plain(h, w):
    """The whole emulated body against global_mixer_ref: float64 within
    1e-12 of the largest output, float32 within 1e-5 (the card's bound
    is 1e-4; a float32 run of the plain version itself lies about 2e-7
    from float64)."""
    x = _plane(h, w, seed=1)
    prm = torch.tensor(PARAMS, dtype=torch.float64)
    want = global_mixer_ref(x[None, None], *(v.view(1) for v in prm))[0, 0]
    assert _rel(emulate(x)["out"], want) <= 1e-12
    got32 = emulate(x.float())["out"]
    assert got32.dtype == torch.float32
    assert _rel(got32.double(), want) <= 1e-5


@pytest.mark.parametrize("h,w", SIZES)
def test_hermitian_c2r(h, w):
    """The c2r: from a half spectrum that is not hermitian in its bins 0
    and W/2 (nonzero imaginary parts there), the combination and the
    inverse row passes give irfft with those imaginary parts dropped."""
    n = w // 2
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((h, n + 1, 2)))
    p = fft_mixer_plan(h, w)
    tw_row, tw_half, _, pos = _tables(h, w, torch.float64)
    cols = torch.cat([pos, torch.tensor([n])])
    layout = torch.empty_like(x)
    layout[:, cols] = x                       # bin k at column pos[k]
    z = rows_inverse(combine(layout, tw_half, pos), p, tw_row)
    spec = _complex(x).clone()
    spec[:, [0, n]] = spec[:, [0, n]].real.to(spec.dtype)
    want = torch.fft.irfft(spec, n=w, dim=1) * w
    assert _rel(z.reshape(h, w), want) <= 1e-13


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("axis", ["H", "W"])
def test_constant_planes_keep_exact_zeros(h, w, axis):
    """float32 planes constant along H (equal rows) or along W (constant
    rows): every bin that is zero in exact arithmetic is exactly zero
    after the emulated forward transforms (the equal rows give equal
    bits, the differences vanish), the split's bins 0 and W/2 are
    exactly real, and the whole mixer matches a float64 oracle of the
    zero-bin path with a non-integer phase scale (noise in a zero bin
    would take a random phase there)."""
    rng = np.random.default_rng(3)
    shape = (1, w) if axis == "H" else (h, 1)
    x = torch.from_numpy(np.broadcast_to(rng.standard_normal(shape),
                                         (h, w)).astype(np.float32))
    st = emulate(x, (0.9, 0.5, 7.3, 0.1))
    p, n = fft_mixer_plan(h, w), w // 2
    pos = _positions(p["row"], n)
    cols = torch.cat([pos, torch.tensor([n])])
    spec = _complex(st["spec"][cols][:, _positions(p["col"], h)])
    spec = spec.transpose(0, 1)   # [H-bin, W-bin]
    nonzero = torch.zeros(h, n + 1, dtype=torch.bool)
    if axis == "H":
        nonzero[0] = True
    else:
        nonzero[:, 0] = True
    assert torch.all(spec[~nonzero] == 0)
    assert torch.all(st["half"][:, [0, n], 1] == 0)
    # the oracle: rfft2 in float64 with the exact zeros put back
    aw, ab, pw, pb = 0.9, 0.5, 7.3, 0.1
    z = torch.fft.rfft2(x.double())
    z[~nonzero] = 0
    re, im = z.real, z.imag.clone()
    for r in (0, h // 2):
        for c in (0, n):
            im[r, c] = 0
    zero = (re == 0) & (im == 0)
    amp = torch.where(zero, 0.0, torch.hypot(re, im)) * aw + ab
    pha = torch.where(zero, 0.0, torch.atan2(im, re)) * pw + pb
    spec = torch.complex(amp * torch.cos(pha) + 2e-8,
                         amp * torch.sin(pha) + 1e-8)
    mid = torch.fft.ifft(spec, dim=0)
    mid.imag[:, 0] = 0
    mid.imag[:, n] = 0
    want = torch.fft.irfft(mid, n=w, dim=1).abs()
    assert _rel(st["out"].double(), want) <= 1e-5


def test_negative_zero_takes_the_branch_cut_at_plus_pi():
    """A bin with a negative real part and an imaginary part of -0 or +0
    gets phase +pi, as numpy and torch give for +0 (`im + 0.0f`); a
    constant negative plane (a negative DC bin) through the whole
    emulated body gives the plain version's output at a non-integer
    phase scale."""
    prm = (1.0, 0.0, 0.7, 0.2)
    z = torch.tensor([[-1.0, -0.0], [-1.0, 0.0]])
    got = mix_bin(z, torch.tensor([False, False]), prm)
    assert torch.equal(got[0], got[1])
    pha = torch.tensor(math.pi, dtype=torch.float32) * 0.7 + 0.2
    assert torch.equal(got[0, 0], torch.cos(pha) + 1e-8 + 1e-8)
    x = torch.full((16, 24), -0.75)
    want = global_mixer_ref(x[None, None].double(),
                            *(torch.tensor([v], dtype=torch.float64)
                              for v in prm))[0, 0]
    assert _rel(emulate(x, prm)["out"].double(), want) <= 1e-5


def _parent_takes(h, w):
    """The shapes the parent's mixer took: even H, W, odd parts <= 512,
    the whole complex plane with its tables within 232,448 bytes."""
    odd = lambda v: v // (v & -v)
    smem = 8 * (h * w + h + w + odd(h) + odd(w)) + 4 * (w // 2 + 1)
    return (h % 2 == 0 and w % 2 == 0 and odd(h) <= 512 and odd(w) <= 512
            and smem <= FFT_SMEM_BYTES)


def test_check_plane_accepts_every_parent_shape():
    """`_check_plane` accepts every even H, W the parent's kernel took
    (all H, W up to 512, and H = 2 or W = 2 up to the shared-memory
    limit), and the half spectrum never needs more shared memory."""
    sizes = list(range(2, 514, 2))
    extremes = [(2, w) for w in range(2, 14600, 2)] + [
        (h, 2) for h in range(2, 9800, 2)]
    checked = 0
    for h, w in [(h, w) for h in sizes for w in sizes] + extremes:
        if not _parent_takes(h, w):
            continue
        _check_plane("global_mixer", torch.empty(1, 1, h, w, device="meta"))
        plan = fft_mixer_plan(h, w)
        assert max(plan["row"] + plan["col"] + [1]) <= FFT_MAX_PRIME
        checked += 1
    assert checked > 4000
