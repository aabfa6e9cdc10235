"""The arithmetic of MDCUN's neighbourhood attention on the tensor cores,
on the CPU.

The kernel's tensor-core body (`csrc/neighborhood_attention.cu::
na_tc_kernel`) gives each warp a run of 16 queries along a row. Per
neighbourhood row dy and chunk of 32 keys (from x0 - fs // 2), the
logits theta[16 x C] . phi[C x 32] are mma.sync m16n8k8 TF32 products
with the 3xTF32 split (C padded to 8, 16 or 32; theta scaled by log2 e
first; each operand's lo part read truncated); a key outside a query's
window gets -inf, an out-of-image key keeps logit 0 and g = 0; each
query row's maximum over the chunk rescales the running sum and the
output accumulators once; P = exp2((S - max) log2 e) goes from the
accumulator to the A fragment as {d0, d2, d1, d3} (key 8j + 2t in k-slot
t, 8j + 2t + 1 in k-slot t + 4) for O += P . g, in two accumulators
(even and odd n-tiles); at the end O / sum, and out = x + Ww O.

These tests check the fragment maps lane by lane, the shared-memory
strides' banks, the window mask against the zero-logit border, the
per-row maximum and rescale order, and emulate the whole body in torch,
so that the card's checks are not spent on the arithmetic: within 2e-6
of float64, within 1e-5 of the plain version and within 5e-5 of the JAX
package's `neighborhood_attention_xla` and its Pallas kernel in
interpret mode, at C = 4, 8, 16 and 32 and on ragged images. Also the
branch rule (tensor cores where their staging fits shared memory) and
the CPU wrapper's counts.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from lgteun_tpu.ops.nonlocal_kernel import (_fused_na_impl,
                                            neighborhood_attention_xla)
from lgteun_tpu_torch.ops.ffn_kernel import tf32_split
from lgteun_tpu_torch.ops.nonlocal_kernel import (
    _smem_bytes, _tc_smem_bytes, neighborhood_attention,
    neighborhood_attention_branch, neighborhood_attention_ref)

RUN = 16
KEYS = 32
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3


def _cp(c):
    return 8 if c <= 8 else 16 if c <= 16 else 32


def _case(rng, b, c, h, w, scale=1.0):
    """x [B, C, H, W] and the four [C, C] (out, in) matrices, float32."""
    f = lambda *s, k=1.0: torch.from_numpy(
        (rng.standard_normal(s) * k).astype(np.float32))
    return f(b, c, h, w), [f(c, c, k=scale * c ** -0.5) for _ in range(4)]


def test_accumulator_to_a_fragment_keeps_the_keys_in_step_with_g():
    """Lane by lane: the logits accumulator of n-tile j holds D[g][2t],
    D[g][2t+1], D[g+8][2t], D[g+8][2t+1] (keys 8j + 2t, + 1); taken as the
    A fragment {d0, d2, d1, d3} it puts key 8j + 2t in k-slot t and key
    8j + 2t + 1 in k-slot t + 4 of rows g, g + 8; g's B fragment (b0 =
    g[8j + 2t][n0 + g], b1 = g[8j + 2t + 1][n0 + g]) uses the same keys,
    so the product over the slots is P . g over the keys."""
    gq, tq = _lanes()
    rng = np.random.default_rng(0)
    p = rng.standard_normal((16, 8))
    gv = rng.standard_normal((8, 8))
    a = np.full((16, 8), np.nan)
    bmat = np.full((8, 8), np.nan)
    for lane in range(32):
        g, t = gq[lane], tq[lane]
        d = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
             p[g + 8, 2 * t + 1]]
        frag = [d[0], d[2], d[1], d[3]]     # {a0, a1, a2, a3}
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = frag
        bmat[t, g], bmat[t + 4, g] = gv[2 * t, g], gv[2 * t + 1, g]
    assert not np.isnan(a).any() and not np.isnan(bmat).any()
    np.testing.assert_allclose(a @ bmat, p @ gv, rtol=1e-12, atol=1e-12)


def test_logits_fragments_read_theta_and_phi():
    """theta's A fragments (a0 = theta[g][8ks + t], a1 = theta[g + 8][..],
    a2 / a3 at channel + 4) and phi's B fragments (b0 = phi[key 8nt +
    g][8ks + t], b1 at channel + 4) make, lane by lane, the logits
    theta . phi^T of n-tile nt; the accumulator's element e of lane 4g +
    t is query g + 8 (e // 2), key 8nt + 2t + e % 2."""
    gq, tq = _lanes()
    rng = np.random.default_rng(1)
    theta = rng.standard_normal((16, 8))
    phi = rng.standard_normal((32, 8))
    for nt in range(4):
        a = np.full((16, 8), np.nan)
        bmat = np.full((8, 8), np.nan)
        for lane in range(32):
            g, t = gq[lane], tq[lane]
            a[g, t], a[g + 8, t] = theta[g, t], theta[g + 8, t]
            a[g, t + 4], a[g + 8, t + 4] = theta[g, t + 4], theta[g + 8, t + 4]
            bmat[t, g] = phi[8 * nt + g, t]
            bmat[t + 4, g] = phi[8 * nt + g, t + 4]
        d = a @ bmat
        want = theta @ phi.T
        for lane in range(32):
            g, t = gq[lane], tq[lane]
            for e in range(4):
                q, key = g + 8 * (e // 2), 8 * nt + 2 * t + e % 2
                assert math.isclose(d[q, key - 8 * nt], want[q, key],
                                    rel_tol=1e-12, abs_tol=1e-12)


@pytest.mark.parametrize("c", [4, 8, 16, 32])
def test_staged_strides_hit_every_bank_once(c):
    """phi and g are staged [row][key][CP + 4]: the logits' B loads (lane
    4g + t: key g, channel t (+ 4)) and the P . g B loads (key 2t (+ 1),
    channel g) touch 32 distinct banks."""
    gq, tq = _lanes()
    st = _cp(c) + 4
    for addr in (gq * st + tq, gq * st + tq + 4, 2 * tq * st + gq,
                 (2 * tq + 1) * st + gq):
        assert len(set(addr % 32)) == 32


def split_trunc(t):
    """tc_tf32.cuh::split_tf32_trunc as the tensor cores read it: hi =
    tf32(t) rounded to nearest, lo = t - hi with its low 13 bits
    dropped."""
    hi = tf32_split(t.contiguous())[0]
    lo = (t - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def _mm3(a, b):
    """a [.., M, 8] . b [.., 8, N] as three mma.sync passes (lo.hi,
    hi.lo, hi.hi), each product exact, the passes summed in float32;
    every operand split as the kernel splits it (split_trunc)."""
    ah, al = split_trunc(a)
    bh, bl = split_trunc(b)
    return (al @ bh, ah @ bl, ah @ bh)


# k-slot s of a P . g k-step reads key 2s (s < 4) or 2 (s - 4) + 1
SLOT_KEY = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def emulated_na(x, wt, wp, wg, ww, fs, *, border="zero", window=True):
    """The tensor-core body on [B, C, H, W] in torch, all runs at once.
    `border="mask"` (out-of-image keys masked to -inf) and `window=False`
    (no window mask) break the rules, for the tests that show them."""
    b, c, h, w = x.shape
    cp, r = _cp(c), fs // 2
    nch = -(-(RUN + fs - 1) // KEYS)
    runs = -(-w // RUN)
    pw = lambda m: F.pad(F.conv2d(x, m[:, :, None, None]),
                         (0, 0, 0, 0, 0, cp - c))
    theta, phi, g = pw(wt), pw(wp), pw(wg)                  # [B, CP, H, W]
    # queries [B, H, runs, 16, CP], zero past W
    tq = F.pad(theta, (0, runs * RUN - w)).permute(0, 2, 3, 1).reshape(
        b, h, runs, RUN, cp)
    # keys: padded planes, rows y + dy - r, columns x0 - r + kk
    wide = KEYS * nch
    pad = (r, runs * RUN - w + wide, r, r)
    inside = F.pad(torch.ones(1, 1, h, w), pad)[0, 0] > 0
    phis, gs = F.pad(phi, pad), F.pad(g, pad)
    ath = tq * LOG2E                     # A: [.., 16, CP], in log2 units
    o = [torch.zeros(b, h, runs, RUN, cp) for _ in range(2)]
    m = torch.full((b, h, runs, RUN, 1), -math.inf)
    lsum = torch.zeros(b, h, runs, RUN, 1)
    qi = torch.arange(RUN)[:, None]
    for dy in range(fs):
        rows = torch.arange(h) + dy                       # padded row
        for ch in range(nch):
            cols = (torch.arange(runs) * RUN)[:, None] + KEYS * ch + \
                torch.arange(KEYS)                        # [runs, 32]
            kp = phis[:, :, rows][:, :, :, cols]          # [B,CP,H,runs,32]
            kg = gs[:, :, rows][:, :, :, cols]
            kp = kp.permute(0, 2, 3, 4, 1)                # [B,H,runs,32,CP]
            kg = kg.permute(0, 2, 3, 4, 1)
            s = torch.zeros(b, h, runs, RUN, KEYS)
            for ks in range(cp // 8):
                sl = slice(8 * ks, 8 * ks + 8)
                for part in _mm3(ath[..., sl], kp[..., sl].transpose(-1, -2)):
                    s = s + part
            key = KEYS * ch + torch.arange(KEYS)[None, :]
            ok = (key >= qi) & (key < qi + fs) if window else \
                torch.ones(RUN, KEYS, dtype=torch.bool)
            if border == "mask":
                ok = ok & inside[rows][:, cols][:, :, None, :]
            # (the broken border rule can mask a whole row: a large
            # negative logit there, not -inf, keeps its sums finite)
            s = torch.where(ok, s, -math.inf if border == "zero" else -1e30)
            mx = s.amax(-1, keepdim=True)
            mn = torch.maximum(m, mx)
            scale = torch.exp2(m - mn)
            m = mn
            lsum = lsum * scale
            o = [t * scale for t in o]
            p = torch.exp2(s - m)
            lsum = lsum + p.sum(-1, keepdim=True)
            for nt in range(4):
                keys = 8 * nt + SLOT_KEY                  # k-slot order
                pa = p[..., keys]
                gb = kg[..., keys, :]
                for part in _mm3(pa, gb):
                    o[nt & 1] = o[nt & 1] + part
    out = (o[0] + o[1]) / lsum                            # [B,H,runs,16,CP]
    out = out.reshape(b, h, runs * RUN, cp)[:, :, :w, :c].permute(0, 3, 1, 2)
    return F.conv2d(out, ww[:, :, None, None]) + x


def _float64(x, mats, fs):
    return neighborhood_attention_ref(x.double(), *(m.double() for m in mats),
                                      fs)


@pytest.mark.parametrize("b,c,h,w,fs", [(1, 8, 24, 40, 15), (2, 4, 20, 36, 15),
                                        (1, 16, 18, 33, 15),
                                        (1, 32, 12, 20, 15),
                                        (1, 8, 20, 40, 31)])
def test_emulated_na_is_fp32_accurate(b, c, h, w, fs):
    """The emulated body within 2e-6 of the float64 plain version and
    within 1e-5 of the float32 plain version (each relative to the
    largest value, as chip_smoke.py holds the kernel; the float32 plain
    version's 225-term softmax is itself about 1e-5 off float64 here),
    at C = 4 to 32, ragged widths, and fs = 31 (two key chunks a row)."""
    x, mats = _case(np.random.default_rng(c + h), b, c, h, w)
    got = emulated_na(x, *mats, fs)
    exact = _float64(x, mats, fs)
    assert torch.isfinite(got).all()
    assert (got.double() - exact).abs().max() <= 2e-6 * exact.abs().max()
    plain = neighborhood_attention_ref(x, *mats, fs)
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()


def test_window_mask_is_not_the_border():
    """On a 10 x 12 image every 15 x 15 window reaches outside it: the
    emulation (out-of-image keys at logit 0 with g = 0, out-of-window keys
    at -inf) matches the plain version; masking the out-of-image keys
    instead, or not masking the window, moves it far off."""
    x, mats = _case(np.random.default_rng(3), 1, 8, 10, 12)
    plain = neighborhood_attention_ref(x, *mats, 15)
    scale = plain.abs().max()
    assert (emulated_na(x, *mats, 15) - plain).abs().max() <= 1e-5 * scale
    assert (emulated_na(x, *mats, 15, border="mask") - plain).abs().max() \
        > 1e-3 * scale
    assert (emulated_na(x, *mats, 15, window=False) - plain).abs().max() \
        > 1e-3 * scale


def test_row_maximum_and_rescale_order():
    """Logits in the hundreds (the weights scaled up): each chunk's row
    maximum taken before the exponentials keeps every value finite, with
    fs = 31 (two chunks a row, the second rescaling the first) and fs =
    15, and the result as close to float64 as the float32 plain version
    (whose softmax subtracts the maximum over all 225 at once; at such
    logits float32's spacing alone moves the weights by about 1e-5); an
    exponential without the maximum overflows float32 there."""
    x, mats = _case(np.random.default_rng(4), 1, 8, 16, 40, scale=12.0)
    for fs in (15, 31):
        got = emulated_na(x, *mats, fs)
        exact = _float64(x, mats, fs)
        plain = neighborhood_attention_ref(x, *mats, fs)
        assert torch.isfinite(got).all()
        assert (got.double() - exact).abs().max() <= \
            2 * (plain.double() - exact).abs().max()
    theta = F.conv2d(x, mats[0][:, :, None, None])
    phi = F.conv2d(x, mats[1][:, :, None, None])
    assert torch.isinf(torch.exp((theta * phi).sum(1))).any()


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 128, 8), (1, 16, 128, 4)])
def test_emulated_na_matches_jax(b, h, w, c):
    """The emulated body vs the JAX package's XLA path and its Pallas
    kernel in interpret mode at fs = 15, within 5e-5 as the plain
    version is held (NHWC, [in, out] matrices on the JAX side)."""
    x, mats = _case(np.random.default_rng(10 + c), b, c, h, w)
    got = emulated_na(x, *mats, 15).permute(0, 2, 3, 1).numpy()
    jx = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    jm = [jnp.asarray(m.t().numpy()) for m in mats]
    for want in (neighborhood_attention_xla(jx, *jm, 15),
                 _fused_na_impl(jx, *jm, fs=15, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("c,fs,want", [(8, 15, "tc"), (4, 15, "tc"),
                                       (16, 15, "tc"), (32, 15, "tc"),
                                       (8, 31, "tc"), (8, 7, "tc"),
                                       (16, 25, "fp32"), (8, 35, "fp32"),
                                       (4, 41, "fp32")])
def test_branch_by_shape(c, fs, want):
    """The tensor cores wherever their staging fits a block's shared
    memory (MDCUN's C = 8, fs = 15 in 56,320 bytes at 4 runs a block),
    the FP32-core body for larger windows it still takes."""
    assert neighborhood_attention_branch(c, fs) == want
    assert _tc_smem_bytes(8, 15) == 56_320
    if want == "fp32":
        assert _smem_bytes(c, fs) <= 232_448 < _tc_smem_bytes(c, fs)


def test_wrapper_on_cpu_counts_no_launch():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch of either branch."""
    x, mats = _case(np.random.default_rng(5), 1, 8, 12, 20)
    before = (neighborhood_attention.launches,
              dict(neighborhood_attention.variants))
    got = neighborhood_attention(x, *mats, 15)
    assert (neighborhood_attention.launches,
            dict(neighborhood_attention.variants)) == before
    assert torch.equal(got, neighborhood_attention_ref(x, *mats, 15))
