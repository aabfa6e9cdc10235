"""The arithmetic of the tensor-core window attention, on the CPU.

The kernel (`csrc/window_attention_tc.cuh::window_attention_head_tc`)
runs one head of an 8x8 window on one warpgroup: the qkv product, the
logits and A.V as wgmma TF32 with the 3xTF32 split. q and the softmax
numerators P pass from one product's accumulator to the next product's A
fragment in registers, which reads k-slot t of k-step j as column 8j + 2t
and slot t + 4 as 8j + 2t + 1; k and v are staged in shared memory in
that permuted order, and the position bias seeds the logits accumulator.
These tests spell out what each lane holds and where each staged value
lands, element by element, read the staged buffers back the way wgmma's
descriptor reads them, and emulate the whole head in torch, so that the
card's 1e-4 kernel bound is not spent on the arithmetic: the emulation
stays within 2e-6 of float64 and 1e-5 of `window_attention_ref`. The
plain version itself is held to the JAX package's `window_attention_xla`
and to the Pallas `fused_window_attention_v2_cm` in interpret mode at
head widths 4 (padded to 8), 8, 16 and 32.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lgteun_tpu.ops.window_attention import (fused_window_attention_v2_cm,
                                             window_attention_xla)
from lgteun_tpu_torch.ops.ffn_kernel import tf32_round, tf32_split
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_attention_branch
from lgteun_tpu_torch.ops.window_attention import (
    attention_branch, attention_fragments, attention_pad,
    window_attention, window_attention_ref, window_attention_windows_ref,
    window_partition)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_ops import f32, max_err  # noqa: E402

S = 64


def _lanes():
    """Per thread of a warpgroup: (row0 of its warp, g, t), flat [128]."""
    tid = np.arange(128)
    return (tid >> 5) * 16, (tid & 31) >> 2, tid & 3


def _acc_positions(nj):
    """(row, column) of accumulator element [thread][j][q] of a 64 x 8 nj
    product (tc_tf32.cuh: d[j] = {D[g][8j+2t], D[g][8j+2t+1], D[g+8][8j+2t],
    D[g+8][8j+2t+1]}), each [128, nj, 4]."""
    row0, g, t = _lanes()
    j, q = np.meshgrid(np.arange(nj), np.arange(4), indexing="ij")
    rows = row0[:, None, None] + g[:, None, None] + 8 * (q >> 1)[None]
    cols = 8 * j[None] + 2 * t[:, None, None] + (q & 1)[None]
    return rows, cols


def _slot_column(kstep, slot):
    """The column an A fragment's k-slot reads: slot t of k-step j is
    column 8j + 2t, slot t + 4 is 8j + 2t + 1."""
    return 8 * kstep + np.where(slot < 4, 2 * slot, 2 * (slot - 4) + 1)


def _read_b(buf, base, sbo_floats, n, kslot):
    """B[kslot][n] of one k-step as wgmma reads a K-major operand without
    swizzle from the descriptor at float offset `base`: core matrices of 8
    rows (n) x 4 (k), LBO 128 bytes along K, SBO along N."""
    return buf[base + (n // 8) * sbo_floats + (kslot // 4) * 32
               + (n % 8) * 4 + kslot % 4]


def _stage_k(kv, hdp):
    """The kernel's k staging: value kv[s][d] of lane (row0, g, t), element
    [j][q] lands at (s / 8) 8 HDP + (2j + q % 2) 32 + (s % 8) 4 + t."""
    rows, cols = _acc_positions(hdp // 8)
    _, _, t = _lanes()
    j = np.arange(hdp // 8)[None, :, None]
    q = np.arange(4)[None, None, :]
    off = ((rows >> 3) * 8 * hdp + (2 * j + (q & 1)) * 32 + (rows & 7) * 4
           + t[:, None, None])
    buf = np.full(S * hdp, np.nan, np.float32)
    buf[off.ravel()] = kv[rows.ravel(), cols.ravel()]
    return buf


def _stage_v(vv, hdp):
    """The kernel's v staging: value vv[s][d] (d = 8j + 2t + q % 2) lands
    at j 512 + (2 (s / 8) + s % 2) 32 + (d % 8) 4 + (s % 8) / 2."""
    rows, cols = _acc_positions(hdp // 8)
    off = ((cols >> 3) * 512 + (2 * (rows >> 3) + (rows & 1)) * 32
           + (cols & 7) * 4 + ((rows & 7) >> 1))
    buf = np.full(S * hdp, np.nan, np.float32)
    buf[off.ravel()] = vv[rows.ravel(), cols.ravel()]
    return buf


@pytest.mark.parametrize("hdp", [8, 16, 32])
def test_k_staging_is_the_permuted_logits_b_operand(hdp):
    """Every k value is staged once, and the logits product's B read
    through the descriptor (k-step ks at 64 ks floats, SBO 32 HDP bytes)
    is k[key][column of the slot], the column that A's slot reads from
    q's accumulator."""
    kv = np.random.default_rng(0).standard_normal((S, hdp)).astype(
        np.float32)
    buf = _stage_k(kv, hdp)
    assert not np.isnan(buf).any()
    n, kslot = np.meshgrid(np.arange(S), np.arange(8), indexing="ij")
    for ks in range(hdp // 8):
        got = _read_b(buf, 64 * ks, 8 * hdp, n, kslot)
        assert np.array_equal(got, kv[n, _slot_column(ks, kslot)])


@pytest.mark.parametrize("hdp", [8, 16, 32])
def test_v_staging_is_the_permuted_av_b_operand(hdp):
    """Every v value is staged once, and A.V's B read through the
    descriptor (k-step ks at 64 ks floats, SBO 2048 bytes) is v[key of
    the slot][dim], the key that A's slot reads from P's accumulator."""
    vv = np.random.default_rng(1).standard_normal((S, hdp)).astype(
        np.float32)
    buf = _stage_v(vv, hdp)
    assert not np.isnan(buf).any()
    n, kslot = np.meshgrid(np.arange(hdp), np.arange(8), indexing="ij")
    for ks in range(8):
        got = _read_b(buf, 64 * ks, 512, n, kslot)
        assert np.array_equal(got, vv[_slot_column(ks, kslot), n])


def test_a_fragment_from_accumulator_order():
    """The A fragment {a0, a1, a2, a3} = {A[g][t], A[g+8][t], A[g][t+4],
    A[g+8][t+4]} of k-step j taken from an accumulator as {d0, d2, d1, d3}
    reads row g / g + 8 and column _slot_column(j, t / t + 4) of it."""
    rows, cols = _acc_positions(8)
    row0, g, t = _lanes()
    for j in range(8):
        # A fragment register: (accumulator register, row offset, slot)
        for qa, row_off, s in ((0, 0, 0), (2, 8, 0), (1, 0, 4), (3, 8, 4)):
            assert np.array_equal(rows[:, j, qa], row0 + g + row_off)
            assert np.array_equal(cols[:, j, qa],
                                  _slot_column(j, t + s))


def test_pos_seeds_the_logits_accumulator():
    """attention_pos: p[j][q] = pos[h][row][col] at the accumulator's
    (row, col), so every (query, key) bias is loaded exactly once."""
    rows, cols = _acc_positions(8)
    flat = rows * S + cols
    assert np.array_equal(np.sort(flat.ravel()), np.arange(S * S))


def _unpack_weights(frag, c, heads):
    """attention_fragments' inverse: [heads, 3, 2, HDP, CP]."""
    hdp, cp = attention_pad(c // heads), attention_pad(c)
    t = frag.view(heads, 3, 2, hdp // 8, cp // 4, 8, 4)
    return t.permute(0, 1, 2, 3, 5, 4, 6).reshape(heads, 3, 2, hdp, cp)


@pytest.mark.parametrize("c,heads", [(8, 2), (16, 2), (32, 2), (64, 2),
                                     (12, 3), (24, 1)])
def test_weight_fragments_are_the_qkv_b_operand(c, heads):
    """attention_fragments read through the qkv product's descriptors
    (part p of head h at ((h 3 + p) 2 + hi/lo) HDP CP floats, k-step ks 64
    ks on, SBO 32 CP bytes) give tf32_split of wqkv's rows p C + h hd + d,
    zero in the padding."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(f32(rng, 3 * c, c))
    hd = c // heads
    hdp, cp = attention_pad(hd), attention_pad(c)
    frag = attention_fragments(w, heads).numpy()
    assert frag.size == heads * 6 * hdp * cp
    hi, lo = (p.numpy() for p in tf32_split(w))
    n, kslot = np.meshgrid(np.arange(hdp), np.arange(8), indexing="ij")
    for h in range(heads):
        for p in range(3):
            for part, want_all in enumerate((hi, lo)):
                base = ((h * 3 + p) * 2 + part) * hdp * cp
                for ks in range(cp // 8):
                    got = _read_b(frag, base + 64 * ks, 8 * cp, n, kslot)
                    k = 8 * ks + kslot
                    live = (n < hd) & (k < c)
                    want = np.where(live, want_all[
                        p * c + h * hd + np.minimum(n, hd - 1),
                        np.minimum(k, c - 1)], 0.0)
                    assert np.array_equal(got, want)
    unpacked = _unpack_weights(torch.from_numpy(frag), c, heads)
    assert torch.equal(unpacked[:, :, 0, :hd, :c].reshape(-1, c),
                       tf32_round(w).view(3, heads, hd, c).transpose(0, 1)
                       .reshape(-1, c))


def _mm3(a, b):
    """a [.., M, K] . b [.., K, N] as three TF32 passes summed in float32
    (lo.hi, hi.lo, hi.hi), each pass exact."""
    ah, al = tf32_split(a.contiguous())
    bh, bl = tf32_split(b.contiguous())
    return al @ bh + ah @ bl + ah @ bh


PERM = np.concatenate([np.arange(0, 8, 2), np.arange(1, 8, 2)])


def _emulate(xt, wqkv, bqkv, pos, heads):
    """The kernel's head computation on [N, C, 64] windows: 3xTF32
    products, q and P passed on in the permuted column order (the B
    operands staged to match), the bias as the logits' start, expf
    numerators times 1 / rowsum."""
    n, c, _ = xt.shape
    hd = c // heads
    hdp = attention_pad(hd)
    x = xt.transpose(1, 2)                                   # [N, 64, C]
    out = torch.empty_like(x)
    perm_d = torch.from_numpy((np.arange(hdp) // 8 * 8)
                              + PERM[np.arange(hdp) % 8])
    perm_s = torch.from_numpy((np.arange(S) // 8 * 8) + PERM[np.arange(S) % 8])
    for h in range(heads):
        rows = [p * c + h * hd + np.arange(hd) for p in range(3)]
        q, k, v = (_mm3(x, wqkv[r].t()) + bqkv[r] for r in rows)
        pad = lambda t: torch.nn.functional.pad(t, (0, hdp - hd))
        q, k, v = pad(q * hd ** -0.5), pad(k), pad(v)
        q, k = q[..., perm_d], k[..., perm_d]              # the slot order
        logits = pos[h] + _mm3(q, k.transpose(1, 2))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        rinv = 1.0 / e.sum(-1, keepdim=True)
        o = _mm3(e[..., perm_s], v[:, perm_s])              # keys permuted
        out[..., h * hd:(h + 1) * hd] = o[..., :hd] * rinv
    return out.transpose(1, 2)


@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_emulated_tc_attention_is_fp32_accurate(c):
    """The emulated tensor-core head stays within 2e-6 of float64 and
    within 1e-5 of window_attention_windows_ref (relative to the largest
    output) at heads = 2, head widths 4 (padded to 8), 8, 16 and 32."""
    rng = np.random.default_rng(3)
    heads = 2
    xt = torch.from_numpy(f32(rng, 6, c, S))
    wqkv = torch.from_numpy(f32(rng, 3 * c, c, scale=c ** -0.5))
    bqkv = torch.from_numpy(0.1 * f32(rng, 3 * c))
    pos = torch.from_numpy(f32(rng, heads, S, S))
    got = _emulate(xt, wqkv, bqkv, pos, heads)
    exact = window_attention_windows_ref(xt.double(), wqkv.double(),
                                         bqkv.double(), pos.double(), heads)
    plain = window_attention_windows_ref(xt, wqkv, bqkv, pos, heads)
    scale = exact.abs().max()
    assert (got.double() - exact).abs().max() / scale <= 2e-6
    assert (got - plain).abs().max() / plain.abs().max() <= 1e-5


@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_plain_attention_matches_jax_at_each_head_width(c):
    """window_attention_ref against JAX window_attention_xla and the
    Pallas fused_window_attention_v2_cm (interpret mode) at hd = c / 2:
    within 1e-5 at unit-scale inputs (f32 softmax and matmuls in other
    orders; the bound tests/test_torch_port_window_layouts.py uses)."""
    rng = np.random.default_rng(4)
    heads = 2
    y = f32(rng, 2, c, 16, 16)
    wqkv = f32(rng, c, 3 * c, scale=c ** -0.5)        # JAX: [C, 3C]
    bqkv, pos = 0.1 * f32(rng, 3 * c), f32(rng, heads, S, S)
    t = torch.from_numpy
    got = window_attention_ref(t(y), t(np.ascontiguousarray(wqkv.T)),
                               t(bqkv), t(pos), heads, 8)
    xt = window_partition(t(y), 8).numpy()
    scale = (c // heads) ** -0.5
    xla = window_attention_xla(jnp.asarray(xt.transpose(0, 2, 1)),
                               *(jnp.asarray(a) for a in (wqkv, bqkv, pos)),
                               heads, scale)
    pallas = fused_window_attention_v2_cm(
        *(jnp.asarray(a) for a in (xt, wqkv, bqkv, pos)), heads=heads,
        scale=scale, interpret=True)
    mine = window_partition(got, 8).numpy()
    assert max_err(mine, np.asarray(xla).transpose(0, 2, 1)) <= 1e-5
    assert max_err(mine, pallas) <= 1e-5


@pytest.mark.parametrize("c,heads,win,want", [
    (16, 2, 8, "tc"), (32, 2, 8, "tc"), (8, 2, 8, "tc"), (64, 2, 8, "tc"),
    (64, 1, 8, "fp32"), (128, 2, 8, "fp32"), (16, 2, 4, "fp32"),
    (12, 3, 8, "tc"), (64, 8, 8, "tc"), (16, 16, 8, "fp32")])
def test_branch_by_shape(c, heads, win, want):
    """The tensor cores take 8x8 windows with a padded head <= 32, padded
    C <= 64 and heads x padded head <= 64; B8 also needs 4 % heads == 0."""
    assert attention_branch(c, heads, win) == want
    b8 = want if 4 % heads == 0 else "fp32"
    assert lgb_attention_branch(c, heads, win) == b8


def test_wrapper_on_cpu_counts_no_launch():
    """On a CPU tensor window_attention is its plain version and counts
    neither a launch nor a branch."""
    rng = np.random.default_rng(5)
    y = torch.from_numpy(f32(rng, 1, 16, 8, 8))
    w = (torch.from_numpy(f32(rng, 48, 16)), torch.from_numpy(f32(rng, 48)),
         torch.from_numpy(f32(rng, 2, S, S)))
    before = (window_attention.launches, dict(window_attention.variants))
    assert torch.equal(window_attention(y, *w, 2, 8),
                       window_attention_ref(y, *w, 2, 8))
    assert (window_attention.launches,
            dict(window_attention.variants)) == before
