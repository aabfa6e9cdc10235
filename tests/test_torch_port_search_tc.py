"""The arithmetic of INNT's search on the tensor cores, on the CPU.

The kernels' tensor-core body (`csrc/texture_match_tc.cuh::search_tc`,
B10 `texture_match` and B11 `patch_match`) runs R = query . ref^T as
wgmma m64n64k8 TF32 with the 3xTF32 split: 64 queries a warpgroup tile
in the A fragments (split into hi/lo as loaded), refs in chunks of 64
from shared memory, staged hi/lo in wgmma's K-major core-matrix order, K
zero-padded to SEARCH_KP = 40. Each thread folds its accumulator values
(two query rows, columns 8j + 2t and + 1 of each chunk): a row's 16
values of a chunk by a tree in which the later range wins only on a
strictly greater value, then into a running maximum that a later chunk
replaces only when strictly greater; the four lanes of a quad then take
the larger value, on equal values the smaller index.

These tests spell out where each staged value lands and read it back the
way wgmma's descriptor reads it, check the A fragment's and the
accumulator's element order, check the tree against a scan on values
with many ties, and emulate the whole search in torch (the three passes
summed in float32 in the kernel's k-step order, the lanes' chunk trees
and running maxima, the quad's merge), so that the card's checks are not
spent on the arithmetic: R within 2e-6 of float64, the picks equal to the
plain versions' outside float64 near ties (a gap of 1e-5) and exactly on
the tie inputs, and the emulated searches against the JAX package's
`texture_match_xla` / `patch_match_xla` and the Pallas kernels in
interpret mode. Also the branch rule by shape and the CPU wrappers'
counts.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from lgteun_tpu.ops.patch_match_kernel import _fused_pm_impl, patch_match_xla
from lgteun_tpu.ops.texture_match_kernel import (_fused_tm_impl,
                                                 texture_match_xla)
from lgteun_tpu_torch.ops.ffn_kernel import tf32_split
from lgteun_tpu_torch.ops.patch_match_kernel import (patch_match,
                                                     patch_match_branch,
                                                     patch_match_ref)
from lgteun_tpu_torch.ops.texture_match_kernel import (
    SEARCH_KP, SEARCH_TILE, row_normalize, search_pad, texture_match,
    texture_match_branch, texture_match_ref)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_ops import f32  # noqa: E402

KQ = SEARCH_KP // 4          # k-quads: core matrices along K
KS = SEARCH_KP // 8          # k-steps
NEAR_TIE = 1e-5              # float64 gap below a query's best value


def _lanes():
    """Per thread of a warpgroup: (row0 of its warp, g, t), flat [128]."""
    tid = np.arange(128)
    return (tid >> 5) * 16, (tid & 31) >> 2, tid & 3


def _ref_offset(i, kq):
    """texture_match_tc.cuh::search_ref_offset: float offset of ref i's
    k-quad kq in a staged part."""
    return (i >> 3) * (KQ * 32) + kq * 32 + (i & 7) * 4


def _stage(ref):
    """The kernel's staging of ref vectors [L, K] (search_stage, ref i's
    k-quad kq as 16 bytes at _ref_offset), zero vectors up to
    search_pad(L): the (hi, lo) buffers, flat."""
    ll, k = ref.shape
    lp = search_pad(ll)
    pad = F.pad(ref, (0, SEARCH_KP - k, 0, lp - ll))
    parts = []
    for part in tf32_split(pad.contiguous()):
        buf = np.full(lp * SEARCH_KP, np.nan, np.float32)
        i, kk = np.meshgrid(np.arange(lp), np.arange(SEARCH_KP),
                            indexing="ij")
        buf[_ref_offset(i, kk // 4) + kk % 4] = part.numpy()
        parts.append(buf)
    return parts


def _read_b(buf, base, n, kslot):
    """B[kslot][n] of one k-step as wgmma reads a K-major operand without
    swizzle from the descriptor at float offset `base`: core matrices of 8
    rows (n) x 4 (k), LBO 128 bytes along K, SBO KQ x 128 bytes along N."""
    return buf[base + (n // 8) * KQ * 32 + (kslot // 4) * 32 + (n % 8) * 4
               + kslot % 4]


@pytest.mark.parametrize("ll,k", [(576, 36), (100, 36), (9, 9), (64, 40)])
def test_staged_refs_are_the_b_operand(ll, k):
    """Every staged value lands once, and chunk c's k-step ks read through
    its descriptors (c 64 SEARCH_KP + 64 ks floats on) is tf32_split of
    ref [c 64 + n][8 ks + kslot], zero past L and past K."""
    ref = torch.from_numpy(f32(np.random.default_rng(ll), ll, k))
    lp = search_pad(ll)
    want = [F.pad(p, (0, SEARCH_KP - k, 0, lp - ll)).numpy()
            for p in tf32_split(ref)]
    n, kslot = np.meshgrid(np.arange(SEARCH_TILE), np.arange(8),
                           indexing="ij")
    for buf, part in zip(_stage(ref), want):
        assert not np.isnan(buf).any()
        for c in range(lp // SEARCH_TILE):
            for ks in range(KS):
                got = _read_b(buf, c * SEARCH_TILE * SEARCH_KP + 64 * ks, n,
                              kslot)
                assert np.array_equal(got, part[c * SEARCH_TILE + n,
                                                 8 * ks + kslot])


def test_query_fragment_order():
    """The query tile's A fragments: lane 4g + t of warp w holds, for
    k-step ks and register q, query 16 w + g + 8 (q % 2), value 8 ks + t +
    4 (q / 2): wgmma's {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}
    (tc_tf32.cuh), every (query, value) of the 64 x SEARCH_KP tile once."""
    row0, g, t = _lanes()
    seen = np.zeros((SEARCH_TILE, SEARCH_KP), int)
    for ks in range(KS):
        for q in range(4):
            row = row0 + g + 8 * (q & 1)
            k = 8 * ks + t + 4 * (q >> 1)
            wgmma_row = row0 + g + (8 if q in (1, 3) else 0)
            wgmma_col = 8 * ks + t + (4 if q >= 2 else 0)
            assert np.array_equal(row, wgmma_row)
            assert np.array_equal(k, wgmma_col)
            np.add.at(seen, (row, k), 1)
    assert (seen == 1).all()


def _lane_columns(t, ll):
    """The columns lane t of a quad folds, in the order it folds them:
    chunk by chunk, j = 0..7, then +0 / +1 (the accumulator's d[j][q]
    holds column 8j + 2t + q % 2), none at or past L."""
    cols = [c * SEARCH_TILE + 8 * j + 2 * t + u
            for c in range(search_pad(ll) // SEARCH_TILE)
            for j in range(8) for u in range(2)]
    return [c for c in cols if c < ll]


def test_lanes_fold_every_column_once_in_order():
    """The quad's lanes cover every ref column of a query exactly once,
    each lane in increasing index (so a strict > keeps its first
    maximum); L = 100 ends inside a chunk."""
    for ll in (576, 100):
        cols = [_lane_columns(t, ll) for t in range(4)]
        assert sorted(sum(cols, [])) == list(range(ll))
        assert all(c == sorted(c) for c in cols)


def emulated_r(lr_n, ref_n):
    """R [N, query, ref] as the kernel forms it: both operands zero-padded
    to SEARCH_KP and split into TF32 hi/lo parts; per k-step of 8 the
    passes lo.hi, hi.lo, hi.hi, each added to the float32 accumulator."""
    pad = lambda v: F.pad(v, (0, SEARCH_KP - v.shape[-1])).contiguous()
    ah, al = tf32_split(pad(lr_n))
    bh, bl = tf32_split(pad(ref_n))
    d = torch.zeros(lr_n.shape[0], lr_n.shape[1], ref_n.shape[1])
    for ks in range(KS):
        sl = slice(8 * ks, 8 * ks + 8)
        for a, b in ((al, bh), (ah, bl), (ah, bh)):
            d = d + a[..., sl] @ b[..., sl].transpose(1, 2)
    return d


def _row_max_tree(v, i):
    """search_row_max: the first maximum of 16 values v [..., 16] (in
    column order, indices i) by the tree over neighbouring ranges, the
    later range winning only on a strictly greater value."""
    v, i = v.clone(), i.clone()
    s = 1
    while s < 16:
        for a in range(0, 16, 2 * s):
            take = v[..., a + s] > v[..., a]
            v[..., a] = torch.where(take, v[..., a + s], v[..., a])
            i[..., a] = torch.where(take, i[..., a + s], i[..., a])
        s *= 2
    return v[..., 0], i[..., 0]


def emulated_first_max(r):
    """(value, index) [N, queries] of r [N, query, ref] as the kernel finds
    them: each lane folds chunk after chunk, a chunk's 16 values of a row
    by the tree (search_fold; columns past L count as -inf) and the
    chunk's maximum into the running one on a strictly greater value;
    then the quad merges lanes t and t ^ 1, then t and t ^ 2 (the larger
    value; on equal values the smaller index)."""
    ll = r.shape[2]
    lp = search_pad(ll)
    rp = F.pad(r, (0, lp - ll), value=-torch.inf)
    lanes = []
    for t in range(4):
        v = torch.full(r.shape[:2], -torch.inf)
        i = torch.zeros(r.shape[:2], dtype=torch.long)
        for c in range(lp // SEARCH_TILE):
            cols = torch.tensor([c * SEARCH_TILE + 8 * j + 2 * t + u
                                 for j in range(8) for u in range(2)])
            cv, ci = _row_max_tree(rp[..., cols], cols.expand(*r.shape[:2],
                                                              16))
            up = cv > v
            v, i = torch.where(up, cv, v), torch.where(up, ci, i)
        lanes.append((v, i))
    for o in (1, 2):
        merged = []
        for t in range(4):
            (v, i), (vo, io) = lanes[t], lanes[t ^ o]
            take = (vo > v) | ((vo == v) & (io < i))
            merged.append((torch.where(take, vo, v), torch.where(take, io, i)))
        lanes = merged
    return lanes[0]


@pytest.mark.parametrize("levels", [2, 5, 1000])
def test_row_max_tree_takes_the_first_maximum(levels):
    """The tree's (value, index) equals the first maximum of a scan in
    column order, with many exact ties (integer values from `levels`)."""
    rng = np.random.default_rng(levels)
    v = torch.from_numpy(rng.integers(0, levels, (500, 16)).astype(
        np.float32))
    got_v, got_i = _row_max_tree(v, torch.arange(16).expand(500, 16))
    assert torch.equal(got_v, v.max(1).values)
    assert np.array_equal(got_i.numpy(), np.argmax(v.numpy(), axis=1))


def _unfold(x):
    n, c, q = x.shape
    side = int(round(q ** 0.5))
    return F.unfold(x.reshape(n, c, side, side), 3, padding=1)


def _normalized(u):
    return row_normalize(u, 1).transpose(1, 2).contiguous()


def emulated_texture_match(lr, ref):
    """texture_match with the search emulated as the kernel runs it."""
    n, c, q = lr.shape
    side = int(round(q ** 0.5))
    ref_u = _unfold(ref)
    s, idx = emulated_first_max(emulated_r(_normalized(_unfold(lr)),
                                           _normalized(ref_u)))
    t_u = torch.gather(ref_u, 2, idx[:, None, :].expand(-1, 9 * c, -1))
    t = F.fold(t_u, (side, side), 3, padding=1) / 9.0
    return t.reshape(n, c, q), s


def emulated_patch_match(lr_n, ref_n, ref_u):
    """patch_match with the search emulated as the kernel runs it."""
    s, idx = emulated_first_max(emulated_r(lr_n, ref_n))
    t = torch.gather(ref_u, 2, idx[:, None, :].expand(-1, ref_u.shape[1],
                                                      -1))
    return t, s


def near_ties(lr_n, ref_n):
    """[N, L] bool: queries whose best float64 similarity lies within
    NEAR_TIE of the best value below it (refs tied exactly at the best
    are one value, as chip_smoke.near_ties)."""
    r = torch.bmm(lr_n.double(), ref_n.double().transpose(1, 2))
    best = r.max(dim=2, keepdim=True).values
    below = r.masked_fill(r == best, -torch.inf).max(dim=2).values
    return best[..., 0] - below <= NEAR_TIE


def _patch_images(rng, n, c, side, rims=True):
    """Seeded patch-images [N, C, side^2]; with `rims`, half of them get
    PatchFusion's zero rims (zero sub-patches: exact ties)."""
    x = f32(rng, n, c, side, side)
    if rims:
        x[: n // 2, :, : side // 3] = 0
        x[: n // 2, :, :, : side // 3] = 0
    return x.reshape(n, c, side * side)


def _tm_inputs(side):
    rng = np.random.default_rng(side)
    n = 4 if side < 24 else 2
    return (torch.from_numpy(_patch_images(rng, n, 4, side)),
            torch.from_numpy(_patch_images(rng, n, 4, side)))


def _pm_inputs(side):
    lr, ref = _tm_inputs(side)
    ref_u = _unfold(ref)
    return _normalized(_unfold(lr)), _normalized(ref_u), ref_u


def _footprint(near, side, c):
    """The transferred values a near-tie query may change in texture
    match: its 3x3 fold footprint, [N, C, Q]."""
    n = near.shape[0]
    foot = F.max_pool2d(near.view(n, 1, side, side).float(), 3, stride=1,
                        padding=1) > 0
    return foot.view(n, 1, side * side).expand(n, c, side * side)


@pytest.mark.parametrize("side", [8, 12, 24])
def test_emulated_r_is_fp32_accurate(side):
    """The 3xTF32 R stays within 2e-6 of float64 R (unit vectors: |R| <=
    1), at K = 36 padded to 40."""
    lr_n, ref_n, _ = _pm_inputs(side)
    exact = torch.bmm(lr_n.double(), ref_n.double().transpose(1, 2))
    assert (emulated_r(lr_n, ref_n).double() - exact).abs().max() <= 2e-6


@pytest.mark.parametrize("side", [8, 12, 24])
def test_emulated_texture_match_picks_equal_plain(side):
    """The emulated texture match against texture_match_ref: s within
    2e-6, t bit-equal outside the near ties' fold footprint (the same
    picks, the same fold)."""
    lr, ref = _tm_inputs(side)
    t, s = emulated_texture_match(lr, ref)
    t_want, s_want = texture_match_ref(lr, ref)
    near = near_ties(_normalized(_unfold(lr)), _normalized(_unfold(ref)))
    keep = ~_footprint(near, side, 4)
    assert (s - s_want).abs().max() <= 2e-6
    assert torch.equal(t * keep, t_want * keep)
    assert keep.float().mean() >= 0.95


@pytest.mark.parametrize("side", [8, 12, 24])
def test_emulated_patch_match_picks_equal_plain(side):
    """The emulated patch match against patch_match_ref: s within 2e-6, T
    bit-equal outside the near ties' columns."""
    lr_n, ref_n, ref_u = _pm_inputs(side)
    t, s = emulated_patch_match(lr_n, ref_n, ref_u)
    t_want, s_want = patch_match_ref(lr_n, ref_n, ref_u)
    keep = ~near_ties(lr_n, ref_n)[:, None, :].expand_as(t)
    assert (s - s_want).abs().max() <= 2e-6
    assert torch.equal(t * keep, t_want * keep)
    assert keep.float().mean() >= 0.95


def _tie_case(kind):
    """Inputs with exact ties: a constant ref (every interior sub-patch
    equal), zero rims (zero query sub-patches: R = 0 against every ref),
    every ref row equal."""
    rng = np.random.default_rng(7)
    side, n = 24, 2
    lr = torch.from_numpy(_patch_images(rng, n, 4, side))
    if kind == "constant-ref":
        return "tm", (lr, torch.full((n, 4, side * side), 0.37))
    if kind == "zero-rims":
        return "tm", (lr, torch.from_numpy(_patch_images(rng, n, 4, side)))
    lr_n, ref_n, ref_u = _pm_inputs(side)
    return "pm", (lr_n, ref_n[:, :1].expand_as(ref_n).contiguous(), ref_u)


@pytest.mark.parametrize("kind", ["constant-ref", "zero-rims",
                                  "every-ref-equal"])
def test_emulated_search_exact_on_ties(kind):
    """On exact ties the emulated search takes the first maximum, as the
    plain version: bit-equal outputs (every ref row equal: T = ref_u's
    first column everywhere)."""
    which, args = _tie_case(kind)
    if which == "tm":
        t, s = emulated_texture_match(*args)
        t_want, s_want = texture_match_ref(*args)
    else:
        t, s = emulated_patch_match(*args)
        t_want, s_want = patch_match_ref(*args)
        assert torch.equal(t, args[2][:, :, :1].expand_as(t))
    assert torch.equal(t, t_want)
    assert (s - s_want).abs().max() <= 2e-6


def _jax_outputs(fn, *args):
    return tuple(np.asarray(o) for o in fn(*(jnp.asarray(a.numpy())
                                             for a in args)))


@pytest.mark.parametrize("side", [8, 12, 24])
def test_emulated_texture_match_matches_jax(side):
    """The emulated texture match against texture_match_xla and the
    Pallas kernel in interpret mode: s within 1e-5, t within 2e-4 (the
    Pallas kernel's two-word transfer) outside the near ties' footprint,
    as tests/test_torch_port_innt.py holds the plain version."""
    lr, ref = _tm_inputs(side)
    t, s = (v.numpy() for v in emulated_texture_match(lr, ref))
    near = near_ties(_normalized(_unfold(lr)), _normalized(_unfold(ref)))
    keep = ~_footprint(near, side, 4).numpy()
    for t_want, s_want in (
            _jax_outputs(lambda a, b: texture_match_xla(a, b, side), lr, ref),
            _jax_outputs(lambda a, b: _fused_tm_impl(a, b, interpret=True),
                         lr, ref)):
        np.testing.assert_allclose(s, s_want, atol=1e-5)
        np.testing.assert_allclose(t * keep, t_want * keep, atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("side", [8, 12, 24])
def test_emulated_patch_match_matches_jax(side):
    """The emulated patch match against patch_match_xla and the Pallas
    kernel in interpret mode: S within 1e-5, T within 2e-4 outside the
    near ties' columns."""
    lr_n, ref_n, ref_u = _pm_inputs(side)
    t, s = (v.numpy() for v in emulated_patch_match(lr_n, ref_n, ref_u))
    keep = ~near_ties(lr_n, ref_n)[:, None, :].expand(t.shape).numpy()
    for t_want, s_want in (
            _jax_outputs(patch_match_xla, lr_n, ref_n, ref_u),
            _jax_outputs(lambda a, b, u: _fused_pm_impl(a, b, u,
                                                        interpret=True),
                         lr_n, ref_n, ref_u)):
        np.testing.assert_allclose(s, s_want, atol=1e-5)
        np.testing.assert_allclose(t * keep, t_want * keep, atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("c,side,want", [
    (4, 24, "tc"), (4, 25, "tc"), (4, 26, "fp32"), (1, 1, "tc"),
    (3, 10, "tc"), (5, 8, "fp32"), (8, 8, "fp32"), (8, 24, "fp32")])
def test_texture_match_branch_by_shape(c, side, want):
    """The tensor cores take 9C <= 40 while the staged hi/lo refs
    [search_pad(Q)][40] x 2, the two planes, the norms and the indices
    fit in 232,448 bytes (side 25: 229,800; side 26: 252,320)."""
    assert texture_match_branch(c, side) == want


@pytest.mark.parametrize("k,ll,want", [
    (36, 576, "tc"), (36, 100, "tc"), (1, 1, "tc"), (40, 704, "tc"),
    (40, 705, "fp32"), (41, 64, "fp32"), (72, 576, "fp32")])
def test_patch_match_branch_by_shape(k, ll, want):
    """The tensor cores take K <= 40 while the staged refs and the
    indices fit (L = 704: 228,096 bytes; L = 705 pads to 768: 248,580)."""
    assert patch_match_branch(k, ll) == want


@pytest.mark.parametrize("name", ["texture_match", "patch_match"])
def test_wrapper_on_cpu_counts_no_launch(name):
    """On a CPU tensor each search wrapper is its plain version and counts
    neither a launch nor a branch."""
    wrapper, plain, args = ((texture_match, texture_match_ref,
                             _tm_inputs(8)) if name == "texture_match"
                            else (patch_match, patch_match_ref,
                                  _pm_inputs(8)))
    before = (wrapper.launches, dict(wrapper.variants))
    got, want = wrapper(*args), plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (wrapper.launches, dict(wrapper.variants)) == before
