"""The arithmetic of the tensor-core block tail, on the CPU.

The kernel (`csrc/block_tail.cuh::block_tail_tile_tc`) runs the tail's
four 1x1 products as three TF32 passes (3xTF32) of wgmma: each operand a
= a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), and a.b taken
as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed in FP32. The weights are split
once per weight version (`ops/ffn_kernel.py::tf32_split`) and laid out as
wgmma's K-major core matrices (`tail_fragments`); the activations are
split in the kernel. These tests hold the split, the layout and a torch
emulation of the three passes, so that the card's 1e-4 kernel bound is
not spent on the split: the emulated tail stays within 1e-5 of
`block_tail_ref`.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.models.lgteun_fast import lgteun_fast_forward
from lgteun_tpu.ops.ffn_kernel import block_tail_xla
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.models.common import lgt
from lgteun_tpu_torch.ops import ffn_kernel
from lgteun_tpu_torch.ops.ffn_kernel import (TAIL_MAX_WIDTH, _ffn_shapes,
                                             block_tail_ref, check_tail_args,
                                             ln_ffn_ref, tail_fragments,
                                             tail_variant, tail_weights,
                                             tail_width, tf32_round,
                                             tf32_split)

from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_ops import (_port_ffn, _tail_inputs, f32,  # noqa: E402
                                 max_err)


def _values(rng, n=4096):
    """Unit-scale normals, values over many binades, and edge cases."""
    v = np.concatenate([rng.standard_normal(n),
                        rng.standard_normal(n) * 10.0 ** rng.uniform(
                            -30, 30, n),
                        [0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12,
                         np.float32(np.pi), 3e38, -1e-38]])
    return torch.from_numpy(v.astype(np.float32))


def test_tf32_round_matches_round_half_away():
    """tf32_round is round-to-nearest on 10 explicit mantissa bits, ties
    away from zero (PTX cvt.rna), computed independently in float64."""
    x = _values(np.random.default_rng(0))
    got = tf32_round(x).double()
    xd = x.double()
    e = torch.floor(torch.log2(xd.abs().clamp_min(1e-300)))
    ulp = torch.exp2(e - 10)
    want = torch.sign(xd) * torch.floor(xd.abs() / ulp + 0.5) * ulp
    want[xd == 0] = 0.0
    assert torch.equal(got, want)


def test_tf32_split_bounds():
    """hi has its low 13 mantissa bits zero, |lo| <= 2^-11 |w| (and lo
    is a TF32 value too), |w - (hi + lo)| <= 2^-21 |w| (for |w| >=
    2^-100, where lo is no subnormal; weights are far above that)."""
    w = _values(np.random.default_rng(1))
    w = w[(w.abs() >= 2.0 ** -100) | (w == 0)]
    hi, lo = tf32_split(w)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    wd, hd, ld = w.double(), hi.double(), lo.double()
    assert (ld.abs() <= 2.0 ** -11 * wd.abs()).all()
    assert ((wd - hd - ld).abs() <= 2.0 ** -21 * wd.abs()).all()


def _reference_fragments(w, n_pad, k_pad, cp):
    """The kernel's weight slabs spelled out element by element: per
    chunk of cp output channels and slab of 32 input channels, hi then
    lo, each a K-major wgmma operand without swizzle (PTX ISA, matrix
    descriptor): B[k][n] = w[n][k] at byte (n // 8) * 1024 + (k // 4) *
    128 + (n % 8) * 16 + (k % 4) * 4, i.e. core matrices of 8 rows x 16
    bytes, LBO 128 bytes along K, SBO 1024 bytes along N."""
    wp = np.zeros((n_pad, k_pad), np.float32)
    wp[:w.shape[0], :w.shape[1]] = w
    hi, lo = (p.numpy() for p in tf32_split(torch.from_numpy(wp)))
    out = np.full(2 * n_pad * k_pad, np.nan, np.float32)
    for n in range(n_pad):
        for k in range(k_pad):
            (chunk, nn), (slab, kk) = divmod(n, cp), divmod(k, 32)
            base = (chunk * (k_pad // 32) + slab) * 2 * cp * 32
            off = ((nn // 8) * 1024 + (kk // 4) * 128 + (nn % 8) * 16
                   + (kk % 4) * 4) // 4
            out[base + off], out[base + cp * 32 + off] = hi[n, k], lo[n, k]
    return out


@pytest.mark.parametrize("c", [4, 12, 32, 40, 96])
def test_fragment_layout_is_the_mma_b_fragment(c):
    """tail_fragments of each tail matrix of a C-channel block (proj C x
    C, W1 4C x C, W2 4C x 4C, W3 C x 4C) equals the element-by-element
    core-matrix order of wgmma's B operand, zero-padded to the kernel's
    width, with every position written."""
    rng = np.random.default_rng(2)
    cp = tail_width(c)
    for n, k in ((c, c), (4 * c, c), (4 * c, 4 * c), (c, 4 * c)):
        w = f32(rng, n, k)
        got = tail_fragments(torch.from_numpy(w), n // c * cp, k // c * cp,
                             cp).numpy()
        assert np.array_equal(got, _reference_fragments(
            w, n // c * cp, k // c * cp, cp))


def _unpack(frag, n_pad, k_pad, cp):
    """tail_fragments' inverse: (hi, lo) as [n_pad, k_pad]."""
    t = frag.view(n_pad // cp, k_pad // 32, 2, cp // 8, 8, 8, 4)
    t = t.permute(2, 0, 3, 5, 1, 4, 6).reshape(2, n_pad, k_pad)
    return t[0], t[1]


@pytest.mark.parametrize("c", [32, 64, 128])
def test_fragment_layout_round_trips(c):
    """Unpacking the fragments gives tf32_split of w back, hi + lo = w
    within 2^-21, and zeros in the padding."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(f32(rng, 4 * c, 4 * c))
    cp = tail_width(c)
    hi, lo = _unpack(tail_fragments(w, 4 * cp, 4 * cp, cp), 4 * cp, 4 * cp,
                     cp)
    want_hi, want_lo = tf32_split(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert ((hi + lo).double() - w.double()).abs().max() <= \
        2.0 ** -21 * w.abs().max()
    w12 = torch.from_numpy(f32(rng, 48, 12))
    hi, lo = _unpack(tail_fragments(w12, 128, 32, 32), 128, 32, 32)
    assert torch.equal(hi[:48, :12], tf32_round(w12))
    assert not hi[48:].any() and not hi[:, 12:].any() and not lo[48:].any()


@pytest.mark.parametrize("c", [68, 96, 128])
def test_tail_takes_blocks_wider_than_the_tile(c):
    """C.31: above 64 channels the shared-memory tile's h1 does not fit,
    and the wrapper's check passes the shape on to the wide tile (h1 in
    a global scratch slot, padded to 128 channels), while C <= 64 keeps
    the tile; above TAIL_MAX_WIDTH (and for C % 4 != 0) the check still
    refuses before any launch."""
    def check(ch):
        x = torch.zeros(1, ch, 8, 8)
        ffn = {k: torch.zeros(s) for k, s in _ffn_shapes(ch, 4 * ch).items()}
        check_tail_args("block_tail", x, ffn, _ffn_shapes(ch, 4 * ch))

    check(c)
    assert tail_variant(c) == "wide" and tail_width(c) == TAIL_MAX_WIDTH
    for ok in (12, 60, 64):
        check(ok)
        assert tail_variant(ok) == "tile" and tail_width(ok) in (32, 64)
    for bad in (c + 2, TAIL_MAX_WIDTH + 4):
        with pytest.raises(ValueError, match=f"C <= {TAIL_MAX_WIDTH}"):
            check(bad)


def tf32x3_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [P, K] . w[N, K]^T as the kernel computes it: three TF32 passes,
    each product exact, summed in float32."""
    ah, al = tf32_split(a)
    wh, wl = tf32_split(w)
    return al @ wh.t() + ah @ wl.t() + ah @ wh.t()


@pytest.mark.parametrize("c", [32, 64])
def test_tf32x3_product_is_fp32_accurate(c):
    """At the tail's shapes (C and hidden 4C; 100 halo pixels of an 8x8
    tile) the 3-pass product stays within 2e-6 of float64, relative to
    the largest output; one TF32 pass would be about 1e-3 off."""
    rng = np.random.default_rng(4)
    for n, k in ((c, c), (4 * c, c), (4 * c, 4 * c), (c, 4 * c)):
        a = torch.from_numpy(f32(rng, 100, k))
        w = torch.from_numpy(f32(rng, n, k, scale=k ** -0.5))
        want = a.double() @ w.double().t()
        scale = want.abs().max()
        err = (tf32x3_matmul(a, w).double() - want).abs().max() / scale
        one = (tf32_round(a) @ tf32_round(w).t()).double()
        assert err <= 2e-6
        assert (one - want).abs().max() / scale > 1e-4


def _pw_tf32x3(t, wt, bias):
    """ffn_kernel._pw (a 1x1 conv) through tf32x3_matmul."""
    b, k, h, w = t.shape
    y = tf32x3_matmul(t.permute(0, 2, 3, 1).reshape(-1, k), wt) + bias
    return y.view(b, h, w, -1).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(2, 32, 16, 16), (1, 64, 8, 16),
                                   (1, 96, 8, 16)])
def test_tail_through_tf32x3_matches_plain_and_jax(shape, monkeypatch):
    """block_tail_ref and ln_ffn_ref with every 1x1 product through the
    3-pass emulation stay within 1e-5 of the plain float32 versions, and
    the emulated tail within 1e-4 of the JAX package's block_tail_xla
    (the bound tests/test_torch_port_ops.py holds the plain tail to)."""
    x, x1, x2, proj, pb, ffn = _tail_inputs(np.random.default_rng(5), shape)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(x), t(x1), t(x2), t(proj.T), t(pb), _port_ffn(ffn))
    plain_tail, plain_ffn = block_tail_ref(*args), ln_ffn_ref(args[0],
                                                              args[5])
    monkeypatch.setattr(ffn_kernel, "_pw", _pw_tf32x3)
    emu_tail, emu_ffn = block_tail_ref(*args), ln_ffn_ref(args[0], args[5])
    scale = plain_tail.abs().max()
    assert (emu_tail - plain_tail).abs().max() / scale <= 1e-5
    assert (emu_ffn - plain_ffn).abs().max() / plain_ffn.abs().max() <= 1e-5
    jffn = {k: jnp.asarray(v) for k, v in ffn.items()}
    want = block_tail_xla(*(jnp.asarray(a) for a in (x, x1, x2, proj, pb)),
                          jffn)
    assert max_err(emu_tail.numpy(), want) <= 1e-4


def test_tail_weights_cached_per_weight_version():
    """The kernel's fragments are made once per weight version: the same
    tensor while the weights stay, a new one after an in-place update."""
    c = 32
    ffn = {"ln_w": torch.ones(c), "ln_b": torch.zeros(c),
           "w1": torch.randn(4 * c, c), "b1": torch.zeros(4 * c),
           "w2": torch.randn(4 * c, 4 * c), "b2": torch.zeros(4 * c),
           "dw": torch.randn(4 * c, 3, 3), "bdw": torch.zeros(4 * c),
           "w3": torch.randn(c, 4 * c), "b3": torch.zeros(c)}
    first = tail_weights(ffn)
    assert all(a is b for a, b in zip(first, tail_weights(ffn)))
    assert first[2].numel() == 2 * 4 * c * c
    with torch.no_grad():
        ffn["w2"].mul_(2)
    again = tail_weights(ffn)
    assert again[4] is not first[4] and again[2] is first[2]
    assert torch.equal(again[4], tail_fragments(ffn["w2"], 128, 128, 32))


@pytest.fixture(scope="module")
def sixteen_bands():
    """A 16-band UnlgFormer's weights (embed 64: blocks of C = 64 at full
    resolution and C = 128 at the bottleneck), a small batch and JAX
    lgteun_fast_forward's output on the CPU."""
    tree = flax_params(16, seed=6)
    rng = np.random.default_rng(31)
    batch = {"input_lr": rng.uniform(0, 1, (1, 8, 8, 16)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (1, 32, 32, 1)).astype(
                 np.float32)}
    want = jax.jit(lambda p, ms, pan: lgteun_fast_forward(p, ms, pan,
                                                          stage=2))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["input_lr"]),
        jnp.asarray(batch["input_pan"]))
    return tree, batch, np.asarray(want)


@pytest.mark.parametrize("level,entry", [(1, "ln_ffn"), (2, "block_tail"),
                                         (3, "lgb_block")])
def test_sixteen_band_unlgformer_matches_jax(level, entry, monkeypatch,
                                             sixteen_bands):
    """C.31's model: a 16-band UnlgFormer, whose bottleneck block has C =
    128, through each fuse level's plain path vs the JAX package's XLA
    forward, within the port's 5e-4 max-abs; the level's tail entry sees
    C = 64 and 128."""
    tree, batch, want = sixteen_bands
    monkeypatch.setenv("LGTEUN_FUSE_LEVEL", str(level))
    port = build_model("UnlgFormer", Config(
        ms_chans=16, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    widths = set()
    fn = getattr(lgt, entry)

    def spy(x, *args, **kw):
        widths.add(x.shape[1])
        return fn(x, *args, **kw)

    monkeypatch.setattr(lgt, entry, spy)
    got = port.apply(batch).numpy()
    assert widths == {64, 128}
    assert got.shape == want.shape and np.isfinite(got).all()
    assert max_err(got, want) <= 5e-4
