"""The LGB block's other engines in the port (plain PyTorch path, CPU)
vs the JAX package: the global mixer alone (B4), x + FFN(LN(x)) (B5),
the whole block (B8), the mixer head at the scene engine's sizes, and
the `LGTEUN_FUSE_LEVEL` routing of `LGB.forward`.

Inputs are made with numpy from a seed and cast to float32 (conftest
turns on jax_enable_x64). Tolerances: 3e-5 max-abs against the XLA
references (the bound tests/test_lgb_block_kernel.py holds the Pallas
block to), 1e-4 against the Pallas kernels in interpret mode (their
tanh-form erf GELU and matmul DFT add about 1e-6 each).

The phase of a self-conjugate bin (real by symmetry) is +pi in the port
when its real part is negative (ROADMAP C.9); the XLA FFT on the CPU
leaves rounding noise in the imaginary part there, so its phase may be
-pi, and the learned phase scale turns that 2*pi into a value change.
The comparisons with the XLA references therefore use integer phase
scales, under which the two phases give the same values; the Pallas
kernels (snapped DFT matrices, exactly real self-conjugate bins) are
held with random ones. The CUDA kernels are held against these plain
versions on the card by `chip_smoke.py`.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.models.lgteun_fast import lgteun_fast_forward
from lgteun_tpu.ops.ffn_kernel import fused_ln_ffn_cm, ln_ffn_xla
from lgteun_tpu.ops.lgb_block_kernel import (fused_lgb_block_cm,
                                             lgb_block_xla_cm)
from lgteun_tpu.ops.spectral_kernel import (fused_global_mixer_cm,
                                            fused_ln_mixer_head_cm,
                                            global_mixer_xla_cm,
                                            ln_mixer_head_xla_cm)
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.models.common import lgt
from lgteun_tpu_torch.ops import fuse_level
from lgteun_tpu_torch.ops.ffn_kernel import ln_ffn, ln_ffn_ref
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block, lgb_block_ref
from lgteun_tpu_torch.ops.spectral_kernel import (_check_plane,
                                                  global_mixer,
                                                  global_mixer_ref,
                                                  ln_mixer_head_ref)
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_ops import _port_ffn, f32, max_err  # noqa: E402


def _mixer_params(rng, c, integer_phase=False):
    """amp_w, amp_b, pha_w, pha_b [c]; pha_w in {-2, -1, 1, 2} with
    `integer_phase` (module docstring)."""
    pha_w = (rng.choice([-2.0, -1.0, 1.0, 2.0], c) if integer_phase
             else rng.standard_normal(c))
    return [f32(rng, c), 0.1 * f32(rng, c), pha_w.astype(np.float32),
            0.1 * f32(rng, c)]


@pytest.mark.parametrize("shape", [(2, 8, 72, 72), (1, 8, 144, 144),
                                   (1, 4, 40, 56)])
def test_global_mixer_matches_jax(shape):
    """Plain mixer vs the Pallas mixer (interpret, native trig; a matmul
    DFT) and global_mixer_xla_cm (pocketfft on both sides)."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(f32(rng, *shape))
    for integer_phase, tol in ((False, 1e-4), (True, 3e-5)):
        params = _mixer_params(rng, shape[1], integer_phase)
        got = global_mixer_ref(x, *map(torch.from_numpy, params)).numpy()
        jx = [jnp.asarray(a) for a in [x.numpy()] + params]
        want = (global_mixer_xla_cm(*jx) if integer_phase else
                fused_global_mixer_cm(*jx, interpret=True, trig="native"))
        assert max_err(got, want) <= tol


@pytest.mark.parametrize("shape", [(2, 8, 72, 72), (1, 4, 144, 144)])
def test_global_mixer_constant_planes(shape):
    """Every plane constant: all bins but DC are exactly zero in
    pocketfft at 2^a * 3^b sizes, which takes the zero-bin path (amp =
    pha = 0, so amp' = amp_b, pha' = pha_b) there. Held against the XLA
    reference (3e-5) and a float64 numpy oracle of the closed form. The
    Pallas kernel's matmul DFT leaves rounding noise in those bins (not
    exactly zero), so it takes another branch there and is not a
    reference for this case; the CUDA kernel keeps them exactly zero at
    any size (csrc/fft_mixer.cuh)."""
    b, c, h, w = shape
    rng = np.random.default_rng(22)
    level = rng.uniform(-2, 2, c).astype(np.float32)
    x = np.broadcast_to(level[None, :, None, None], shape).astype(np.float32)
    params = _mixer_params(rng, c)
    got = global_mixer_ref(torch.from_numpy(x),
                           *map(torch.from_numpy, params)).numpy()
    want = global_mixer_xla_cm(*(jnp.asarray(a) for a in [x] + params))
    assert max_err(got, want) <= 3e-5
    aw, ab, pw, pb = (p.astype(np.float64) for p in params)
    spec = np.zeros((c, h, w // 2 + 1), np.complex128)
    dc = level.astype(np.float64) * h * w
    amp = np.where(dc == 0, 0.0, np.abs(dc)) * aw + ab
    pha = np.where(dc < 0, np.pi, 0.0) * pw + pb
    spec[:] = (ab * np.cos(pb) + 2e-8 + 1j * (ab * np.sin(pb) + 1e-8))[
        :, None, None]
    spec[:, 0, 0] = amp * np.cos(pha) + 2e-8 + 1j * (amp * np.sin(pha)
                                                     + 1e-8)
    oracle = np.abs(np.fft.irfft2(spec, s=(h, w)))
    assert max_err(got[0], oracle) <= 1e-5 * float(np.max(oracle))


@pytest.mark.parametrize("shape", [(1, 8, 144, 144), (2, 16, 72, 72)])
def test_ln_mixer_head_at_scene_sizes(shape):
    """The mixer head at the LGB sizes of a 144-pixel tile (144^2 and
    the 72^2 bottleneck) vs the Pallas head (interpret mode, 1e-4) and
    its XLA reference (3e-5); y1 is elementwise (1e-5)."""
    b, c, h, w = shape
    rng = np.random.default_rng(23)
    x = f32(rng, *shape)
    ln = [(1 + 0.1 * f32(rng, c)).astype(np.float32), 0.1 * f32(rng, c)]
    for integer_phase, tol in ((False, 1e-4), (True, 3e-5)):
        params = ln + _mixer_params(rng, c // 2, integer_phase)
        got_y1, got_x2 = ln_mixer_head_ref(torch.from_numpy(x),
                                           *map(torch.from_numpy, params))
        jx = [jnp.asarray(a) for a in [x] + params]
        want_y1, want_x2 = (
            ln_mixer_head_xla_cm(*jx) if integer_phase else
            fused_ln_mixer_head_cm(*jx, interpret=True, trig="native"))
        assert max_err(got_y1, want_y1) <= 1e-5
        assert max_err(got_x2, want_x2) <= tol


def _ffn_inputs(rng, c):
    c4 = 4 * c
    ffn = {"ln_gamma": 1 + 0.1 * f32(rng, c), "ln_beta": 0.1 * f32(rng, c),
           "w1": f32(rng, c, c4, scale=c ** -0.5), "b1": 0.1 * f32(rng, c4),
           "w2": f32(rng, c4, c4, scale=c4 ** -0.5),
           "b2": 0.1 * f32(rng, c4), "dw": f32(rng, 3, 3, c4, scale=1 / 3),
           "bdw": 0.1 * f32(rng, c4), "w3": f32(rng, c4, c, scale=c4 ** -0.5),
           "b3": 0.1 * f32(rng, c)}
    return {k: v.astype(np.float32) for k, v in ffn.items()}


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (1, 32, 24, 24)])
def test_ln_ffn_matches_jax(shape):
    """x + FFN(LN(x)) vs ln_ffn_xla (3e-5) and the Pallas FFN kernel
    fused_ln_ffn_cm (interpret on the CPU, 1e-4: its GELU is the
    tanh-form erf). Exact-erf GELU and LN eps 1e-5 in the port."""
    rng = np.random.default_rng(24)
    x, ffn = f32(rng, *shape), _ffn_inputs(rng, shape[1])
    got = ln_ffn_ref(torch.from_numpy(x), _port_ffn(ffn)).numpy()
    jffn = {k: jnp.asarray(v) for k, v in ffn.items()}
    want_xla = jnp.moveaxis(ln_ffn_xla(jnp.moveaxis(jnp.asarray(x), 1, -1),
                                       jffn), -1, 1)
    assert max_err(got, want_xla) <= 3e-5
    assert max_err(got, fused_ln_ffn_cm(jnp.asarray(x), jffn)) <= 1e-4


def _jax_blk(rng, c, heads=2, win=8):
    """A block's weights in the layout of `lgb_block_xla_cm` (integer
    phase scales: module docstring)."""
    c2, c4 = c // 2, 4 * c
    s = win * win
    return {
        "norm": {"scale": 1 + 0.1 * f32(rng, c), "bias": 0.1 * f32(rng, c)},
        "local": {"to_qkv_kernel": f32(rng, 1, 1, c2, 3 * c2,
                                       scale=c2 ** -0.5),
                  "to_qkv_bias": 0.1 * f32(rng, 3 * c2),
                  "pos_emb": f32(rng, heads, s, s)},
        "global": {"amp_scale": f32(rng, 1, 1, 1, c2),
                   "amp_bias": 0.1 * f32(rng, c2),
                   "pha_scale": rng.choice([-2.0, -1.0, 1.0, 2.0], (
                       1, 1, 1, c2)).astype(np.float32),
                   "pha_bias": 0.1 * f32(rng, c2)},
        "proj": {"Conv_0": {"Conv_0": {"kernel": f32(rng, 1, 1, c, c,
                                                     scale=c ** -0.5),
                                       "bias": 0.1 * f32(rng, c)}}},
        "ffn": _ffn_inputs(rng, c),
    }


def _port_blk(blk):
    """`_jax_blk` -> the port's `blk` (torch layouts)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    g, loc = blk["global"], blk["local"]
    conv = blk["proj"]["Conv_0"]["Conv_0"]
    return {"ln_w": t(blk["norm"]["scale"]), "ln_b": t(blk["norm"]["bias"]),
            "amp_w": t(g["amp_scale"][0, 0, 0]), "amp_b": t(g["amp_bias"]),
            "pha_w": t(g["pha_scale"][0, 0, 0]), "pha_b": t(g["pha_bias"]),
            "wqkv": t(loc["to_qkv_kernel"][0, 0].T),
            "bqkv": t(loc["to_qkv_bias"]), "pos": t(loc["pos_emb"]),
            "proj_w": t(conv["kernel"][0, 0].T), "proj_b": t(conv["bias"]),
            "ffn": _port_ffn(blk["ffn"])}


def test_lgb_block_matches_jax():
    """Plain block (head -> window attention -> tail) vs
    lgb_block_xla_cm (3e-5) and the Pallas block kernel in interpret
    mode with native trig and plain exp (1e-4: tanh-form erf GELU)."""
    rng = np.random.default_rng(25)
    x, blk = f32(rng, 1, 16, 16, 128), _jax_blk(rng, 16)
    got = lgb_block_ref(torch.from_numpy(x), _port_blk(blk)).numpy()
    jblk = jax.tree.map(jnp.asarray, blk)
    assert max_err(got, lgb_block_xla_cm(jnp.asarray(x), jblk)) <= 3e-5
    want = fused_lgb_block_cm(jnp.asarray(x), jblk, interpret=True,
                              trig="native", tanh_exp=False)
    assert max_err(got, want) <= 1e-4


def test_new_wrappers_run_plain_version_on_cpu():
    """On a CPU tensor `global_mixer`, `ln_ffn` and `lgb_block` are
    their plain versions (the same values) and count no launch; a
    tensor neither on the CPU nor on a CUDA device is refused."""
    rng = np.random.default_rng(26)
    wrappers = (global_mixer, ln_ffn, lgb_block)
    before = [fn.launches for fn in wrappers]
    x = torch.from_numpy(f32(rng, 1, 8, 16, 24))
    p = [torch.from_numpy(v) for v in _mixer_params(rng, 8)]
    assert torch.equal(global_mixer(x, *p), global_mixer_ref(x, *p))
    ffn = _port_ffn(_ffn_inputs(rng, 8))
    assert torch.equal(ln_ffn(x, ffn), ln_ffn_ref(x, ffn))
    blk = _port_blk(_jax_blk(rng, 8))
    assert torch.equal(lgb_block(x, blk), lgb_block_ref(x, blk))
    assert [fn.launches for fn in wrappers] == before
    meta = x.to("meta")
    for call in (lambda: global_mixer(meta, *p), lambda: ln_ffn(meta, ffn),
                 lambda: lgb_block(meta, blk)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("shape,ok", [((1, 4, 168, 168), True),
                                      ((1, 4, 144, 144), True),
                                      ((1, 4, 72, 80), True),
                                      ((1, 4, 176, 176), True),
                                      ((1, 4, 240, 240), True),
                                      ((1, 4, 248, 248), True),
                                      ((1, 4, 72, 71), True),
                                      ((1, 4, 8, 8208), True),
                                      ((1, 4, 2062, 2062), True),
                                      ((1, 4, 1042, 16), True),
                                      ((1, 4, 16, 2 * 2 * 523), True),
                                      ((1, 4, 14515, 2), False),
                                      ((1, 4, 2, 29028), False),
                                      ((1, 4, 3, 14515), False),
                                      ((1, 4, 1, 16), False)])
def test_mixer_kernel_size_limit(shape, ok):
    """The card's mixer takes every H from 2 to 14,514 and W from 2 to
    29,026 (odd W to 14,513) at any factorization: where the plan and
    half spectrum H x (W/2 + 1, rounded up to odd; odd W: W) fit one
    block's 232,448 bytes of shared memory (240^2) in one block, above
    that (248^2, 8 x 8208) on a cluster or its global route, odd sides
    (72 x 71) and odd primes above 512 (1031, 521, 523) through the line
    buffer; it raises naming those limits beyond them."""
    x = torch.empty(shape, device="meta")
    if ok:
        _check_plane("global_mixer", x)
    else:
        with pytest.raises(ValueError, match=r"2 <= H <= 14514 and 2 <= W "
                                             r"<= 29026 \(odd W <= "
                                             r"14513\)"):
            _check_plane("global_mixer", x)


# launches per UnlgFormer forward at K = 2: 4 full-res blocks + 1
# bottleneck block, each through the level's entries
ROUTES = {1: {"window_attention": 5, "global_mixer": 5, "ln_ffn": 5},
          2: {"ln_mixer_head": 5, "window_attention": 5, "block_tail": 5},
          3: {"lgb_block": 5}}
ENTRIES = ("ln_mixer_head", "window_attention", "block_tail",
           "global_mixer", "ln_ffn", "lgb_block")


def _unlgformer(level, monkeypatch, tree):
    monkeypatch.setenv("LGTEUN_FUSE_LEVEL", str(level))
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    return port


@pytest.mark.parametrize("level,route", [(0, 2), (1, 1), (2, 2), (3, 3)])
def test_fuse_level_routing(level, route, monkeypatch):
    """Each level's forward calls exactly its entries, 5 times each (the
    table of `ops.fuse_level`); level 0 reads as 2, so a card never runs
    a plain composition. The level is read when the method is built."""
    port = _unlgformer(level, monkeypatch, flax_params(4))
    monkeypatch.delenv("LGTEUN_FUSE_LEVEL")
    assert fuse_level() == 2
    calls = dict.fromkeys(ENTRIES, 0)

    def spy(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    for name in ENTRIES:
        monkeypatch.setattr(lgt, name, spy(name, getattr(lgt, name)))
    rng = np.random.default_rng(27)
    port.apply({"input_lr": rng.uniform(0, 1, (1, 8, 8, 4)),
                "input_pan": rng.uniform(0, 1, (1, 32, 32, 1))})
    assert calls == {k: ROUTES[route].get(k, 0) for k in ENTRIES}


@pytest.mark.parametrize("env,level", [("7", 7), ("", 2), ("x", 2),
                                       ("1", 1), ("0", 2), ("-1", 2)])
def test_fuse_level_parse(env, level, monkeypatch):
    """The JAX package's parse (an int, default 2, unparsable -> 2), and
    below 1 -> 2."""
    monkeypatch.setenv("LGTEUN_FUSE_LEVEL", env)
    assert fuse_level() == level


def test_lgb_views_follow_weights():
    """LGB keeps each block's weight views from the first forward with
    gradients off: an in-place load shows through them, a load with
    assign=True, a dtype change or a copy of the module remakes them,
    and with gradients on they are made anew (autograd reaches the
    parameters)."""
    torch.manual_seed(0)
    fresh = lambda: lgt.LGB(16, 2, level=2).apply(
        lambda m: m.reset_from(torch.Generator().manual_seed(1))
        if isinstance(m, lgt.LocalMixer) else None)
    m, other = fresh(), fresh()
    with torch.no_grad():
        for p in other.parameters():
            p.normal_(0, 0.1)
    x = torch.from_numpy(f32(np.random.default_rng(29), 1, 16, 16, 16))
    with torch.no_grad():
        want = other(x)
        m(x)
        assert len(m._views) == 2
        m.load_state_dict(other.state_dict())
        assert torch.equal(m(x), want)
        m.load_state_dict(fresh().state_dict(), assign=True)
        assert not m._views
        m.load_state_dict(other.state_dict())
        m(x)
        copied = copy.deepcopy(m)
        assert not copied._views and torch.equal(copied(x), want)
        m.double()
        assert not m._views
        assert max_err(m(x.double()).float().numpy(), want.numpy()) <= 1e-5
    m.float()
    m(x).sum().backward()
    assert all(p.grad is not None for p in m.parameters())


@pytest.fixture(scope="module")
def unlgformer_case():
    """Weights, a batch and JAX lgteun_fast_forward's output (all levels
    are plain XLA on the CPU)."""
    tree = flax_params(4, seed=3)
    rng = np.random.default_rng(28)
    batch = {"input_lr": rng.uniform(0, 1, (2, 8, 8, 4)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (2, 32, 32, 1)).astype(
                 np.float32)}
    want = jax.jit(lambda p, ms, pan: lgteun_fast_forward(p, ms, pan,
                                                          stage=2))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["input_lr"]),
        jnp.asarray(batch["input_pan"]))
    return tree, batch, np.asarray(want)


@pytest.mark.parametrize("level", sorted(ROUTES))
def test_unlgformer_each_level_matches_jax(level, monkeypatch,
                                           unlgformer_case):
    """UnlgFormer's forward at each fuse level vs JAX
    lgteun_fast_forward on the CPU, within the port's 5e-4 max-abs."""
    tree, batch, want = unlgformer_case
    got = _unlgformer(level, monkeypatch, tree).apply(batch).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert max_err(got, want) <= 5e-4
