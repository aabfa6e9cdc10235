"""Port kernel modules (plain PyTorch path, CPU) vs the JAX package.

Each port op's plain version takes the same float32 inputs (made with
numpy from a seed) as its JAX counterpart: the Pallas kernel in
interpret mode and its XLA reference. The CUDA kernels themselves are
held against these plain versions on the card by `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lgteun_tpu.models import lgteun_fast
from lgteun_tpu.ops.ffn_kernel import block_tail_xla, fused_block_tail_cm
from lgteun_tpu.ops.resize import sample_scale_cm
from lgteun_tpu.ops.spectral_kernel import (fused_ln_mixer_head_cm,
                                            ln_mixer_head_xla_cm)
from lgteun_tpu.ops.window_attention import (
    fused_window_attention_v3_packed, window_attention_xla)
from lgteun_tpu_torch.ops.ffn_kernel import (_in_out, block_tail,
                                             block_tail_ref)
from lgteun_tpu_torch.ops.resize import sample_scale
from lgteun_tpu_torch.ops.spectral_kernel import (ln_mixer_head,
                                                  ln_mixer_head_ref)
from lgteun_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_ref)


def f32(rng, *shape, scale=1.0):
    """float32 explicitly: conftest turns on jax_enable_x64."""
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


@pytest.mark.parametrize("size,factor", [(32, 4), (32, 2), (64, 2),
                                         (128, 0.5), (64, 0.5)])
def test_sample_scale_matches_jax(size, factor):
    """F.interpolate(bicubic, align_corners=False) vs the JAX resize
    matrices at the model's resamples: the same 4-tap weights summed in
    another order, so f32 rounding only (<= 1e-6 at unit-scale inputs)."""
    x = f32(np.random.default_rng(1), 2, 3, size, size)
    want = np.asarray(sample_scale_cm(jnp.asarray(x), factor))
    got = sample_scale(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape
    assert max_err(got, want) <= 1e-6


def _head_inputs(rng, shape, zero=False):
    b, c, h, w = shape
    c2 = c // 2
    x = np.zeros(shape, np.float32) if zero else f32(rng, *shape)
    params = [(1 + 0.1 * f32(rng, c)).astype(np.float32),
              np.zeros(c, np.float32) if zero else 0.1 * f32(rng, c),
              f32(rng, c2), 0.1 * f32(rng, c2), f32(rng, c2),
              0.1 * f32(rng, c2)]
    return x, params


@pytest.mark.parametrize("shape,zero", [((1, 8, 16, 128), False),
                                        ((2, 16, 32, 32), False),
                                        ((1, 8, 16, 16), True)])
def test_ln_mixer_head_matches_jax(shape, zero):
    """Plain mixer head vs the Pallas head kernel (interpret mode) and
    its XLA reference. y1 is elementwise (<= 1e-5). x2: torch.fft and
    the kernel's matmul DFT sum H*W terms in different orders, so the
    bound is relative to the output's scale: <= 1e-5 * max|ref|.
    `zero`: x = 0 and LN bias = 0 make every frequency bin exactly zero,
    which takes the zero-bin path (amp = pha = 0) everywhere."""
    x, params = _head_inputs(np.random.default_rng(2), shape, zero)
    got_y1, got_x2 = ln_mixer_head_ref(torch.from_numpy(x),
                                       *map(torch.from_numpy, params))
    jx = [jnp.asarray(p) for p in [x] + params]
    for want_y1, want_x2 in (fused_ln_mixer_head_cm(*jx, interpret=True),
                             ln_mixer_head_xla_cm(*jx)):
        assert max_err(got_y1, want_y1) <= 1e-5
        scale = float(np.max(np.abs(want_x2)))
        assert max_err(got_x2, want_x2) <= 1e-5 * scale, scale


def _attn_inputs(rng, shape, heads=2, win=8):
    b, c, h, w = shape
    s = win * win
    return (f32(rng, *shape), f32(rng, c, 3 * c, scale=c ** -0.5),
            0.1 * f32(rng, 3 * c), f32(rng, heads, s, s))


@pytest.mark.parametrize("shape", [(2, 8, 16, 32), (1, 16, 32, 32)])
def test_window_attention_matches_jax(shape):
    """Plain window attention vs the packed v3 Pallas kernel (interpret,
    plain exp) and window_attention_xla: f32 softmax and matmuls in
    different orders, <= 1e-5 at unit-scale inputs."""
    heads, win = 2, 8
    b, c, h, w = shape
    x, wqkv, bqkv, pos = _attn_inputs(np.random.default_rng(3), shape)
    scale = (c // heads) ** -0.5
    got = window_attention_ref(torch.from_numpy(x),
                               torch.from_numpy(np.ascontiguousarray(wqkv.T)),
                               torch.from_numpy(bqkv), torch.from_numpy(pos),
                               heads, win).numpy()
    xp = lgteun_fast._window_pairs_cm(jnp.asarray(x), win)
    packed = fused_window_attention_v3_packed(
        xp, jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(pos),
        heads=heads, scale=scale, interpret=True, tanh_exp=False)
    want_kernel = lgteun_fast._unwindow_pairs_cm(packed, win, (h, w), b)
    xt = lgteun_fast._windows_cm(jnp.asarray(x), win).transpose(0, 2, 1)
    xla = window_attention_xla(xt, jnp.asarray(wqkv), jnp.asarray(bqkv),
                               jnp.asarray(pos), heads, scale)
    want_xla = lgteun_fast._unwindows_cm(xla.transpose(0, 2, 1), win,
                                         (h, w), b)
    assert max_err(got, want_kernel) <= 1e-5
    assert max_err(got, want_xla) <= 1e-5


def _tail_inputs(rng, shape):
    b, c, h, w = shape
    c4 = 4 * c
    x = f32(rng, *shape)
    x1, x2 = f32(rng, b, c // 2, h, w), f32(rng, b, c // 2, h, w)
    proj = f32(rng, c, c, scale=c ** -0.5)          # [in, out] (JAX)
    ffn = {"ln_gamma": 1 + 0.1 * f32(rng, c), "ln_beta": 0.1 * f32(rng, c),
           "w1": f32(rng, c, c4, scale=c ** -0.5), "b1": 0.1 * f32(rng, c4),
           "w2": f32(rng, c4, c4, scale=c4 ** -0.5), "b2": 0.1 * f32(rng, c4),
           "dw": f32(rng, 3, 3, c4, scale=1 / 3), "bdw": 0.1 * f32(rng, c4),
           "w3": f32(rng, c4, c, scale=c4 ** -0.5), "b3": 0.1 * f32(rng, c)}
    ffn = {k: v.astype(np.float32) for k, v in ffn.items()}
    return x, x1, x2, proj, 0.1 * f32(rng, c), ffn


def _port_ffn(ffn):
    """JAX flat FFN params -> the port's torch-layout dict."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return {"ln_w": t(ffn["ln_gamma"]), "ln_b": t(ffn["ln_beta"]),
            "w1": t(ffn["w1"].T), "b1": t(ffn["b1"]),
            "w2": t(ffn["w2"].T), "b2": t(ffn["b2"]),
            "dw": t(ffn["dw"].transpose(2, 0, 1)), "bdw": t(ffn["bdw"]),
            "w3": t(ffn["w3"].T), "b3": t(ffn["b3"])}


@pytest.mark.parametrize("shape,tile_rows", [((1, 8, 16, 128), 8),
                                             ((2, 16, 32, 32), 32)])
def test_block_tail_matches_jax(shape, tile_rows):
    """Plain block tail vs the Pallas tail kernel in interpret mode
    ([1,8,16,128] with tile_rows=8 takes the row-tiled `_tail_kernel`;
    [2,16,32,32] the whole-image `_tail_kernel_rolls`) and
    block_tail_xla: <= 1e-4 at unit-scale inputs (the kernel's GELU is
    the tanh-form erf, 1.5e-7, plus f32 matmul order)."""
    x, x1, x2, proj, pb, ffn = _tail_inputs(np.random.default_rng(4), shape)
    got = block_tail_ref(*map(torch.from_numpy, (x, x1, x2)),
                         torch.from_numpy(np.ascontiguousarray(proj.T)),
                         torch.from_numpy(pb), _port_ffn(ffn)).numpy()
    jffn = {k: jnp.asarray(v) for k, v in ffn.items()}
    jargs = [jnp.asarray(a) for a in (x, x1, x2, proj, pb)]
    want_kernel = fused_block_tail_cm(*jargs, jffn, tile_rows=tile_rows,
                                      interpret=True)
    want_xla = block_tail_xla(*jargs, jffn)
    assert max_err(got, want_kernel) <= 1e-4
    assert max_err(got, want_xla) <= 1e-4


def test_wrappers_run_plain_version_on_cpu():
    """On a CPU tensor each wrapper is its plain version (the same
    values) and counts no launch; a tensor that is neither on the CPU
    nor on a CUDA device is refused."""
    rng = np.random.default_rng(5)
    before = (ln_mixer_head.launches, window_attention.launches,
              block_tail.launches)
    x, params = _head_inputs(rng, (1, 8, 8, 16))
    tp = [torch.from_numpy(p) for p in params]
    y1, x2 = ln_mixer_head(torch.from_numpy(x), *tp)
    r1, r2 = ln_mixer_head_ref(torch.from_numpy(x), *tp)
    assert torch.equal(y1, r1) and torch.equal(x2, r2)
    a = [torch.from_numpy(v) for v in _attn_inputs(rng, (1, 4, 8, 16))]
    a[1] = a[1].t().contiguous()
    assert torch.equal(window_attention(*a, 2, 8),
                       window_attention_ref(*a, 2, 8))
    x, x1, x2, proj, pb, ffn = _tail_inputs(rng, (1, 8, 8, 8))
    targs = [torch.from_numpy(v) for v in (x, x1, x2)] + [
        torch.from_numpy(np.ascontiguousarray(proj.T)), torch.from_numpy(pb),
        _port_ffn(ffn)]
    assert torch.equal(block_tail(*targs), block_tail_ref(*targs))
    assert (ln_mixer_head.launches, window_attention.launches,
            block_tail.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        window_attention(a[0].to("meta"), *a[1:], 2, 8)


def test_block_tail_weight_copy_follows_version():
    """The block tail's [in, out] weight copy is made once per weight
    version: a fresh view of the same parameter reuses it, an in-place
    update (load_state_dict, an optimizer step) remakes it."""
    w = torch.nn.Parameter(torch.from_numpy(f32(np.random.default_rng(6),
                                                 8, 4, 1, 1)))
    with torch.inference_mode():
        first = _in_out(w.view(8, 4))
        assert torch.equal(first, w.view(8, 4).t())
        assert _in_out(w.view(8, 4)) is first
    with torch.no_grad():
        w.mul_(2.0)
    with torch.inference_mode():
        again = _in_out(w.view(8, 4))
        assert again is not first and torch.equal(again, w.view(8, 4).t())
