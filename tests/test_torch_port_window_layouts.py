"""Window attention in the port's two further layouts (B6 [N, C, S]
windows, B7 [N*S, C] rows) vs the JAX package, the
`LGTEUN_FUSED_ATTENTION=v2` routing of the LGB blocks, and the
recompute backward of the kernel wrappers (`ops.autograd`).

Inputs are made with numpy from a seed and cast to float32 (conftest
turns on jax_enable_x64). The plain versions are held to the Pallas
kernels in interpret mode within 1e-5 at unit-scale inputs (f32 softmax
and matmuls in other orders), as tests/test_torch_port_ops.py holds the
image-layout one. The CUDA kernels are held against these plain versions
on the card by `chip_smoke.py`, where the three layouts give the same
bits.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu.models import lgteun_fast
from lgteun_tpu.ops.window_attention import (fused_window_attention,
                                             fused_window_attention_v2_cm)
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config, LossCfg
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.models.common import lgt
from lgteun_tpu_torch.ops import windows_layout_attention
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.ffn_kernel import (FFN_KEYS, block_tail_masked_ref,
                                             block_tail_ref, ln_ffn_ref)
from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer_ref,
                                                  ln_mixer_head_ref)
from lgteun_tpu_torch.ops.window_attention import (
    window_attention_ref, window_attention_rows, window_attention_rows_ref,
    window_attention_windows, window_attention_windows_ref,
    window_partition, window_unpartition)
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_ops import f32, max_err  # noqa: E402

HEADS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """These small CPU ops run on one thread: the suite runs in parallel
    workers, whose intra-op thread pools would otherwise oversubscribe
    the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(rng, c, s):
    """(wqkv [C, 3C] as JAX holds it, bqkv, pos)."""
    return (f32(rng, c, 3 * c, scale=c ** -0.5), 0.1 * f32(rng, 3 * c),
            f32(rng, HEADS, s, s))


def _port(w):
    wqkv, bqkv, pos = w
    return (torch.from_numpy(np.ascontiguousarray(wqkv.T)),
            torch.from_numpy(bqkv), torch.from_numpy(pos))


@pytest.mark.parametrize("n,c,s", [(8, 8, 64), (4, 16, 64), (6, 8, 16)])
def test_windows_layout_matches_pallas_v2(n, c, s):
    """B6: plain [N, C, S] attention vs fused_window_attention_v2_cm."""
    rng = np.random.default_rng(40)
    xt, w = f32(rng, n, c, s), _weights(rng, c, s)
    got = window_attention_windows_ref(torch.from_numpy(xt), *_port(w),
                                       HEADS).numpy()
    want = fused_window_attention_v2_cm(
        *(jnp.asarray(a) for a in (xt,) + w), heads=HEADS,
        scale=(c // HEADS) ** -0.5, interpret=True)
    assert max_err(got, want) <= 1e-5


@pytest.mark.parametrize("n,c,s", [(8, 8, 64), (3, 16, 64)])
def test_rows_layout_matches_pallas(n, c, s):
    """B7: plain [N, S, C] attention vs fused_window_attention (rows)."""
    rng = np.random.default_rng(41)
    xw, w = f32(rng, n, s, c), _weights(rng, c, s)
    got = window_attention_rows_ref(torch.from_numpy(xw), *_port(w),
                                    HEADS).numpy()
    want = fused_window_attention(*(jnp.asarray(a) for a in (xw,) + w),
                                  heads=HEADS, scale=(c // HEADS) ** -0.5,
                                  interpret=True)
    assert max_err(got, want) <= 1e-5


def test_partition_matches_jax_windows():
    """`window_partition` lays the windows out as the JAX fast path's
    `_windows_cm` does ([N, C, S], windows in image, row, column order);
    `window_unpartition` inverts it exactly."""
    y = f32(np.random.default_rng(42), 2, 8, 16, 24)
    xt = window_partition(torch.from_numpy(y), 8)
    assert np.array_equal(xt.numpy(), lgteun_fast._windows_cm(
        jnp.asarray(y), 8))
    assert torch.equal(window_unpartition(xt, 8, 16, 24), torch.from_numpy(y))


def test_new_entries_run_plain_version_on_cpu():
    """On a CPU tensor the two entries are their plain versions and count
    no launch; another device is refused."""
    rng = np.random.default_rng(43)
    w = _port(_weights(rng, 8, 64))
    xt = torch.from_numpy(f32(rng, 3, 8, 64))
    before = (window_attention_windows.launches,
              window_attention_rows.launches)
    assert torch.equal(window_attention_windows(xt, *w, HEADS),
                       window_attention_windows_ref(xt, *w, HEADS))
    xw = xt.transpose(1, 2).contiguous()
    assert torch.equal(window_attention_rows(xw, *w, HEADS),
                       window_attention_rows_ref(xw, *w, HEADS))
    assert (window_attention_windows.launches,
            window_attention_rows.launches) == before
    for fn, x in ((window_attention_windows, xt), (window_attention_rows,
                                                   xw)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x.to("meta"), *w, HEADS)


@pytest.mark.parametrize("env,want", [("v2", True), ("1", False),
                                      ("0", False), ("", False)])
def test_windows_flag_parse(env, want, monkeypatch):
    """`v2` selects the windows layout; every other value the default."""
    monkeypatch.setenv("LGTEUN_FUSED_ATTENTION", env)
    assert windows_layout_attention() is want


ENTRIES = ("ln_mixer_head", "window_attention", "window_attention_windows",
           "block_tail", "block_tail_masked", "global_mixer", "ln_ffn",
           "lgb_block")
# launches per UnlgFormer forward (K = 2: 4 full-res blocks + 1 bottleneck)
V2_ROUTES = {1: {"window_attention_windows": 5, "global_mixer": 5,
                 "ln_ffn": 5},
             2: {"ln_mixer_head": 5, "window_attention_windows": 5,
                 "block_tail": 5},
             3: {"lgb_block": 5}}


def _unlgformer(monkeypatch, tree, level, flag="v2", drop_rate=0.1):
    monkeypatch.setenv("LGTEUN_FUSE_LEVEL", str(level))
    monkeypatch.setenv("LGTEUN_FUSED_ATTENTION", flag)
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 2,
                                               "drop_rate": drop_rate}},
        loss_cfg={"rec_loss": LossCfg("l1")}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    monkeypatch.delenv("LGTEUN_FUSE_LEVEL")
    monkeypatch.delenv("LGTEUN_FUSED_ATTENTION")
    return port


def _spy(monkeypatch):
    calls = dict.fromkeys(ENTRIES, 0)

    def spy(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    for name in ENTRIES:
        monkeypatch.setattr(lgt, name, spy(name, getattr(lgt, name)))
    return calls


def _batch(rng, b=1, c=4):
    return {"input_lr": rng.uniform(0, 1, (b, 8, 8, c)).astype(np.float32),
            "input_pan": rng.uniform(0, 1, (b, 32, 32, 1)).astype(np.float32),
            "target": rng.uniform(0, 1, (b, 32, 32, c)).astype(np.float32)}


@pytest.mark.parametrize("level", sorted(V2_ROUTES))
def test_v2_routing(level, monkeypatch):
    """With LGTEUN_FUSED_ATTENTION=v2 (read when the method is built)
    levels 1 and 2 call `window_attention_windows` in place of
    `window_attention`, 5 times a forward; level 3 ignores the flag. In a
    training step with dropout, level 2 calls `block_tail_masked` and
    level 3 runs level 2's chain."""
    port = _unlgformer(monkeypatch, flax_params(4), level)
    calls = _spy(monkeypatch)
    batch = _batch(np.random.default_rng(44))
    port.apply(batch)
    assert calls == {k: V2_ROUTES[level].get(k, 0) for k in ENTRIES}
    calls.update(dict.fromkeys(ENTRIES, 0))
    port.train()
    port.losses(batch, torch.Generator().manual_seed(0))[0].backward()
    want = dict(V2_ROUTES[min(level, 2)])
    if level >= 2:
        want["block_tail_masked"] = want.pop("block_tail")
    assert calls == {k: want.get(k, 0) for k in ENTRIES}


def test_unlgformer_v2_matches_jax_module(monkeypatch):
    """UnlgFormer with the flag vs the JAX Method (flax module path) with
    the same flag, within the port's 5e-4 max-abs."""
    tree = flax_params(4, seed=5)
    batch = _batch(np.random.default_rng(45), b=2)
    got = _unlgformer(monkeypatch, tree, 2).apply(batch).numpy()
    monkeypatch.setenv("LGTEUN_FUSED_ATTENTION", "v2")
    method = build_jax_model("UnlgFormer", JaxConfig(
        ms_chans=4, model_cfg={"core_module": {"stage": 2}}))
    want = jax.jit(method.apply)(
        {"core_module": jax.tree.map(jnp.asarray, tree)},
        {k: jnp.asarray(batch[k]) for k in ("input_lr", "input_pan")})
    assert got.shape == want.shape and np.isfinite(got).all()
    assert max_err(got, want) <= 5e-4


def _recompute_cases(rng):
    """name -> (plain, float64 inputs): each wrapper's plain version at a
    tiny size (4x4 windows, 2 heads; a fixed dropout mask)."""
    d = lambda *s, scale=1.0: torch.from_numpy(
        rng.standard_normal(s) * scale)
    c, c4 = 4, 16
    ffn = [1 + 0.1 * d(c), 0.1 * d(c), d(c4, c, scale=0.5), 0.1 * d(c4),
           d(c4, c4, scale=0.25), 0.1 * d(c4), d(c4, 3, 3, scale=0.3),
           0.1 * d(c4), d(c, c4, scale=0.25), 0.1 * d(c)]
    mask = torch.from_numpy((rng.uniform(size=(1, c, 4, 4)) < 0.9) / 0.9)
    tail = [d(1, c, 4, 4), d(1, 2, 4, 4), d(1, 2, 4, 4), d(c, c, scale=0.5),
            0.1 * d(c)]
    attn = [d(3 * 2, 2, scale=0.7), 0.1 * d(3 * 2), d(HEADS, 16, 16)]
    mixer = [d(2), 0.1 * d(2), d(2), 0.1 * d(2)]
    as_ffn = lambda t: dict(zip(FFN_KEYS, t))
    return {
        "ln_mixer_head": (ln_mixer_head_ref,
                          [d(1, c, 4, 4), 1 + 0.1 * d(c), 0.1 * d(c)] + mixer),
        "window_attention": (lambda *t: window_attention_ref(*t, HEADS, 4),
                             [d(1, 2, 4, 8)] + attn),
        "window_attention_windows": (
            lambda *t: window_attention_windows_ref(*t, HEADS),
            [d(2, 2, 16)] + attn),
        "block_tail_masked": (
            lambda *t: block_tail_masked_ref(*t[:3], mask, *t[3:5],
                                             as_ffn(t[5:])), tail + ffn),
        "global_mixer": (global_mixer_ref, [d(1, 2, 4, 6)] + mixer),
        "ln_ffn": (lambda x, *t: ln_ffn_ref(x, as_ffn(t)),
                   [d(1, c, 4, 4)] + ffn),
    }


@pytest.mark.parametrize("name", ["ln_mixer_head", "window_attention",
                                  "window_attention_windows",
                                  "block_tail_masked", "global_mixer",
                                  "ln_ffn"])
def test_recompute_backward(name):
    """`recompute` with the plain version as its forward (as the CPU has
    no kernel) gives direct autograd's gradients, and passes gradcheck in
    float64 (fast mode: along a random direction): the backward the card
    runs behind each kernel."""
    plain, inputs = _recompute_cases(np.random.default_rng(46))[name]
    inputs = [t.requires_grad_() for t in inputs]

    def loss(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o * (1.0 + 0.5 * i)).sin().sum()
                   for i, o in enumerate(outs))

    got = torch.autograd.grad(loss(recompute(plain, plain, *inputs)), inputs,
                              allow_unused=True)
    want = torch.autograd.grad(loss(plain(*inputs)), inputs,
                               allow_unused=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)
    assert torch.autograd.gradcheck(lambda *t: recompute(plain, plain, *t),
                                    inputs, fast_mode=True)


def test_recompute_mask_gets_no_gradient():
    """The dropout mask rides through `recompute` as an input without a
    gradient; the tail's other inputs get theirs."""
    rng = np.random.default_rng(47)
    _, inputs = _recompute_cases(rng)["block_tail_masked"]
    mask = torch.from_numpy((rng.uniform(size=(1, 4, 4, 4)) < 0.9) / 0.9)
    inputs = [t.requires_grad_() for t in inputs]
    plain = lambda *t: block_tail_ref(*t[:5], dict(zip(FFN_KEYS, t[5:-1])),
                                      mask=t[-1])
    out = recompute(plain, plain, *inputs, mask)
    grads = torch.autograd.grad(out.square().sum(), inputs)
    assert all(torch.isfinite(g).all() for g in grads)
    assert not mask.requires_grad and mask.grad is None


@pytest.mark.parametrize("shape", [(1, 2, 8, 8), (2, 3, 8, 12)])
def test_global_mixer_gradient_at_constant_plane(shape):
    """Every plane constant: all bins but DC are exactly zero, where
    |z| and angle(z) have no gradient. The double `where` of
    `global_mixer_ref` keeps every gradient finite and equal to JAX's
    (jax.grad of global_mixer_xla_cm, the same double `where`; ROADMAP
    C.2), to 1e-5 of the largest."""
    from lgteun_tpu.ops.spectral_kernel import global_mixer_xla_cm

    rng = np.random.default_rng(48)
    b, c, h, w = shape
    level = rng.uniform(-2, 2, c).astype(np.float32)
    x = np.broadcast_to(level[None, :, None, None], shape).astype(np.float32)
    params = [f32(rng, c), 0.1 * f32(rng, c),
              rng.choice([-2.0, -1.0, 1.0, 2.0], c).astype(np.float32),
              0.1 * f32(rng, c)]
    weight = f32(rng, *shape)
    inputs = [torch.from_numpy(a).requires_grad_() for a in [x] + params]
    loss = (global_mixer_ref(*inputs) * torch.from_numpy(weight)).sum()
    got = torch.autograd.grad(loss, inputs)
    want = jax.grad(lambda *a: jnp.sum(global_mixer_xla_cm(*a) * weight),
                    argnums=tuple(range(5)))(*map(jnp.asarray, [x] + params))
    for g, wnt in zip(got, want):
        assert torch.isfinite(g).all()
        scale = float(np.max(np.abs(np.asarray(wnt))))
        assert max_err(g.numpy(), wnt) <= 1e-5 * max(scale, 1e-6)
