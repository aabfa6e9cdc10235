"""UnlgFormer's selective `mixed_precision` training in the port (plain
PyTorch, CPU) against the JAX package's flax module with `dtype=bf16`.

- The three bf16-operand compositions the selective block runs, each
  against its JAX counterpart on the same inputs: `window_attention_mixed`
  vs `window_attention_xla(..., dtype=bf16)` (its three products float32,
  the bf16 outputs equal or one bf16 step apart), `ln_ffn_mixed` vs
  `ln_ffn_xla(..., dtype=bf16)` and `layers.point_conv_mixed` vs flax's
  `PointConv(dtype=bf16)`.
- One LGB stack in training mode against JAX's flax `LGB(dtype=bf16)` on
  one input: the output and the gradients within a quarter of the
  port's own difference between its bf16 and float32 runs (the form of
  ROADMAP C.35's test). The whole step (drop 0) against the JAX Runner's
  `mixed_precision=True` step (`handles_mixed`: no blanket cast) on the
  same weights and batch is held by JAX's envelope instead: the mixers
  make the mode chaotic at the level of its drift (C.37).
- The gradients of the bf16 biases are left out of the comparisons: JAX
  on the CPU sums them in bf16 (ROADMAP C.43, with its own test).
- The mode is engaged: `handles_mixed`, the loss differs from the
  float32 step's, a training forward calls B4 (`global_mixer`) once a
  block and none of the level-2 kernels' wrappers, the eval forward is
  the float32 one, and the parameters and Adam's moments stay float32.
- Remat over the selective step at drop 0.1 is bit-equal to it.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from lgteun_tpu.models.common.layers import PointConv as JaxPointConv
from lgteun_tpu.ops.ffn_kernel import ln_ffn_xla
from lgteun_tpu.ops.window_attention import window_attention_xla
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config, LossCfg
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.models.common import lgt
from lgteun_tpu_torch.models.common.layers import point_conv_mixed
from lgteun_tpu_torch.ops.ffn_kernel import ln_ffn_mixed
from lgteun_tpu_torch.ops.window_attention import (window_attention_mixed,
                                                   window_partition)
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_remat import (BANDS, batch32, jax_step,  # noqa: E402
                                   unlg_cfgs, unlg_step)

BF16 = torch.bfloat16
STEP = 2.0 ** -7        # a bf16 step relative to the value


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


class _Dtypes(TorchFunctionMode):
    """Records the dtype of every torch.einsum result."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.einsum:
            self.seen.append(out.dtype)
        return out


def test_window_attention_mixed_matches_jax():
    """JAX's bf16-operand window attention on the same windows: the bf16
    outputs equal, or one bf16 step apart at a rounding boundary; the
    three products float32 (JAX's preferred_element_type), each rounded
    after."""
    rng = np.random.default_rng(80)
    c, heads, win = 16, 2, 8
    y = _f32(rng, 2, c, 16, 16)
    wqkv = _f32(rng, 3 * c, c, scale=c ** -0.5)
    bqkv, pos = _f32(rng, 3 * c, scale=0.1), _f32(rng, heads, 64, 64)
    args = [torch.from_numpy(a) for a in (y, wqkv, bqkv, pos)]
    with _Dtypes() as mode:
        got = window_attention_mixed(*args[:2], args[2], args[3], heads, win)
    assert got.dtype == BF16 and mode.seen == [torch.float32] * 3
    xw = window_partition(args[0], win).transpose(1, 2).numpy()
    want = window_attention_xla(jnp.asarray(xw), jnp.asarray(wqkv.T),
                                jnp.asarray(bqkv), jnp.asarray(pos), heads,
                                (c // heads) ** -0.5, dtype=jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    got = window_partition(got.float(), win).transpose(1, 2).numpy()
    d = np.abs(got - want)
    assert d.max() <= STEP * np.abs(want).max() and (d == 0).mean() >= 0.9


def _ffn(rng, c):
    c4 = 4 * c
    return {"ln_gamma": 1 + 0.1 * _f32(rng, c), "ln_beta": _f32(rng, c,
                                                                 scale=0.1),
            "w1": _f32(rng, c, c4, scale=c ** -0.5),
            "b1": _f32(rng, c4, scale=0.1),
            "w2": _f32(rng, c4, c4, scale=c4 ** -0.5),
            "b2": _f32(rng, c4, scale=0.1), "dw": _f32(rng, 3, 3, c4,
                                                         scale=1 / 3),
            "bdw": _f32(rng, c4, scale=0.1),
            "w3": _f32(rng, c4, c, scale=c4 ** -0.5),
            "b3": _f32(rng, c, scale=0.1)}


def test_ln_ffn_mixed_matches_jax():
    """JAX's bf16-operand LN + FFN + residual on the same x: within 2e-3
    of max|out| (one bf16 step of an operand that rounds the other way
    after another summation order), most values within 1e-5."""
    rng = np.random.default_rng(81)
    c = 16
    x, p = _f32(rng, 2, 16, 16, c), _ffn(rng, c)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ffn = {"ln_w": t(p["ln_gamma"]), "ln_b": t(p["ln_beta"]),
           "w1": t(p["w1"].T), "b1": t(p["b1"]), "w2": t(p["w2"].T),
           "b2": t(p["b2"]), "dw": t(p["dw"].transpose(2, 0, 1)),
           "bdw": t(p["bdw"]), "w3": t(p["w3"].T), "b3": t(p["b3"])}
    got = ln_ffn_mixed(t(x.transpose(0, 3, 1, 2)), ffn).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    want = np.asarray(ln_ffn_xla(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                   in p.items()},
                                 dtype=jnp.bfloat16))
    d = np.abs(got.numpy() - want)
    scale = np.abs(want).max()
    assert d.max() <= 2e-3 * scale and np.median(d) <= 1e-5 * scale
    plain = ln_ffn_xla(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                        in p.items()})
    assert np.abs(np.asarray(plain) - want).mean() > 10 * d.mean()


def test_point_conv_mixed_matches_flax():
    """flax's PointConv(dtype=bf16) on the same input and weights: the
    bf16 values equal or one bf16 step apart."""
    rng = np.random.default_rng(82)
    x = _f32(rng, 2, 8, 8, 16)
    mod = JaxPointConv(16, dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)).astype(jnp.float32))
    conv = params["params"]["Conv_0"]["Conv_0"]
    got = point_conv_mixed(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
                         .copy()),
        torch.from_numpy(np.asarray(conv["bias"]).copy()))
    assert got.dtype == BF16
    d = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want)
    assert (d <= STEP * np.abs(want)).all() and (d == 0).mean() >= 0.98


@pytest.fixture(scope="module")
def mixed_case():
    """Weights, a batch, the port's float32 and mixed steps and the JAX
    Runner's mixed step."""
    tree = flax_params(BANDS, stage=1, seed=22)
    batch = batch32(72)
    f32 = unlg_step(tree, batch)
    mixed = unlg_step(tree, batch, mixed_precision=True)
    _, jcfg = unlg_cfgs(mixed_precision=True)
    method = build_jax_model("UnlgFormer", jcfg)
    assert method.handles_mixed
    _, opt, parts = jax_step(jcfg, method, {"core_module": jax.tree.map(
        jnp.asarray, tree)}, batch)
    want = {k: v.numpy() for k, v in lgteun_from_flax(jax.tree.map(
        np.asarray, opt["core_module"])).items()}
    return f32, mixed, (parts["full_loss"], want)


def _flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel()
                           for k in keys])


def bf16_sum_free(keys) -> list:
    """The keys whose JAX gradient on the CPU is not a bf16 bias: the
    cast biases' gradients are sums of bf16 cotangents over the batch
    and the pixels, which XLA's CPU backend accumulates in bf16 (up to
    0.8 of the gradient off; ROADMAP C.43); the port sums in float32."""
    return [k for k in keys if not k.endswith("bias")]


def test_selective_mixed_step_inside_jax_envelope(mixed_case):
    """The whole step: the port's drift from its float32 step (loss, and
    the mean over every gradient entry but the bf16 biases') at most
    1.5x JAX's, and the port's mixed step no farther from JAX's than
    that. The mixers make the mode chaotic at the level of its drift
    (ROADMAP C.37: a float32 rounding of the input moves it by about the
    drift), so the same-function bound, a quarter of the drift, is held
    on one LGB stack (`test_selective_stack_matches_jax`)."""
    (f32_loss, f32_grads, _), (loss, grads, _), (jax_loss, jax_grads) = \
        mixed_case
    jax_drift = abs(jax_loss - f32_loss)
    assert 0 < abs(loss - f32_loss) <= 1.5 * jax_drift
    assert abs(loss - jax_loss) <= 1.5 * jax_drift
    keys = bf16_sum_free(sorted(grads))
    got, want, ref = (_flat(g, keys) for g in (grads, jax_grads, f32_grads))
    envelope = 1.5 * np.abs(want - ref).mean()
    assert 0 < np.abs(got - ref).mean() <= envelope
    assert np.abs(got - want).mean() <= envelope


def test_selective_stack_matches_jax():
    """One LGB block (C 16) in training mode on one input: the output and
    the gradients of a seeded linear loss (the input's and every
    weight's but the bf16 biases', C.43) within a quarter of the port's
    bf16-vs-float32 difference (mean) of JAX's flax `LGB(dtype=bf16)`,
    run op by op: under jit XLA may keep a fusion's intermediates in
    float32 (excess precision), skipping roundings that the function
    spells out (the float32 block is jitted)."""
    from lgteun_tpu.models.common.lgt import LGB as JaxLGB
    tree = flax_params(BANDS, stage=1, seed=24)
    rng = np.random.default_rng(83)
    x = _f32(rng, 2, 16, 16, 16)
    w = _f32(rng, 2, 16, 16, 16)
    sub = tree["prior_0"]["enc_lgb_0"]
    params = {k: jax.tree.map(jnp.asarray, sub[k])
              for k in ("norm_mix_0", "mixer_0", "ffn_0")}
    prefix = "prior_module.0.encoder_layers.0.0."
    state = {k[len(prefix):]: v for k, v in lgteun_from_flax(tree).items()
             if k.startswith(prefix + "blocks.0.")}
    res = {}
    for mixed in (False, True):
        dtype = BF16 if mixed else None
        mod = JaxLGB(num_blocks=1, drop_rate=0.0,
                     dtype=jnp.bfloat16 if mixed else None)

        def loss(p, xx):
            out = mod.apply({"params": p}, xx, deterministic=True)
            return jnp.sum(out * w), out

        vg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
        (_, jout), (gp, gx) = (vg if mixed else jax.jit(vg))(
            params, jnp.asarray(x))
        full = jax.tree.map(np.zeros_like, tree)
        full["prior_0"]["enc_lgb_0"].update(jax.tree.map(np.asarray, gp))
        jgrads = {k[len(prefix):]: v.numpy() for k, v in
                  lgteun_from_flax(full).items()
                  if k.startswith(prefix + "blocks.0.")}
        stack = lgt.LGB(16, 1, drop_rate=0.0, mixed=dtype)
        stack.load_state_dict(state)
        stack.train()
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        xt.requires_grad_()
        out = stack(xt)
        (out * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum() \
            .backward()
        pgrads = {k: p.grad.numpy() for k, p in stack.named_parameters()}
        keys = bf16_sum_free(sorted(pgrads))
        nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
        res[mixed] = {
            "jax": [np.asarray(jout), np.asarray(gx), _flat(jgrads, keys)],
            "port": [nhwc(out), nhwc(xt.grad), _flat(pgrads, keys)]}
    for i in range(3):
        got, want = res[True]["port"][i], res[True]["jax"][i]
        own = np.abs(got - res[False]["port"][i]).mean()
        assert own > 0 and np.abs(got - want).mean() <= 0.25 * own, i
        f32 = np.abs(res[False]["port"][i] - res[False]["jax"][i]).mean()
        assert f32 <= 1e-3 * own


def test_c43_jax_cpu_sums_a_bf16_bias_gradient_in_bf16():
    """ROADMAP C.43: JAX on the CPU sums the gradient of a bf16 bias over
    the broadcast axes in bf16; the port (torch) sums in float32 and
    rounds once, as the TPU's XLA does."""
    rng = np.random.default_rng(84)
    g = _f32(rng, 64, 256, 8)
    bias = np.zeros(8, np.float32)
    jg = jax.grad(lambda b: jnp.sum(jnp.asarray(g).astype(jnp.bfloat16)
                                    * (b.astype(jnp.bfloat16) + 1)).astype(
        jnp.float32))(jnp.asarray(bias))
    tb = torch.zeros(8, requires_grad=True)
    (torch.from_numpy(g).to(BF16) * (tb.to(BF16) + 1)).float().sum() \
        .backward()
    exact = g.astype(np.float64).reshape(-1, 8).sum(0)
    gb = torch.from_numpy(g).to(BF16).double().reshape(-1, 8).sum(0)
    port_err = np.abs(tb.grad.double().numpy() - gb.numpy()).max()
    jax_err = np.abs(np.asarray(jg, np.float64) - gb.numpy()).max()
    assert port_err <= STEP * np.abs(gb.numpy()).max()
    assert jax_err > 10 * port_err and np.abs(exact).max() > 0


def test_selective_mixed_engages(mixed_case, monkeypatch):
    """handles_mixed; the parameters and Adam's moments stay float32; a
    training forward runs B4 once a block and no level-2 kernel wrapper,
    the eval forward the float32 one."""
    (f32_loss, _, _), (loss, _, port), _ = mixed_case
    assert port.handles_mixed and loss != f32_loss
    runner = Runner(port.cfg, port, "cpu").set_optim()
    runner.train_step(runner.to_device(batch32(73)), 1)
    assert runner.blanket is None
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
    assert all(v.dtype == torch.float32 for s in runner.optimizer.state
               .values() for k, v in s.items() if k != "step")
    calls = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(lgt, name, wrapped)

    for name in ("global_mixer", "ln_mixer_head", "window_attention",
                 "block_tail", "block_tail_masked", "ln_ffn", "lgb_block"):
        spy(name, getattr(lgt, name))
    runner.train_step(runner.to_device(batch32(74)), 2)
    assert calls == {"global_mixer": 5}
    calls.clear()
    f32_cfg, _ = unlg_cfgs()
    f32 = build_model("UnlgFormer", f32_cfg, device="cpu")
    f32.load_state_dict(port.state_dict())
    port.eval()
    batch = batch32(75)
    assert torch.equal(port.apply(batch), f32.apply(batch))
    assert calls == {"ln_mixer_head": 10, "window_attention": 10,
                     "block_tail": 10}


def test_remat_over_selective_mixed_is_bit_equal():
    """Three steps of the selective mode at drop 0.1 with and without
    remat: the same parameters bit for bit."""
    tree = flax_params(BANDS, stage=1, seed=23)
    mc = {"core_module": {"stage": 1, "drop_rate": 0.1}}
    out = []
    for flags in ({}, {"remat": True}):
        cfg = Config(ms_chans=BANDS, max_iter=10, model_cfg=mc,
                     loss_cfg={"rec_loss": LossCfg("l1", 1.0)},
                     extras={"mixed_precision": True, **flags})
        port = build_model("UnlgFormer", cfg, device="cpu")
        port.load_state_dict(lgteun_from_flax(tree))
        runner = Runner(cfg, port, "cpu").set_optim()
        for it in range(3):
            runner.train_step(runner.to_device(batch32(76 + it)), it)
        out.append(port.state_dict())
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])
