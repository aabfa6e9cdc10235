"""The blanket `mixed_precision` cast of the JAX Runner in the port (plain
PyTorch, CPU): LightNet, MDCUN, INNT (both routes), PanFormer, SFIIN and
MutInf, one `Runner.train_step` against the JAX Runner's own step
(`_build_train_step` with optimisers that hand back the gradients) on
the same weights and batch.

- The port's step runs `losses` on a bfloat16 copy of every module's
  parameters and on bfloat16 inputs (`TorchMethod.training_cast`), the
  total back in float32. Its gradients (the mean over every entry but
  the bf16 biases', which JAX's CPU sums in bf16: ROADMAP C.43) stand
  within a quarter of the port's own bf16-vs-float32 drift of JAX's
  mixed gradients (QUARTER, the form of the selective block's test) for
  LightNet, INNT on both routes, PanFormer and SFIIN without its phase
  loss. Every case also keeps its drift inside JAX's drift from the
  float32 step (at most 1.5x: the envelope of the eval cast's tests,
  `tests/test_torch_port_zoo_bf16.py`), its mixed gradients no farther
  from JAX's than that, and the loss within a bf16 step (2^-8 relative)
  of JAX's: a mean of bf16 values, its own drift is a signed mean that
  can fall near zero by chance. Three cases are held by the envelope
  alone, at these measured ratios of the gap to JAX over the port's own
  drift (`pytest -s` prints each case's): MDCUN 48 (JAX on the CPU runs
  its attention in bf16 arithmetic, where its TPU kernel and the port's
  entry compute in float32: C.43), SFIIN with its phase loss 0.79 (0.076
  without that loss, its own case, while on one fixed bf16 output the
  phase loss's gradient agrees with JAX's:
  `test_phase_loss_gradient_on_a_bf16_output`; the loss's 1/|z| at
  near-zero bins magnifies the forward's bf16 rounding differences) and
  MutInf 0.27.
- Every master parameter, its gradient and Adam's state stay float32;
  LightNet and MutInf train in bf16 too (their eval opt-outs are JAX's
  `apply`, not its Runner's cast), MutInf's `mi` module included.
- A mixed step changes the loss from the float32 one (bf16 engaged).

Weights are carried to JAX with `convert/from_jax.py`'s inverses as in
`tests/test_torch_port_zoo_train.py`, whose helpers build the cases.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu.config import LossCfg as JaxLossCfg
from lgteun_tpu.models import mutinf as jax_mutinf
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import mi_from_flax, panformer_from_flax
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_port_zoo_train as zoo  # noqa: E402
from test_torch_port_innt import _fill  # noqa: E402
from test_torch_port_remat import jax_step, port_grads  # noqa: E402

BANDS = zoo.BANDS
ENVELOPE = 1.5
QUARTER = 0.25
PANFORMER = {"core_module": dict(n_feats=16, n_heads=2, head_dim=8,
                                 win_size=4, n_blocks=1)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _panformer_tree():
    from lgteun_tpu.convert import convert_state_dict
    port = build_model("PanFormer", Config(model_type="PanFormer",
                                           ms_chans=BANDS,
                                           model_cfg=PANFORMER),
                       device="cpu").init_params(torch.Generator()
                                                 .manual_seed(0))
    shapes = convert_state_dict("PanFormer", {
        k: v.numpy() for k, v in port.state_dict().items()})
    return _fill(shapes, seed=9)


def _case(name, drop=None):
    """(flax core tree, carry, loss_cfg without the term `drop`,
    model_cfg)."""
    if name == "PanFormer":
        return (_panformer_tree(), panformer_from_flax,
                {"rec_loss": ("l1", 1.0)}, PANFORMER)
    tree, from_flax, loss_cfg, model_cfg = zoo._case(name)
    return (tree, from_flax,
            {k: v for k, v in loss_cfg.items() if k != drop}, model_cfg)


def _port(name, whole_chain, mixed, monkeypatch, drop=None):
    tree, from_flax, loss_cfg, model_cfg = _case(name, drop)
    monkeypatch.setenv("LGTEUN_FUSED_TM", "1" if whole_chain else "0")
    cfg = Config(model_type=name, ms_chans=BANDS, max_iter=zoo.MAX_ITER,
                 model_cfg=model_cfg,
                 loss_cfg={k: zoo.LossCfg(t, w)
                           for k, (t, w) in loss_cfg.items()},
                 extras={"mixed_precision": mixed})
    port = build_model(name, cfg, device="cpu")
    if name == "MutInf":
        port.module = zoo._core("MutInf")
        port.load_module_state_dict("mi", mi_from_flax(zoo._mi_tree(8)))
    port.load_state_dict(from_flax(tree), strict=True)
    return cfg, port


def _port_step(name, whole_chain, mixed, batch, monkeypatch, drop=None):
    """(loss, {module: {key: gradient}}, runner) of one port step."""
    cfg, port = _port(name, whole_chain, mixed, monkeypatch, drop)
    runner = Runner(cfg, port, "cpu").set_optim()
    parts = runner.train_step(runner.to_device(batch), 0)
    grads = {m: port_grads(mod) for m, mod in port.modules().items()}
    return float(parts["full_loss"]), grads, runner


@functools.lru_cache(maxsize=None)
def _jax_grads(name, mixed, seed, drop=None):
    """(loss, {module: {port key: gradient}}) of the JAX Runner's step."""
    tree, from_flax, loss_cfg, model_cfg = _case(name, drop)
    cfg = JaxConfig(model_type=name, ms_chans=BANDS, max_iter=zoo.MAX_ITER,
                    model_cfg=model_cfg, mixed_precision=mixed,
                    loss_cfg={k: JaxLossCfg(t, w)
                              for k, (t, w) in loss_cfg.items()})
    method = build_jax_model(name, cfg)
    params = {"core_module": jax.tree.map(jnp.asarray, tree)}
    if name == "MutInf":
        method.module = jax_mutinf.GPPNNMutInf(ms_chans=BANDS,
                                               block_num=zoo.MUTINF_BLOCKS)
        params["mi"] = jax.tree.map(jnp.asarray, zoo._mi_tree(8))
    _, opt, parts = jax_step(cfg, method, params, zoo._batch32(seed))
    grads = jax.tree.map(np.asarray, opt)
    out = {"core_module": {k: v.numpy() for k, v in
                           from_flax(grads["core_module"]).items()}}
    if name == "MutInf":
        out["mi"] = {k: v.numpy() for k, v in
                     mi_from_flax(grads["mi"]).items()}
    return parts["full_loss"], out


def _flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[m][k], np.float64).ravel()
                           for m, k in keys])


@pytest.mark.parametrize("name,whole_chain,drop,quarter", [
    ("lightnet", True, None, True), ("MDCUN", True, None, False),
    ("INNT", True, None, True), ("INNT", False, None, True),
    ("PanFormer", True, None, True), ("SFIIN", True, None, False),
    ("SFIIN", True, "fre_pha_rec_loss", True),
    ("MutInf", True, None, False)],
    ids=["lightnet", "MDCUN", "INNT-texture_match", "INNT-patch_match",
         "PanFormer", "SFIIN", "SFIIN-no-phase-loss", "MutInf"])
def test_blanket_mixed_step_inside_jax_envelope(name, whole_chain, drop,
                                                quarter, monkeypatch):
    """One blanket-cast step: the port's mixed gradients within QUARTER
    of its own drift from its float32 step of JAX's where `quarter` (mean
    over every entry but the bf16 biases'); the drift at most ENVELOPE x
    JAX's and the gap to JAX's no larger than that; the loss within a
    bf16 step of JAX's; float32 masters, gradients and Adam states; bf16
    engaged."""
    seed = 60
    batch = zoo._batch32(seed)
    if name == "SFIIN":   # the TPU's matmul DFT: jnp.fft refuses bf16
        monkeypatch.setenv("LGTEUN_MATMUL_DFT", "1")
    f32_loss, f32_grads, _ = _port_step(name, whole_chain, False, batch,
                                        monkeypatch, drop)
    loss, grads, runner = _port_step(name, whole_chain, True, batch,
                                     monkeypatch, drop)
    jax_loss, jax_grads = _jax_grads(name, True, seed, drop)
    assert runner.blanket == torch.bfloat16 and loss != f32_loss
    for opt in runner.optimizers.values():
        for group in opt.param_groups:
            for p in group["params"]:
                assert p.dtype == torch.float32
                assert p.grad is None or p.grad.dtype == torch.float32
        assert all(v.dtype == torch.float32 for s in opt.state.values()
                   for k, v in s.items() if k != "step")
    keys = [(m, k) for m in jax_grads for k in jax_grads[m]
            if k in grads[m] and not k.endswith("bias")]
    got, want, ref = (_flat(g, keys) for g in (grads, jax_grads, f32_grads))
    jax_drift = np.abs(want - ref).mean()
    own, gap = np.abs(got - ref).mean(), np.abs(got - want).mean()
    assert abs(loss - jax_loss) <= 2.0 ** -8 * abs(jax_loss)
    print(f"{name} (without {drop}): gap to JAX / own drift "
          f"{gap / own:.3f}, own drift / JAX's {own / jax_drift:.3f}")
    assert 0 < own <= ENVELOPE * jax_drift
    assert gap <= ENVELOPE * jax_drift
    if quarter:
        assert gap <= QUARTER * own


def test_phase_loss_gradient_on_a_bf16_output(monkeypatch):
    """SFIIN's phase loss on one fixed bf16 output and target: the port's
    `spectrum_amp_phase` and JAX's matmul DFT with `_safe_amp_pha` give
    the same loss and gradient up to one bf16 rounding of the gradient
    (mean within 1e-4 of the mean magnitude)."""
    from lgteun_tpu.models.sfiin import _safe_amp_pha
    from lgteun_tpu.ops.fft import rfft2_pair
    from lgteun_tpu_torch.models.sfiin import spectrum_amp_phase
    monkeypatch.setenv("LGTEUN_MATMUL_DFT", "1")
    rng = np.random.default_rng(61)
    out, tgt = (rng.normal(1, 0.3, (2, 32, 32, BANDS)).astype(np.float32)
                for _ in range(2))
    target = jnp.asarray(tgt).astype(jnp.bfloat16)

    def jax_loss(o):
        return jnp.mean(jnp.abs(_safe_amp_pha(*rfft2_pair(o))[1]
                                - _safe_amp_pha(*rfft2_pair(target))[1]))

    jv, jg = jax.value_and_grad(jax_loss)(
        jnp.asarray(out).astype(jnp.bfloat16))
    nchw = lambda a: torch.from_numpy(a).to(torch.bfloat16).permute(
        0, 3, 1, 2).contiguous()
    o = nchw(out).requires_grad_()
    value = (spectrum_amp_phase(o)[1] - spectrum_amp_phase(nchw(tgt))[1]
             ).abs().mean()
    value.backward()
    value = value.detach()
    got = o.grad.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(jg.astype(jnp.float32))
    assert o.grad.dtype == torch.bfloat16
    assert abs(value.item() - float(jv)) <= 1e-6 * abs(float(jv))
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).mean() <= 1e-4 * np.abs(want).mean()


@pytest.mark.parametrize("name", ["neighborhood_attention", "texture_match",
                                  "patch_match"])
def test_bf16_train_entry_recompute(name, monkeypatch):
    """The bf16 training entries of B10-B12 (`_train_entry` on bf16
    inputs, the blanket cast's) with the kernel call patched to its plain
    version: the same bf16 outputs and bf16 gradients as plain autograd
    of `*_ref` on the same inputs; the attention's kernel gets its bf16
    weights upcast inside the recorded call (float32), its gradients
    reach the bf16 weights."""
    mod, kernel_name, plain, inputs, extra = zoo._b_cases(
        np.random.default_rng(25))[name]
    seen = []

    def kernel(*t):
        seen.append([a.dtype for a in t if isinstance(a, torch.Tensor)])
        return plain(*t)

    monkeypatch.setattr(mod, kernel_name, kernel)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in inputs]

    def loss(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o.float() * (1.0 + 0.5 * i)).sin().sum()
                   for i, o in enumerate(outs))

    got_out = mod._train_entry(*leaves, *extra)
    got = torch.autograd.grad(loss(got_out), leaves)
    want_out = plain(*leaves, *extra)
    want = torch.autograd.grad(loss(want_out), leaves)
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    assert all(o.dtype == torch.bfloat16 and torch.equal(o, w)
               for o, w in zip(as_tuple(got_out), as_tuple(want_out)))
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w)
               for g, w in zip(got, want))
    assert all(g.abs().max() > 0 for g in got)
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen == [[bf16] + [f32] * 4 if name == "neighborhood_attention"
                    else [bf16] * len(leaves)]
