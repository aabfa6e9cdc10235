"""`remat` training in the port (plain PyTorch, CPU) against its own run
without it and against the JAX Runner's `remat` step; the shared helpers
of the training-mode tests (`test_torch_port_mixed*.py`,
`test_torch_port_gan.py`).

- Three `Runner.train_step`s with `remat=True` leave every parameter of
  every module bit-equal to the run without it: UnlgFormer at drop_rate
  0.1 (the checkpoint's replay must draw the forward's dropout masks),
  MutInf with its MI term on the ramp (the `mi` module's noise), and
  LightNet; the loss runs twice a step under remat (the forward, then
  the backward's replay), once without.
- One step against the JAX Runner's own step with `remat=True` on the
  same weights and batch (drop 0; `_build_train_step` with optimisers
  that hand back the gradients, `grab`): the loss within 5e-4 relative
  and each gradient within 1e-2 of its tensor's largest value (PERF.md
  section 2's training bounds; a tensor below 1e-3 of the module's
  largest gradient within that plus 1e-5 of the module's largest).

Inputs are made with numpy from a seed and cast to float32 (conftest
turns on jax_enable_x64).
"""

import logging
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu.config import LossCfg as JaxLossCfg
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu.runner import Runner as JaxRunner
from lgteun_tpu_torch.config import Config, LossCfg
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402

BANDS = 4
LOSS_RTOL, GRAD_TOL = 5e-4, 1e-2     # PERF.md section 2
GRAD_LEVEL, GRAD_ATOL = 1e-3, 1e-5
UNLG = {"core_module": {"stage": 1, "drop_rate": 0.0}}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch32(seed, b=2, ms=8, bands=BANDS, target=(2.0, 3.0)):
    """A float32 NHWC batch: LrMS and PAN in [0, 1], the target in
    `target` (in [2, 3] sign(out - target) is the same for both
    packages, so an l1 gradient is not a coin toss)."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    return {"input_lr": u(0, 1, b, ms, ms, bands),
            "input_pan": u(0, 1, b, 4 * ms, 4 * ms, 1),
            "target": u(*target, b, 4 * ms, 4 * ms, bands)}


def grab(keep: bool = False) -> optax.GradientTransformation:
    """An optax transform whose state is the last gradients: its updates
    are zero, or with `keep` the gradients themselves (to chain before
    a real optimiser)."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        zeros, lambda g, s, p=None: (g if keep else zeros(g), g))


def jax_step(cfg, method, params, batch, iter_id=0, txs=None) -> tuple:
    """The JAX Runner's own training step (`_build_train_step`, jitted)
    on `params` and `batch` with optimisers `txs` (default: `grab` for
    each module) -> (new params, new optimiser states, {part: float})."""
    runner = JaxRunner(cfg, method, logger=logging.getLogger("jax_step"))
    runner._txs = txs or {m: grab() for m in params}
    step = runner._build_train_step()
    opt = {m: runner._txs[m].init(params[m]) for m in params}
    new, new_opt, parts = step(
        jax.tree.map(jnp.array, params), opt,
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), jnp.asarray(iter_id))
    return new, new_opt, {k: float(v) for k, v in parts.items()}


def port_grads(module) -> dict:
    """{key: gradient as numpy} of a module's parameters (zeros where
    None)."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().numpy() for k, p in module.named_parameters()}


def hold(got: dict, want: dict, tol: float = GRAD_TOL) -> int:
    """Each of `got`'s gradients against `want`'s under the same key:
    within `tol` of its tensor's largest value, plus GRAD_ATOL of the
    largest of all where the tensor's largest is below GRAD_LEVEL of
    that (float32 rounding is of such a gradient's own size). Returns
    how many were held."""
    want = {k: np.asarray(want[k], np.float64) for k in got}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, g in got.items():
        top = float(np.abs(want[k]).max())
        err = float(np.abs(np.asarray(g, np.float64) - want[k]).max())
        bound = tol * top + (0.0 if top >= GRAD_LEVEL * scale
                             else GRAD_ATOL * scale)
        assert err <= bound, (k, err, bound, top, scale)
    return len(got)


def unlg_cfgs(model_cfg=UNLG, **flags):
    """(port Config, JAX Config) of a 4-band UnlgFormer with l1 and the
    training `flags` (remat, mixed_precision)."""
    port = Config(ms_chans=BANDS, max_iter=10, model_cfg=model_cfg,
                  loss_cfg={"rec_loss": LossCfg("l1", 1.0)}, extras=flags)
    jax_cfg = JaxConfig(ms_chans=BANDS, max_iter=10, model_cfg=model_cfg,
                        loss_cfg={"rec_loss": JaxLossCfg("l1", 1.0)},
                        **flags)
    return port, jax_cfg


def unlg_step(tree, batch, **flags) -> tuple:
    """One port `train_step` of UnlgFormer on weights `tree` -> (loss,
    {key: gradient}, the method)."""
    cfg, _ = unlg_cfgs(**flags)
    port = build_model("UnlgFormer", cfg, device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    runner = Runner(cfg, port, "cpu").set_optim()
    parts = runner.train_step(runner.to_device(batch), 0)
    return float(parts["full_loss"]), port_grads(port.module), port


def _method(name, remat):
    mc = {"UnlgFormer": {"core_module": {"stage": 1, "drop_rate": 0.1}}}
    loss = {"rec_loss": LossCfg("l1", 1.0)}
    if name == "MutInf":
        loss["MI_rec_loss"] = LossCfg("l1", 0.1)
    cfg = Config(model_type=name, ms_chans=BANDS, max_iter=4,
                 model_cfg=mc.get(name, {}), loss_cfg=loss,
                 extras={"remat": remat})
    method = build_model(name, cfg, device="cpu")
    method.init_params(torch.Generator().manual_seed(3), (8, 32))
    return cfg, method


@pytest.mark.parametrize("name", ["UnlgFormer", "MutInf", "lightnet"])
def test_remat_follows_the_plain_run_bit_for_bit(name):
    """Three Adam steps with remat=True: every parameter of every module
    bit-equal to the run without remat; the loss ran twice a step."""
    states, calls = [], []
    for remat in (False, True):
        cfg, method = _method(name, remat)
        runner = Runner(cfg, method, "cpu").set_optim()
        assert runner.remat is remat
        losses = method.losses
        n = [0]

        def counted(*args, **kwargs):
            n[0] += 1
            return losses(*args, **kwargs)

        method.losses = counted
        for it in range(3):
            runner.train_step(runner.to_device(batch32(70 + it)), 2 + it)
        calls.append(n[0])
        states.append({f"{m}.{k}": v.clone() for m, mod in
                       method.modules().items()
                       for k, v in mod.state_dict().items()})
    assert calls == [3, 6]
    plain, remat = states
    assert plain.keys() == remat.keys()
    assert all(torch.equal(plain[k], remat[k]) for k in plain)
    start = {f"{m}.{k}": v for m, mod in _method(name, False)[1]
             .modules().items() for k, v in mod.state_dict().items()}
    assert any(not torch.equal(start[k], plain[k]) for k in plain)


def test_remat_step_matches_jax():
    """One drop-0 step with remat=True: the port's loss and every
    gradient against the JAX Runner's remat step on the same weights."""
    tree = flax_params(BANDS, stage=1, seed=21)
    batch = batch32(71)
    loss, grads, _ = unlg_step(tree, batch, remat=True)
    _, jcfg = unlg_cfgs(remat=True)
    method = build_jax_model("UnlgFormer", jcfg)
    _, opt, parts = jax_step(jcfg, method, {"core_module": jax.tree.map(
        jnp.asarray, tree)}, batch)
    assert abs(loss - parts["full_loss"]) <= LOSS_RTOL * abs(
        parts["full_loss"])
    want = {k: v.numpy() for k, v in lgteun_from_flax(jax.tree.map(
        np.asarray, opt["core_module"])).items()}
    assert hold(grads, want) > 50
