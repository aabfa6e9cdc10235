"""Training of LightNet, MDCUN, INNT, SFIIN and MutInf in the port (plain
PyTorch, CPU) against the JAX package.

- One step's loss and every gradient against `jax.value_and_grad` of the
  JAX `Method.losses(params, batch, rng=, iter_id=)` on weights carried
  across by `convert/from_jax.py`: 4 bands, PAN 32^2, one image, targets
  offset to [2, 3] so that sign(out - target) is the same in both (as
  tests/test_torch_grad_parity.py does); the loss within 3e-4 relative,
  each gradient within 1e-3 of its tensor's largest value (5e-3 for
  SFIIN, the bounds of tests/test_torch_grad_parity.py:304-305), a
  tensor whose largest value is below 1e-3 of its module's largest
  gradient within that plus 1e-5 of the module's largest (float32
  rounding is of its own size there). INNT on
  both routes of its texture transformer; MutInf at iteration 0,
  mid-ramp and past max_iter with the noise JAX draws from the step's
  key (`_mi_eps`'s recipe, injected through `noise=`), at 2 invertible
  blocks (4 shipped) to keep JAX's tracing and compile short.
- MutInf's `mi` module: the flatten order (NCHW, the reference's; the
  JAX module's NHWC order is ROADMAP C.34, undone by `mi_from_flax`),
  its value and gradients against JAX, one `Runner.train_step` of both
  modules against optax, a checkpoint that resumes bit-equal and a
  checkpoint of the earlier one-optimiser form that still loads.
- SFIIN's spectrum at the self-conjugate bins at a power-of-two side and
  at a side with a factor of 3.
- The training entries of the four search and stack kernels (B9-B12):
  `recompute` with the kernel call patched to its plain version gives
  plain autograd's gradients.
- `main` (no --test-only) trains MutInf on the CPU and writes both
  modules into its checkpoint.

Inputs are made with numpy from a seed and cast to float32 (conftest
turns on jax_enable_x64).
"""

import functools
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu.config import LossCfg as JaxLossCfg
from lgteun_tpu.config import OptimCfg as JaxOptimCfg
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.losses import MutualInfoReg as JaxMI
from lgteun_tpu.models import mutinf as jax_mutinf
from lgteun_tpu.models.sfiin import _safe_amp_pha
from lgteun_tpu.ops.fft import rfft2_pair
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu.runner import make_optimizer as jax_make_optimizer
from lgteun_tpu_torch import main as port_main
from lgteun_tpu_torch.config import Config, LoaderCfg, LossCfg, OptimCfg
from lgteun_tpu_torch.config import SchedCfg
from lgteun_tpu_torch.convert.from_jax import (innt_from_flax,
                                               lightnet_from_flax,
                                               mdcun_from_flax,
                                               mi_from_flax,
                                               mutinf_from_flax,
                                               sfiin_from_flax)
from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
from lgteun_tpu_torch.losses import MutualInfoReg
from lgteun_tpu_torch.models.mutinf import GPPNNMutInf
from lgteun_tpu_torch.models.sfiin import spectrum_amp_phase
from lgteun_tpu_torch.ops import (lightnet_kernel, nonlocal_kernel,
                                  patch_match_kernel, texture_match_kernel)
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_port_lightnet as t_lightnet  # noqa: E402
import test_torch_port_mdcun as t_mdcun  # noqa: E402
from test_torch_port_innt import _fill, max_err  # noqa: E402

BANDS = 4
MAX_ITER = 100                 # MutInf's ramp: min(iter_id / 100, 1)
LOSS_RTOL = 3e-4
GRAD_LEVEL, GRAD_ATOL = 1e-3, 1e-5
GRAD_TOL = {"lightnet": 1e-3, "MDCUN": 1e-3, "INNT": 1e-3, "SFIIN": 5e-3,
            "MutInf": 1e-3}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=1, ms=8, bands=BANDS):
    rng = np.random.default_rng(seed)
    return {"input_lr": rng.uniform(0, 1, (b, ms, ms, bands)),
            "input_pan": rng.uniform(0, 1, (b, 4 * ms, 4 * ms, 1)),
            "target": rng.uniform(2, 3, (b, 4 * ms, 4 * ms, bands))}


def _batch32(seed, b=1):
    return {k: v.astype(np.float32) for k, v in _batch(seed, b).items()}


def _mi_eps(key, b, latent=4):
    """The noise JAX's MutualInfoReg draws from `key`."""
    ka, kb = jax.random.split(key)
    return tuple(np.asarray(jax.random.normal(k, (b, latent)), np.float32)
                 for k in (ka, kb))


def _mi_tree(seed, side=8, channels=4):
    """A flax MutualInfoReg tree of `side`^2 encoded maps, from numpy:
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1)."""
    rng = np.random.default_rng(seed)
    conv = lambda cin: {"kernel": rng.uniform(
        -0.25 / np.sqrt(cin), 0.25 / np.sqrt(cin), (4, 4, cin, channels)),
        "bias": rng.uniform(-0.1, 0.1, channels)}
    width = channels * side * side
    dense = lambda: {"kernel": rng.uniform(-1, 1, (width, 4)) / np.sqrt(
        width), "bias": rng.uniform(-0.1, 0.1, 4)}
    tree = {"layer1": conv(4), "layer2": conv(4), "layer3": conv(channels),
            "layer4": conv(channels), "fc1_rgb3": dense(),
            "fc2_rgb3": dense(), "fc1_depth3": dense(), "fc2_depth3": dense()}
    return jax.tree.map(lambda v: np.asarray(v, np.float32), tree)


# name -> (flax core tree, carry, loss_cfg, model_cfg)
def _case(name):
    rec = {"rec_loss": ("l1", 1.0)}
    if name == "lightnet":
        return (t_lightnet.flax_params(BANDS, seed=3), lightnet_from_flax,
                rec, {})
    if name == "MDCUN":
        return (t_mdcun.flax_params(BANDS, seed=4), mdcun_from_flax, rec,
                {"core_module": {"mid_channels": t_mdcun.MID,
                                 "T": t_mdcun.T}})
    if name == "INNT":
        return _fill(_shapes("INNT"), seed=5), innt_from_flax, rec, {}
    if name == "SFIIN":
        return (_fill(_shapes("SFIIN"), seed=6), sfiin_from_flax,
                dict(rec, fre_amp_rec_loss=("l1", 0.1),
                     fre_pha_rec_loss=("l1", 0.1)), {})
    return (_fill(_shapes("MutInf"), seed=7), mutinf_from_flax,
            dict(rec, MI_rec_loss=("l1", 0.1)), {})


MUTINF_BLOCKS = 2   # invertible blocks of the parity tests' MutInf (4 shipped)


def _core(name):
    """The port's core module of `name` as the parity tests build it."""
    if name == "MutInf":
        return GPPNNMutInf(BANDS, block_num=MUTINF_BLOCKS)
    return build_model(name, Config(model_type=name, ms_chans=BANDS),
                       device="cpu").init_params(
        torch.Generator().manual_seed(0)).module


@functools.lru_cache(maxsize=None)
def _shapes(name):
    """The flax tree of `name`'s core module, as JAX's converter makes it
    from the port's weights (no flax trace); `_fill` refills it."""
    return convert_state_dict(name, {k: v.numpy() for k, v in
                                     _core(name).state_dict().items()})


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(the JAX method, its params, a jitted value_and_grad of its
    `losses` in (params, batch, rng, iter_id))."""
    tree, _, loss_cfg, model_cfg = _case(name)
    cfg = JaxConfig(model_type=name, ms_chans=BANDS, max_iter=MAX_ITER,
                    model_cfg=model_cfg,
                    loss_cfg={k: JaxLossCfg(t, w)
                              for k, (t, w) in loss_cfg.items()})
    method = build_jax_model(name, cfg)
    params = {"core_module": jax.tree.map(jnp.asarray, tree)}
    if name == "MutInf":
        method.module = jax_mutinf.GPPNNMutInf(ms_chans=BANDS,
                                               block_num=MUTINF_BLOCKS)
        params["mi"] = jax.tree.map(jnp.asarray, _mi_tree(8))

    @jax.jit
    def value_and_grad(params, batch, key, iter_id):
        return jax.value_and_grad(lambda p: method.losses(
            p, batch, rng=key, iter_id=iter_id)[0])(params)

    return method, params, value_and_grad


def _port(name, monkeypatch=None, whole_chain=True, **kw):
    tree, from_flax, loss_cfg, model_cfg = _case(name)
    if monkeypatch is not None:
        monkeypatch.setenv("LGTEUN_FUSED_TM", "1" if whole_chain else "0")
    cfg = Config(model_type=name, ms_chans=BANDS, max_iter=MAX_ITER,
                 model_cfg=model_cfg,
                 loss_cfg={k: LossCfg(t, w) for k, (t, w) in loss_cfg.items()},
                 **kw)
    port = build_model(name, cfg, device="cpu")
    if name == "MutInf":
        port.module = _core("MutInf")
        port.load_module_state_dict("mi", mi_from_flax(_mi_tree(8)))
    port.load_state_dict(from_flax(tree), strict=True)
    return port


def _grads(module) -> dict:
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in module.named_parameters()}


def _hold(name, module, want_sd: dict, tol: float, skip=()) -> int:
    """Each gradient of `module` against the JAX gradient carried to the
    same key: within `tol` of its tensor's largest value where that is at
    least GRAD_LEVEL of the module's largest gradient, and every tensor
    within that plus GRAD_ATOL of the module's largest (below the level,
    float32 rounding is of the gradient's own size: chip_smoke.py's
    `run_grad_split` holds the card to the CPU so). Returns how many were
    held."""
    pairs = {k: (g.detach().numpy(), want_sd[k].numpy())
             for k, g in _grads(module).items() if k.split(".")[0] not in skip}
    scale = max(float(np.abs(w).max()) for _, w in pairs.values())
    for k, (g, w) in pairs.items():
        top = float(np.abs(w).max())
        err = max_err(g, w)
        bound = tol * top + (0.0 if top >= GRAD_LEVEL * scale
                             else GRAD_ATOL * scale)
        assert err <= bound, (f"{name} {k}: |port - jax| {err:.3e} over "
                              f"{bound:.3e} (tensor max {top:.3e}, module "
                              f"max {scale:.3e})")
    return len(pairs)


def _check_step(name, port, batch, key, iter_id, noise=None):
    """Port loss and gradients vs JAX's on `batch`; returns the parts."""
    method, params, value_and_grad = _jax_case(name)
    want_loss, want_grads = value_and_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.asarray(iter_id, jnp.float32))
    port.train()
    for m in port.modules().values():
        m.zero_grad(set_to_none=True)
    kw = {} if noise is None else {"noise": noise}
    total, parts = port.losses(batch, None, iter_id, **kw)
    total.backward()
    assert abs(total.item() - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss)), (total.item(), float(want_loss))
    _, from_flax, _, _ = _case(name)
    grads_np = jax.tree.map(np.asarray, want_grads)
    skip = ("conv1x1",) if name == "MDCUN" else ()
    assert _hold(name, port.module, from_flax(grads_np["core_module"]),
                 GRAD_TOL[name], skip) > 10
    if name == "MutInf":
        assert _hold(name, port.mi, mi_from_flax(grads_np["mi"]),
                     GRAD_TOL[name]) == 16
    return parts


@pytest.mark.parametrize("name,whole_chain", [
    ("lightnet", True), ("MDCUN", True), ("INNT", True), ("INNT", False),
    ("SFIIN", True)], ids=["lightnet", "MDCUN", "INNT-texture_match",
                           "INNT-patch_match", "SFIIN"])
def test_loss_and_grads_match_jax(name, whole_chain, monkeypatch):
    """One step: the loss within 3e-4 relative and every gradient within
    GRAD_TOL of its tensor's largest, against jax.value_and_grad of the
    JAX Method's losses; SFIIN's parts are its three terms."""
    port = _port(name, monkeypatch, whole_chain)
    parts = _check_step(name, port, _batch32(20), jax.random.PRNGKey(0), 0)
    want = {"rec_loss", "full_loss"} | (
        {"fre_amp_rec_loss", "fre_pha_rec_loss"} if name == "SFIIN" else
        set())
    assert set(parts) == want


@pytest.mark.parametrize("iter_id", [0, 37, 250])
def test_mutinf_loss_and_grads_match_jax(iter_id):
    """MutInf at iteration 0 (ramp 0), mid-ramp and past max_iter (ramp
    1), with JAX's noise for the step's key: the loss, the core module's
    and the `mi` module's gradients."""
    port = _port("MutInf")
    key = jax.random.fold_in(jax.random.PRNGKey(1), iter_id)
    parts = _check_step("MutInf", port, _batch32(21), key, iter_id,
                        noise=_mi_eps(key, 1))
    assert set(parts) == {"rec_loss", "MI_rec_loss", "full_loss"}
    ramp = min(iter_id / MAX_ITER, 1.0)
    assert parts["full_loss"].item() == pytest.approx(
        parts["rec_loss"].item() + 0.1 * ramp * parts["MI_rec_loss"].item(),
        rel=1e-6)


def _reference_mi(sd, feat_a, feat_b, noise):
    """The reference's `Mutual_info_reg` forward with its `view(-1,
    channel * side * side)`, written out on a reference-keyed state_dict
    (NCHW, so (c, h, w) order)."""
    import torch.nn.functional as F

    conv = lambda x, n: F.conv2d(x, sd[f"{n}.weight"], sd[f"{n}.bias"],
                                 stride=2, padding=1)
    lin = lambda x, n: torch.tanh(F.linear(x, sd[f"{n}.weight"],
                                           sd[f"{n}.bias"]))
    fa = conv(F.leaky_relu(conv(feat_a, "layer1"), 0.01), "layer3")
    fb = conv(F.leaky_relu(conv(feat_b, "layer2"), 0.01), "layer4")
    fa, fb = fa.view(fa.shape[0], -1), fb.view(fb.shape[0], -1)
    mu_a, lv_a, mu_b, lv_b = (lin(fa, "fc1_rgb3"), lin(fa, "fc2_rgb3"),
                              lin(fb, "fc1_depth3"), lin(fb, "fc2_depth3"))
    ea, eb = (torch.from_numpy(e) for e in noise)
    dist = lambda mu, lv: torch.distributions.Independent(
        torch.distributions.Normal(mu, torch.exp(lv)), 1)
    kl = torch.distributions.kl_divergence
    da, db = dist(mu_a, lv_a), dist(mu_b, lv_b)
    za = torch.sigmoid(mu_a + torch.exp(0.5 * lv_a) * ea)
    zb = torch.sigmoid(mu_b + torch.exp(0.5 * lv_b) * eb)
    bce = torch.nn.BCELoss(reduction="sum")
    return (bce(za.clamp(1e-7, 1 - 1e-7), zb.detach())
            + bce(zb.clamp(1e-7, 1 - 1e-7), za.detach())
            - kl(da, db).mean() - kl(db, da).mean())


def test_mi_flattens_nchw_and_carries_jax_weights():
    """A reference-keyed `mi` state_dict computes the reference's function
    (NCHW flatten: a port flattening NHWC fails this), and `mi_from_flax`
    (rows permuted (h, w, c) -> (c, h, w)) makes the port compute what
    JAX computes with the tree, value and gradients of the features;
    carrying the Dense kernels by a transpose alone does not."""
    rng = np.random.default_rng(22)
    a, b = (rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
            for _ in range(2))
    noise = tuple(rng.standard_normal((2, 4)).astype(np.float32)
                  for _ in range(2))
    tree = _mi_tree(9)
    nchw = lambda x: torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) \
        .requires_grad_()
    port = MutualInfoReg(side=8)
    sd = mi_from_flax(tree)
    port.load_state_dict(sd)
    ta, tb = nchw(a), nchw(b)
    got = port(ta, tb, noise=noise)
    ref = _reference_mi(sd, ta, tb, noise)
    assert abs(got.item() - ref.item()) <= 1e-5 * abs(ref.item())

    def jax_mi(fa, fb):
        return JaxMI().apply({"params": jax.tree.map(jnp.asarray, tree)},
                             fa, fb, noise=tuple(map(jnp.asarray, noise)))

    want, (ga, gb) = jax.jit(jax.value_and_grad(jax_mi, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    got.backward()
    for g, w in ((ta.grad, ga), (tb.grad, gb)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert max_err(g.numpy(), w) <= 1e-4 * np.abs(w).max()
    naive = {k: (torch.from_numpy(np.asarray(tree[k.split(".")[0]]
                                             ["kernel"]).T.copy())
                 if k.startswith("fc") and k.endswith("weight") else v)
             for k, v in sd.items()}
    port.load_state_dict(naive)
    with torch.no_grad():
        off = port(ta, tb, noise=noise).item()
    assert abs(off - float(want)) > 1e-3 * abs(float(want))


def test_mutinf_train_step_matches_optax():
    """One `Runner.train_step` of MutInf (mid-ramp: both modules get
    gradients): each module's own Adam and StepLR (core lr 8e-4 from
    optim_cfg, `mi` the default 1e-4; step_size 1, so both rates halve)
    against optax's per-module transforms on JAX's gradients; every
    parameter within a few lr."""
    lrs = {"core_module": 8e-4, "mi": 1e-4}
    port = _port("MutInf", optim_cfg={"core_module": OptimCfg(lr=8e-4)},
                 sched_cfg=SchedCfg(step_size=1, gamma=0.5))
    runner = Runner(port.cfg, port, "cpu").set_optim()
    assert {k: o.param_groups[0]["lr"] for k, o in
            runner.optimizers.items()} == lrs
    _, params, value_and_grad = _jax_case("MutInf")
    batch, key, iter_id = _batch32(30), jax.random.PRNGKey(3), 60
    _, grads = value_and_grad(params, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, key,
                              jnp.asarray(iter_id, jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "losses", functools.partial(
            type(port).losses, port, noise=_mi_eps(key, 1)))
        runner.train_step(runner.to_device(batch), iter_id)
    assert [o.param_groups[0]["lr"] for o in runner.optimizers.values()] \
        == [8e-4 / 2, 1e-4 / 2]
    want = {}
    for m, lr in lrs.items():
        # Adam is elementwise: optax steps each module as one raveled
        # vector (the same values; a tree of leaves costs seconds of
        # tracing here)
        tx = jax_make_optimizer(JaxOptimCfg(lr=lr), optax.exponential_decay(
            lr, 1, 0.5, staircase=True))
        vec, unravel = ravel_pytree(params[m])
        upd, _ = tx.update(ravel_pytree(grads[m])[0], tx.init(vec), vec)
        want[m] = jax.tree.map(np.asarray,
                               unravel(optax.apply_updates(vec, upd)))
    want = {"core_module": mutinf_from_flax(want["core_module"]),
            "mi": mi_from_flax(want["mi"])}
    for m, module in port.modules().items():
        for k, p in module.named_parameters():
            assert max_err(p.detach().numpy(), want[m][k].numpy()) \
                <= 2 * lrs[m], (m, k)


class _Items:
    """PSDataset-shaped items in memory, 11-bit DN, 4 bands, PAN 32^2."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        u = lambda *s: rng.uniform(0, 2047, s).astype(np.float32)
        self.items = [{"input_lr": u(8, 8, BANDS), "input_pan": u(32, 32, 1),
                       "target": u(32, 32, BANDS), "image_id": f"i{i}"}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _mutinf_runner(tmp_path, max_iter):
    """A MutInf Runner (2 invertible blocks, batch 1, the MI loss ramped
    over max_iter) on 3 in-memory pairs, initialised from seed 5."""
    cfg = Config(model_type="MutInf", ms_chans=BANDS, max_iter=max_iter,
                 log_freq=1, save_freq=3, eval_freq=0, test_freq=0,
                 work_dir=str(tmp_path), train_set_cfg=LoaderCfg(batch_size=1),
                 optim_cfg={"core_module": OptimCfg(lr=8e-4)},
                 sched_cfg=SchedCfg(step_size=2, gamma=0.5),
                 loss_cfg={"rec_loss": LossCfg("l1", 1.0),
                           "MI_rec_loss": LossCfg("l1", 0.1)})
    method = build_model("MutInf", cfg, device="cpu")
    with torch.device("meta"):
        method.module = _core("MutInf")
    return Runner(cfg, method, "cpu", train_ds=_Items(3, 23)).init(5)


def test_mutinf_checkpoint_resumes_bit_equal(tmp_path):
    """Save at iteration 3, load into a fresh Runner, train to 5: both
    modules' weights, both optimizers' moments and both learning rates
    equal an uninterrupted run's bit for bit; the checkpoint holds the
    core module's reference-keyed state_dict and `mi` by name; init
    sized `mi` for the data's PAN side (32: heads 4 x 8 x 8 wide)."""
    straight = _mutinf_runner(tmp_path, 5).train()
    assert straight.method.mi.fc1_rgb3.in_features == 4 * 8 * 8
    path = tmp_path / "synthetic" / "train_out" / "model_iter_3.pt"
    payload = torch.load(path, weights_only=True)
    assert set(payload["state_dict"]) == set(
        straight.method.module.state_dict())
    assert set(payload["modules"]) == {"mi"}
    assert set(payload["optimizers"]) == set(payload["schedulers"]) == {
        "core_module", "mi"}
    resumed = _mutinf_runner(tmp_path, 5)
    resumed.load_checkpoint(str(path)).set_optim()
    assert resumed.last_iter == 3
    resumed.train()
    for name in ("core_module", "mi"):
        a = straight.method.modules()[name].state_dict()
        b = resumed.method.modules()[name].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
        sa, sb = (r.optimizers[name].state_dict()["state"]
                  for r in (straight, resumed))
        assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"])
                   for i in sa), name
        assert straight.schedulers[name].get_last_lr() == \
            resumed.schedulers[name].get_last_lr()
    assert [p for _, p in straight.loss_log][3:] == \
        [p for _, p in resumed.loss_log]


def test_one_optimizer_checkpoint_still_loads(tmp_path):
    """A checkpoint in the form written before the port trained two
    modules (the core state_dict, one "optimizer", one "scheduler") loads
    and resumes as the core module's: its moments and schedule restored,
    the `mi` optimiser fresh."""
    runner = _mutinf_runner(tmp_path, 2).train()
    old = {"state_dict": runner.method.state_dict(), "iter_num": 2,
           "optimizer": runner.optimizer.state_dict(),
           "scheduler": runner.scheduler.state_dict()}
    path = tmp_path / "old.pt"
    torch.save(old, path)
    fresh = _mutinf_runner(tmp_path, 4)
    fresh.load_checkpoint(str(path)).set_optim()
    assert fresh.last_iter == 2
    got = fresh.optimizer.state_dict()["state"]
    want = old["optimizer"]["state"]
    assert all(torch.equal(got[i]["exp_avg_sq"], want[i]["exp_avg_sq"])
               for i in want)
    assert fresh.scheduler.get_last_lr() == runner.scheduler.get_last_lr()
    assert fresh.optimizers["mi"].state_dict()["state"] == {}
    fresh.train()
    assert fresh.last_iter == 4


@pytest.mark.parametrize("side", [32, 48])
def test_sfiin_self_conjugate_bins(side):
    """`spectrum_amp_phase` against JAX's rfft2 + `_safe_amp_pha` (XLA's
    CPU FFT) on planes with a negative mean. At the power-of-two side
    both hold the self-conjugate bins exactly real (+0.0), so the
    amplitude and phase there are the same bits and a negative real part
    takes +pi in both. At 48 XLA leaves rounding noise in those bins
    (ROADMAP C.22): the port takes its own FFT's values there as they
    are, and the phases agree modulo 2 pi; elsewhere the two agree to
    float32 FFT rounding at every side."""
    rng = np.random.default_rng(side)
    x = (rng.standard_normal((2, side, side, 3)) - 0.5).astype(np.float32)
    amp, pha = (v.numpy().transpose(0, 2, 3, 1) for v in spectrum_amp_phase(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy())))
    re, im = rfft2_pair(jnp.asarray(x), axes=(-3, -2), norm="backward")
    j_amp, j_pha = (np.asarray(v) for v in _safe_amp_pha(re, im))
    h2 = side // 2
    bins = (slice(None), [0, 0, h2, h2], [0, h2, 0, h2])
    if side == 32:
        assert np.array_equal(np.asarray(im)[bins], np.zeros((2, 4, 3)))
        assert np.array_equal(amp[bins], j_amp[bins])
        assert np.array_equal(pha[bins], j_pha[bins])
        assert (pha[bins] == np.float32(np.pi)).any()
    else:
        assert np.any(np.asarray(im)[bins] != 0)
        z = torch.fft.rfft2(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        own = torch.atan2(z.imag, z.real).numpy().transpose(0, 2, 3, 1)
        assert np.array_equal(pha[bins], own[bins])
    assert max_err(amp, j_amp) <= 1e-5 * np.abs(j_amp).max()
    wrap = np.angle(np.exp(1j * (pha.astype(np.float64) - j_pha)))
    assert np.abs(wrap).max() <= 1e-4


def _b_cases(rng):
    """name -> (module holding `_train_entry` and the kernel call, the
    kernel call's name, its plain version, float64 inputs, fixed args)."""
    d = lambda *s: torch.from_numpy(rng.standard_normal(s) * 0.5)
    layers = [[d(*shape) for shape in ((cout, cin, 1, 1), (cout,),
                                       (cout, 1, 3, 3), (cout,)) * 2]
              for _n, cin, cout, _r in lightnet_kernel.lightnet_layers(2)]
    unit = lambda t, dim: t / t.norm(dim=dim, keepdim=True)
    return {
        "lightnet_stack": (lightnet_kernel, "_stack_kernel",
                           lambda x, lms, lay: lightnet_kernel
                           .lightnet_stack_ref(x, lms, lay),
                           [d(1, 3, 6, 6), d(1, 2, 6, 6)], (layers,)),
        "neighborhood_attention": (
            nonlocal_kernel, "_na_kernel",
            nonlocal_kernel.neighborhood_attention_ref,
            [d(1, 3, 5, 6)] + [d(3, 3) for _ in range(4)], (3,)),
        "texture_match": (texture_match_kernel, "_tm_kernel",
                          texture_match_kernel.texture_match_ref,
                          [d(2, 2, 16), d(2, 2, 16)], ()),
        "patch_match": (patch_match_kernel, "_pm_kernel",
                        patch_match_kernel.patch_match_ref,
                        [unit(d(2, 9, 5), 2), unit(d(2, 9, 5), 2),
                         d(2, 5, 9)], ()),
    }


@pytest.mark.parametrize("name", ["lightnet_stack", "neighborhood_attention",
                                  "texture_match", "patch_match"])
def test_train_entry_recompute(name, monkeypatch):
    """The card's training entry of B9-B12 (`_train_entry`: the kernel
    call inside `ops.autograd.recompute`) with the kernel call patched to
    its plain version, against plain autograd: the same outputs and the
    same gradients of every input and weight (LightNet's 80 layer tensors
    pass as flat tensors; the attention's fs in a closure; the searches'
    two outputs and patch match's three inputs)."""
    mod, kernel_name, plain, inputs, extra = _b_cases(
        np.random.default_rng(24))[name]
    if name == "lightnet_stack":
        calls = []

        def kernel(x, lms, layers):
            calls.append([len(layer) for layer in layers])
            return plain(x, lms, layers)
    else:
        calls = []

        def kernel(*t):
            calls.append(len(t))
            return plain(*t)
    monkeypatch.setattr(mod, kernel_name, kernel)
    leaves = [t.requires_grad_() for t in inputs]
    if name == "lightnet_stack":
        weights = [t.requires_grad_() for layer in extra[0] for t in layer]
        leaves += weights
        run = lambda f: f(*inputs, extra[0])
    else:
        run = lambda f: f(*inputs, *extra)

    def loss(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o * (1.0 + 0.5 * i)).sin().sum()
                   for i, o in enumerate(outs))

    got_out = run(mod._train_entry)
    got = torch.autograd.grad(loss(got_out), leaves)
    want_out = run(plain)
    want = torch.autograd.grad(loss(want_out), leaves)
    assert len(calls) == 1
    for g, w in zip(got_out if isinstance(got_out, tuple) else (got_out,),
                    want_out if isinstance(want_out, tuple)
                    else (want_out,)):
        assert torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if name == "lightnet_stack":
        assert calls == [[8] * 10] and len(leaves) == 82


def test_main_trains_mutinf_and_saves_both_modules(tmp_path):
    """`python -m lgteun_tpu_torch.main -c CONFIG --device cpu` without
    --test-only trains MutInf (3 iterations at batch 2 on synthetic
    32^2 pairs), logs both modules' parameter counts, writes a checkpoint
    with `mi` under its name, then scores the test split."""
    made = make_synthetic_dataset(str(tmp_path / "data"), 4, 2, bands=BANDS,
                                  size=32, seed=25, sensor="QB")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f'''
name = "mutinf_train"
model_type = "MutInf"
datas = "GF-2"
ms_chans = {BANDS}
work_dir = "{tmp_path / 'work'}"
log_dir = "{tmp_path / 'logs'}"
train_set_cfg = dict(dataset=dict(type="PSDataset",
                                  image_dirs=["{made['train']}"]),
                     batch_size=2)
test_set1_cfg = dict(dataset=dict(type="PSDataset",
                                  image_dirs=["{made['test']}"]),
                     batch_size=1)
max_iter = 3
log_freq = 1
optim_cfg = {{"core_module": dict(type="Adam", lr=8e-4)}}
loss_cfg = {{"rec_loss": dict(type="l1", w=1.0),
             "MI_rec_loss": dict(type="l1", w=0.1)}}
eval_batch_size = 2
''')
    runner = port_main.cli(["-c", str(cfg), "--device", "cpu"])
    assert runner.last_iter == 3 and len(runner.loss_log) == 3
    assert all(np.isfinite(p["full_loss"]) for _, p in runner.loss_log)
    log = (tmp_path / "logs" / "mutinf_train.log").read_text()
    assert "Total params of module core_module:" in log
    assert "Total params of module mi: 5,152" in log
    payload = torch.load(tmp_path / "work" / "GF-2" / "train_out" /
                         "model_iter_3.pt", weights_only=True)
    assert set(payload["modules"]) == {"mi"}
    assert "[iter 3] reduced-res (ref) psnr:" in log
