"""The port's UnlgFormer training path on the CPU vs the JAX package:
losses, the masked block tail, the loss and every gradient of a step,
Adam + StepLR, the train iterator, the synthetic dataset, checkpoint
resume and dropout.

Same weights (a flax tree mapped with `lgteun_from_flax`), same float32
inputs made with numpy from a seed (conftest turns on jax_enable_x64).
The bounds are those of tests/test_lgteun_fast_train.py:164-172 (loss
3e-6, every gradient 3e-5 max-abs); at this size the largest gradient is
about 0.2 and the two frameworks agree to about 5e-7.
"""

import dataclasses
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import (Config as JaxConfig, LossCfg as JaxLossCfg,
                               OptimCfg as JaxOptimCfg,
                               load_config as jax_load_config)
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.data.dataset import PSDataset as JaxPSDataset
from lgteun_tpu.data.pipeline import train_iterator as jax_train_iterator
from lgteun_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset)
from lgteun_tpu.losses import (build_loss_weights as jax_build_loss_weights,
                               reconstruction_loss as jax_rec_loss)
from lgteun_tpu.ops.ffn_kernel import block_tail_xla, fused_block_tail_cm
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu.runner import make_optimizer as jax_make_optimizer
from lgteun_tpu_torch.config import (Config, LoaderCfg, LossCfg, OptimCfg,
                                     SchedCfg, load_config)
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.data.dataset import PSDataset
from lgteun_tpu_torch.data.pipeline import train_iterator
from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
from lgteun_tpu_torch.losses import build_loss_weights, reconstruction_loss
from lgteun_tpu_torch.ops.ffn_kernel import block_tail_ref
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner, step_generator

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_ops import (_port_ffn, _tail_inputs, f32,  # noqa: E402
                                 max_err)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """These small CPU ops run on one thread: the suite runs in parallel
    workers, whose intra-op thread pools would otherwise oversubscribe
    the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_reconstruction_loss_matches_jax(kind):
    rng = np.random.default_rng(50)
    out, gt = f32(rng, 2, 16, 16, 4), f32(rng, 2, 16, 16, 4)
    got = float(reconstruction_loss(torch.from_numpy(out),
                                    torch.from_numpy(gt), kind))
    want = float(jax_rec_loss(jnp.asarray(out), jnp.asarray(gt), kind))
    assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError, match="unknown"):
        reconstruction_loss(torch.from_numpy(out), torch.from_numpy(gt), "l3")


def test_build_loss_weights_matches_jax():
    cfg = {"rec_loss": LossCfg("l1", 1.0), "QNR_loss": {"w": 0.0},
           "aux": {"type": "l2", "w": 0.5}}
    jcfg = {"rec_loss": JaxLossCfg("l1", 1.0), "QNR_loss": {"w": 0.0},
            "aux": {"type": "l2", "w": 0.5}}
    assert list(build_loss_weights(cfg)) == list(jax_build_loss_weights(jcfg))
    assert list(build_loss_weights(cfg)) == ["rec_loss", "aux"]


@pytest.mark.parametrize("shape", [(1, 8, 16, 16), (2, 16, 16, 16)])
def test_block_tail_mask_matches_jax(shape):
    """block_tail_ref(mask=) vs block_tail_xla(mask=) (1e-5) and the
    Pallas tail with its dropout-mask input in interpret mode (1e-4: its
    GELU is the tanh-form erf) at 16x16 (the roll-based variant)."""
    rng = np.random.default_rng(51)
    x, x1, x2, proj, pb, ffn = _tail_inputs(rng, shape)
    mask = ((rng.uniform(size=shape) < 0.9) / 0.9).astype(np.float32)
    got = block_tail_ref(*map(torch.from_numpy, (x, x1, x2)),
                         torch.from_numpy(np.ascontiguousarray(proj.T)),
                         torch.from_numpy(pb), _port_ffn(ffn),
                         mask=torch.from_numpy(mask)).numpy()
    jffn = {k: jnp.asarray(v) for k, v in ffn.items()}
    jargs = [jnp.asarray(a) for a in (x, x1, x2, proj, pb)]
    jmask = jnp.asarray(mask)
    assert max_err(got, block_tail_xla(*jargs, jffn, mask=jmask)) <= 1e-5
    assert max_err(got, fused_block_tail_cm(*jargs, jffn, mask=jmask,
                                            interpret=True)) <= 1e-4
    unmasked = block_tail_xla(*jargs, jffn)
    assert max_err(got, unmasked) > 1e-3


def _cfgs(drop_rate=0.0, **kw):
    """(port Config, JAX Config) of a 8-band K=2 UnlgFormer with l1."""
    common = dict(ms_chans=BANDS, model_cfg={"core_module": {
        "stage": 2, "drop_rate": drop_rate}})
    return (Config(loss_cfg={"rec_loss": LossCfg("l1", 1.0)}, **common,
                   **kw),
            JaxConfig(loss_cfg={"rec_loss": JaxLossCfg("l1", 1.0)},
                      **common))


def _batch(rng, b=2):
    return {"input_lr": rng.uniform(0, 1, (b, 8, 8, BANDS)).astype(
                np.float32),
            "input_pan": rng.uniform(0, 1, (b, 32, 32, 1)).astype(
                np.float32),
            "target": rng.uniform(0, 1, (b, 32, 32, BANDS)).astype(
                np.float32)}


def _port_grads(method) -> dict:
    """The module's gradients, reference-keyed, zeros where None."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            .numpy() for k, p in method.module.named_parameters()}


@pytest.fixture(scope="module")
def grad_case():
    """Weights, two batches and the JAX Method's losses and gradients of
    a drop-0 step on each (jax.value_and_grad of `Method.losses`)."""
    tree = flax_params(BANDS, seed=7)
    rng = np.random.default_rng(52)
    batches = [_batch(rng) for _ in range(3)]
    _, jcfg = _cfgs()
    method = build_jax_model("UnlgFormer", jcfg)

    @jax.jit
    def value_and_grad(params, batch):
        return jax.value_and_grad(lambda p: method.losses(
            p, batch, rng=jax.random.PRNGKey(0))[0])(params)

    params = {"core_module": jax.tree.map(jnp.asarray, tree)}
    return tree, batches, method, value_and_grad, params


def _hold_grads(got: dict, want_tree, dead: set) -> None:
    """Port gradients (flax layout via convert_state_dict) vs JAX's: the
    dead priors' exactly 0 in JAX (None in the port, `dead`); the rest
    within 3e-5 max-abs."""
    back = convert_state_dict("UnlgFormer", got)
    leaves = jax.tree_util.tree_leaves_with_path(want_tree)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want_tree)
    for (path, want), g in zip(leaves, jax.tree_util.tree_leaves(back)):
        want = np.asarray(want)
        if jax.tree_util.keystr(path).startswith("['prior_0']"):
            assert not np.any(want), path
            continue
        assert max_err(g, want) <= 3e-5, jax.tree_util.keystr(path)
    assert dead and all(k.startswith("prior_module.0.") for k in dead)


def test_unlgformer_loss_and_grads_match_jax(grad_case):
    """One drop-0 step: the port's loss (3e-6) and every gradient vs
    jax.value_and_grad of the JAX Method's losses on the same weights."""
    tree, batches, _, value_and_grad, params = grad_case
    cfg, _ = _cfgs()
    port = build_model("UnlgFormer", cfg, device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    port.train()
    total, parts = port.losses(batches[0])
    total.backward()
    want_loss, want_grads = value_and_grad(params, {
        k: jnp.asarray(v) for k, v in batches[0].items()})
    assert abs(total.item() - float(want_loss)) <= 3e-6
    assert set(parts) == {"rec_loss", "full_loss"}
    dead = {k for k, p in port.module.named_parameters() if p.grad is None}
    _hold_grads(_port_grads(port), want_grads["core_module"], dead)


def test_adam_steplr_matches_optax(grad_case):
    """Three Adam + StepLR steps (step_size 2: the third step runs at
    lr * 0.85) against optax's make_optimizer on the same batches. Adam
    turns a rounding-level sign flip of a tiny gradient into a 2 lr step,
    so the losses and gradients of each step are held, and the
    parameters only to a few lr."""
    tree, batches, method, value_and_grad, params = grad_case
    lr, gamma = 1.5e-3, 0.85
    cfg, _ = _cfgs(optim_cfg={"core_module": OptimCfg(lr=lr)},
                   sched_cfg=SchedCfg(step_size=2, gamma=gamma))
    port = build_model("UnlgFormer", cfg, device="cpu")
    runner = Runner(cfg, port, "cpu")
    runner.load(lgteun_from_flax(tree)).set_optim()
    sched = optax.exponential_decay(lr, 2, gamma, staircase=True)
    tx = jax_make_optimizer(JaxOptimCfg(lr=lr), sched)
    opt_state = tx.init(params)
    for step, batch in enumerate(batches):
        want_loss, want_grads = value_and_grad(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        assert runner.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(sched(step)), rel=1e-12)
        parts = runner.train_step(runner.to_device(batch), step)
        assert abs(float(parts["full_loss"]) - float(want_loss)) <= 3e-5
        dead = {k for k, p in port.module.named_parameters()
                if p.grad is None}
        _hold_grads(_port_grads(port), want_grads["core_module"], dead)
        updates, opt_state = tx.update(want_grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    back = convert_state_dict("UnlgFormer", {
        k: v.detach().numpy() for k, v in port.module.state_dict().items()})
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(params["core_module"])):
        assert max_err(got, want) <= 4 * lr


class _Items:
    """PSDataset-shaped items in memory, in 11-bit DN: LrMS side x side,
    PAN and target 4 side."""

    def __init__(self, n, seed, side=2, bands=3):
        rng = np.random.default_rng(seed)
        u = lambda *shape: rng.uniform(0, 2047, shape).astype(np.float32)
        self.items = [{"input_lr": u(side, side, bands),
                       "input_pan": u(4 * side, 4 * side, 1),
                       "target": u(4 * side, 4 * side, bands),
                       "image_id": f"i{i}"} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("start_iter", [0, 5])
def test_train_iterator_matches_jax(start_iter):
    """The same batches, flips included, for one seed, a batch size that
    does not divide the dataset, and a fast-forward."""
    ds = _Items(5, 53)
    aug = {"lr_flip": 0.5, "ud_flip": 0.5}
    kw = dict(aug_dict=aug, seed=11, start_iter=start_iter)
    got, want = train_iterator(ds, 3, **kw), jax_train_iterator(ds, 3, **kw)
    for _ in range(4):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in g:
            assert np.array_equal(g[k], w[k]), k


def test_synthetic_dataset_matches_jax(tmp_path):
    """`make_synthetic_dataset` writes the JAX package's TIFFs byte for
    byte (WV-3 sensor branch, 8 bands), and PSDataset reads the same
    samples."""
    got = make_synthetic_dataset(str(tmp_path / "port"), 2, 1, bands=BANDS,
                                 size=32, seed=3, sensor="WV3")
    want = jax_make_synthetic_dataset(str(tmp_path / "jax"), 2, 1,
                                      bands=BANDS, size=32, seed=3,
                                      sensor="WV3")
    for split in ("train", "test"):
        names = sorted(os.listdir(got[split]))
        assert names == sorted(os.listdir(want[split])) and names
        for name in names:
            with open(os.path.join(got[split], name), "rb") as a, \
                    open(os.path.join(want[split], name), "rb") as b:
                assert a.read() == b.read(), name
    a, b = PSDataset([got["train"]]), JaxPSDataset([want["train"]])
    assert len(a) == len(b) == 2 and a.ms_chans == BANDS
    for i in range(2):
        assert sorted(a[i]) == sorted(b[i])
        for k, v in a[i].items():
            assert k == "image_id" or np.array_equal(v, b[i][k]), k


def test_train_config_fields_load_as_in_the_jax_package():
    """The train fields of the shipped config read as the JAX package
    reads them; the TPU-only fields stay in extras."""
    path = os.path.join(REPO, "lgteun_tpu", "configs", "unlg_former.py")
    got, want = load_config(path), jax_load_config(path)
    for name in ("train_set_cfg", "test_set0_cfg", "test_set1_cfg",
                 "sched_cfg"):
        assert dataclasses.asdict(getattr(got, name)) == \
            dataclasses.asdict(getattr(want, name)), name
    for name in ("optim_cfg", "loss_cfg"):
        assert {k: dataclasses.asdict(v) for k, v in getattr(got, name)
                .items()} == {k: dataclasses.asdict(v) for k, v in
                              getattr(want, name).items()}, name
    assert got.train_set_cfg.batch_size == 4
    assert got.optim_cfg["core_module"].lr == 1.5e-3
    assert (got.sched_cfg.step_size, got.sched_cfg.gamma) == (22750, 0.85)
    assert "mixed_precision" not in vars(got)


def _train_cfg(tmp_path, max_iter, drop_rate=0.1):
    cfg, _ = _cfgs(drop_rate, max_iter=max_iter, log_freq=2, save_freq=3,
                   eval_freq=0, train_set_cfg=LoaderCfg(batch_size=2),
                   optim_cfg={"core_module": OptimCfg(lr=1.5e-3)},
                   sched_cfg=SchedCfg(step_size=2, gamma=0.85),
                   work_dir=str(tmp_path))
    return cfg


def _state(runner):
    return {k: v.clone() for k, v in runner.method.module.state_dict()
            .items()}


def test_resume_equals_uninterrupted(tmp_path):
    """Save at iteration 3, load into a fresh runner, train to 5: the
    weights, optimizer state and learning rate equal an uninterrupted
    run's bit for bit (dropout on; stateless per-iteration generators;
    the iterator fast-forwarded)."""
    ds = _Items(3, 54, side=8, bands=BANDS)
    make = lambda: Runner(_train_cfg(tmp_path, 5), build_model(
        "UnlgFormer", _train_cfg(tmp_path, 5), device="cpu"), "cpu",
        train_ds=ds).init(5)
    straight = make().train()
    resumed = make()
    resumed.load_checkpoint(str(tmp_path / "synthetic" / "train_out" /
                                "model_iter_3.pt")).set_optim()
    assert resumed.last_iter == 3
    resumed.train()
    assert resumed.last_iter == straight.last_iter == 5
    a, b = _state(straight), _state(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = (r.optimizer.state_dict()["state"] for r in (straight, resumed))
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
               for i in sa)
    assert straight.scheduler.get_last_lr() == resumed.scheduler.get_last_lr()
    pre = make()
    pre.load_pretrained(str(tmp_path / "synthetic" / "train_out" /
                            "model_iter_3.pt"))
    assert pre.last_iter == 0 and pre.optimizer is None


def test_dropout_applied_and_deterministic():
    """In train mode the step's generator (`step_generator`, seeded from
    the seed and the iteration) draws the masks: one iteration gives the
    same loss twice, another iteration another one, no generator (or
    eval mode) none; masks are 0 or 1/keep."""
    cfg, _ = _cfgs(drop_rate=0.1)
    port = build_model("UnlgFormer", cfg, device="cpu")
    port.load_state_dict(lgteun_from_flax(flax_params(BANDS, seed=8)))
    batch = _batch(np.random.default_rng(55), b=1)
    port.train()
    loss = lambda gen: float(port.losses(batch, gen)[0])
    step = lambda it: step_generator(cfg.seed + 1, it, torch.device("cpu"))
    with torch.no_grad():
        a, b, c = loss(step(3)), loss(step(3)), loss(step(4))
        none = loss(None)
        port.eval()
        evaluated = loss(step(3))
    assert a == b and abs(a - c) > 1e-7 and abs(a - none) > 1e-7
    assert evaluated == none
    lgb = port.module.prior_module[1].bottleneck
    lgb.train()
    x = torch.zeros(1, 64, 8, 8)
    mask = lgb._drop_mask(x, torch.Generator().manual_seed(3))
    keep = torch.tensor(1.0, dtype=torch.float32) / 0.9
    assert set(torch.unique(mask).tolist()) <= {0.0, float(keep)}
    assert 0.8 < float((mask > 0).float().mean()) < 0.97


def test_train_eval_train_on_one_module():
    """Eval forwards (inference_mode, cached weight views) between
    training steps never hand autograd a tensor made under
    inference_mode: train -> eval -> train gives every live parameter a
    gradient, and an eval forward sees the updated weights."""
    cfg, _ = _cfgs(drop_rate=0.1, optim_cfg={"core_module": OptimCfg()})
    runner = Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"),
                    "cpu").init(9).set_optim()
    batch = runner.to_device(_batch(np.random.default_rng(56), b=1))
    runner.train_step(batch, 0)
    first = runner.predict(batch).clone()
    runner.train_step(batch, 1)
    second = runner.predict(batch)
    assert not torch.equal(first, second)
    runner.train_step(batch, 2)
    live = [p for k, p in runner.method.module.named_parameters()
            if not k.startswith("prior_module.0.")]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in live)
