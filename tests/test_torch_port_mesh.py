"""Data parallelism of the port on the CPU (`lgteun_tpu_torch/parallel/
mesh.py`, `parallel/ranks.py`; the Runner, the scene engine and the
entry point on a mesh) against the one-rank port and the JAX package.

Two ranks are spawned processes (`ranks.spawn`: torch.multiprocessing's
spawn start method, gloo, a file:// rendezvous under tmp_path, no port);
they import the port alone (each rank reports that nothing imported
jax). The checks are grouped into two spawns:

- UnlgFormer (stage 1, 4 bands, 64 px, batch 4; weights from
  `flax_params` with integer phase scales, as tests/test_torch_port_
  scene.py): 3 Adam steps at drop 0 and at drop 0.1, a save and resume,
  `Runner.test` of both splits with TIFFs, `fuse_scene(mesh=)`, and
  `main.cli` under the launcher's environment;
- one step each of the three loss terms that are no plain mean of
  per-row values: MutInf mid-ramp (`mi`: BCE sums and a mean KL before a
  clip; the regulariser also alone, with drawn and injected noise), a
  weighted `QNR_loss` (|differences| of batch means) and a WGAN-GP
  adversarial step (its eps drawn per row); and one step of each
  training mode on two ranks (remat, mixed_precision selective and
  blanket).

Bounds: parameters after Adam steps by `tests/test_multichip.py::
_assert_params_equivalent`'s criterion (the JAX package's 8-device vs
1-device check); the two ranks' parameters bit-equal; the summed first
gradient against JAX's `jax.value_and_grad` on a {"data": 2} mesh of
conftest's virtual CPU devices at tests/test_torch_port_train.py's
bounds (loss 3e-6, every gradient 3e-5 max-abs); one step's gradients
and loss parts against the one-rank port within float32 summation-order
noise (GRAD_REL of each tensor's largest, PART_REL; a bf16 rounding,
BF16_REL and BF16_PART, under mixed_precision); the scene at
tests/test_scene.py:115-123's rtol 1e-5 / atol 1e-6 and against JAX's
`fuse_scene(mesh=)` at the port's scene parity bound 5e-4.
"""

import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lgteun_tpu.models  # noqa: F401  (registers the JAX methods)
from lgteun_tpu.config import Config as JaxConfig, LossCfg as JaxLossCfg
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.parallel import scene as jax_scene
from lgteun_tpu.parallel.mesh import (batch_sharding as jax_batch_sharding,
                                      make_mesh as jax_make_mesh,
                                      replicated as jax_replicated,
                                      shard_batch as jax_shard_batch)
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu.runner import Runner as JaxRunner
from lgteun_tpu_torch.config import (Config, DatasetCfg, LoaderCfg, LossCfg,
                                     OptimCfg, load_config)
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.data.dataset import PSDataset
from lgteun_tpu_torch.data.pipeline import train_iterator
from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
from lgteun_tpu_torch.parallel import ranks
from lgteun_tpu_torch.parallel import scene
from lgteun_tpu_torch.parallel.mesh import (Mesh, Shard, ShardGenerator,
                                            make_mesh, shard_batch)
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner, step_generator

sys.path.insert(0, os.path.dirname(__file__))
from test_multichip import _assert_params_equivalent  # noqa: E402
from test_torch_port_convert import flax_params  # noqa: E402

BANDS, SIDE, BATCH, LR = 4, 64, 4, 1e-3
SPACE_SHAPE = {"data": 1, "space": 2}
# Adam's eps in the runs held by `_assert_params_equivalent`: 1e-3, as
# tests/test_multichip.py::_cfg gives the JAX package's equivalence runs
# (at 1e-8 the first update is lr * sign(g) for every element, so a
# near-zero gradient whose float32 sum flips sign moves a full lr)
ADAM_EPS = 1e-3
# one step on two ranks vs one: float32 sums in another order; each
# gradient within GRAD_REL of its tensor's largest plus GRAD_ATOL of the
# largest gradient of the step (PERF.md section 2's atol of a training
# step against another summation order: a bias gradient is a cancelling
# sum over every pixel of the batch), each loss part within PART_REL
GRAD_REL, GRAD_ATOL, PART_REL = 1e-4, 1e-5, 1e-5
# D_s's 41x41 MTF lowpass of the PAN: the CPU convolution sums its 1681
# taps in another order at another batch size (a few float32 steps of a
# value about 0.25; QNR takes D_s)
D_S_NOISE, D_S_ATOL = ("d_s", "qnr"), 1e-5
# mixed_precision, two ranks vs one: the bf16 values are rounded once on
# each side of another summation order (2^-8 of a value each), so each
# gradient within BF16_REL of its tensor's largest and each loss part
# within BF16_PART
BF16_REL, BF16_PART = 2.0 ** -7, 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process, as each spawned rank runs (the
    one-rank and two-rank runs then differ only by the batch's split; the
    suite runs in parallel workers besides)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """64 px train and test splits, and 128 px scenes for the no-reference
    split (D_lambda's 32 px blocks on the LrMS)."""
    root = tmp_path_factory.mktemp("mesh_data")
    dirs = make_synthetic_dataset(str(root), n_train=8, n_test=6,
                                  bands=BANDS, size=SIDE, seed=18)
    dirs["full"] = make_synthetic_dataset(str(root / "full"), n_train=0,
                                          n_test=6, bands=BANDS, size=128,
                                          seed=19)["test"]
    return dirs


def _cfg(data, work, model_type="UnlgFormer", drop=0.0, **kw):
    loader = lambda split, bs: LoaderCfg(
        dataset=DatasetCfg(image_dirs=[data[split]]), batch_size=bs)
    model_cfg = ({"core_module": {"stage": 1, "drop_rate": drop}}
                 if model_type == "UnlgFormer" else {})
    base = dict(model_type=model_type, ms_chans=BANDS, max_iter=3,
                log_freq=1, save_freq=0, eval_freq=0, test_freq=0,
                train_set_cfg=loader("train", BATCH),
                test_set1_cfg=loader("test", 1),
                test_set0_cfg=loader("full", 1), eval_batch_size=4,
                loss_cfg={"rec_loss": LossCfg("l1", 1.0)},
                optim_cfg={k: OptimCfg(lr=LR, eps=ADAM_EPS)
                           for k in ("core_module", "mi", "discriminator")},
                model_cfg=model_cfg, work_dir=str(work))
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def tree():
    """UnlgFormer's flax weights (stage 1, 4 bands) for training."""
    return flax_params(BANDS, stage=1)


@pytest.fixture(scope="module")
def scene_tree():
    """The same with integer phase scales, as tests/test_torch_port_
    scene.py gives the scene engines (ROADMAP C.9: the CPU XLA FFT's
    self-conjugate bins)."""
    rng = np.random.default_rng(30)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.choice([-2.0, -1.0, 1.0, 2.0], v.shape).astype(
            np.float32) if path[-1].key == "pha_scale" else v),
        flax_params(BANDS, stage=1))


def _numpy(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def _scene_inputs():
    rng = np.random.default_rng(32)
    ms = rng.uniform(0.1, 0.9, (24, 24, BANDS)).astype(np.float32)
    pan = rng.uniform(0.1, 0.9, (96, 96, 1)).astype(np.float32)
    return ms, pan


@pytest.fixture(scope="module")
def unlg(data, tree, scene_tree, tmp_path_factory):
    """The UnlgFormer spawn and its one-rank twin."""
    root = tmp_path_factory.mktemp("mesh_unlg")
    weights = _numpy(lgteun_from_flax(tree))
    scene_weights = _numpy(lgteun_from_flax(scene_tree))
    ms, pan = _scene_inputs()

    def jobs(tag):
        work = root / tag
        cli_cfg = root / f"cli_{tag}.py"
        cli_cfg.write_text(
            "model_type = 'UnlgFormer'\nms_chans = 4\nmax_iter = 2\n"
            "log_freq = 1\nsave_freq = 0\neval_freq = 0\ntest_freq = 0\n"
            "eval_batch_size = 4\nname = 'mesh'\n"
            f"work_dir = {str(work / 'cli')!r}\n"
            f"log_dir = {str(work / 'logs')!r}\n"
            "loss_cfg = {'rec_loss': dict(type='l1', w=1.0)}\n"
            "model_cfg = {'core_module': dict(stage=1)}\n"
            "train_set_cfg = dict(dataset=dict(image_dirs="
            f"[{data['train']!r}]), batch_size=4)\n"
            "test_set1_cfg = dict(dataset=dict(image_dirs="
            f"[{data['test']!r}]), batch_size=1)\n")
        return [
            (ranks.train_job, dict(cfg=_cfg(data, work / "d0"), stops=(1,),
                                   weights=weights)),
            (ranks.train_job, dict(cfg=_cfg(data, work / "d1", drop=0.1),
                                   weights=weights)),
            (ranks.test_job, dict(cfg=_cfg(data, work / "test"),
                                  weights=weights)),
            (ranks.resume_job, dict(cfg=_cfg(data, work / "resume",
                                             max_iter=4),
                                    save_at=2, weights=weights)),
            (ranks.scene_job, dict(cfg=_cfg(data, work / "scene"), ms=ms,
                                   pan=pan, tile=32, halo=8, batch=4,
                                   weights=scene_weights)),
            (ranks.cli_job, dict(argv=["-c", str(cli_cfg), "--device",
                                       "cpu"])),
        ]

    one = [job(make_mesh(device="cpu"), **kw) for job, kw in jobs("one")]
    # and, on the two ranks only, the first job on a {"data": 1, "space":
    # 2} mesh laid over them (its one-rank twin is job 0)
    space = (ranks.train_job, dict(
        cfg=_cfg(data, root / "two" / "space", mesh_shape=SPACE_SHAPE),
        stops=(1,), weights=weights, mesh_shape=SPACE_SHAPE))
    two = ranks.spawn(jobs("two") + [space], 2, str(root / "spawn"),
                      device="cpu")
    return {"one": one, "two": two, "root": root, "weights": weights}


def _ranks_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _leaves(state: dict) -> list:
    return [state[k] for k in sorted(state)]


def test_spawned_ranks_import_no_jax(unlg):
    assert all(not r["jax_imported"] for rank in unlg["two"] for r in rank)


# ------------------------------------------------------------------- (a)

@pytest.mark.parametrize("n", [4, 8])
def test_shard_batch_rows_match_jax_named_sharding(n):
    """Rank r keeps the rows that JAX's NamedSharding(mesh, P("data"))
    puts on device r of a {"data": 2} mesh."""
    rng = np.random.default_rng(1)
    batch = {"input_lr": rng.normal(size=(n, 4, 4, BANDS)).astype(
        np.float32), "input_pan": rng.normal(size=(n, 16, 16, 1)).astype(
        np.float32), "image_id": [f"im{i}" for i in range(n)]}
    mesh = jax_make_mesh({"data": 2})
    sharded = jax_shard_batch(batch, mesh)
    for r, device in enumerate(mesh.devices.flat):
        got = shard_batch(batch, Mesh(rank=r, world=2))
        for k in ("input_lr", "input_pan"):
            want, = [s.data for s in sharded[k].addressable_shards
                     if s.device == device]
            assert np.array_equal(got[k], np.asarray(want)), (r, k)
        assert got["image_id"] == batch["image_id"][r * n // 2:
                                                    (r + 1) * n // 2]


def test_shard_batch_replicates_as_the_jax_runner():
    """B % W != 0: every rank keeps the whole batch, as the JAX Runner's
    `_put_batch` replicates it on every device."""
    batch = {"input_lr": np.arange(3 * 2, dtype=np.float32).reshape(3, 2)}
    mesh = jax_make_mesh({"data": 2})
    jax_runner = type("R", (), {"n_devices": 2,
                                "batch_sharding": jax_batch_sharding(mesh),
                                "param_sharding": jax_replicated(mesh)})()
    put = JaxRunner._put_batch(jax_runner, batch)["input_lr"]
    assert all(np.array_equal(np.asarray(s.data), batch["input_lr"])
               for s in put.addressable_shards)
    for r in range(2):
        got = shard_batch(batch, Mesh(rank=r, world=2))
        assert np.array_equal(got["input_lr"], batch["input_lr"])
    assert Mesh(rank=1, world=2).shard(3) is None


def test_space_mesh_runner_step_equals_one_rank(unlg):
    """A Runner on a {"data": 1, "space": 2} mesh over two spawned ranks
    (the JAX Runner's P("data") batch sharding: both ranks of the space
    group hold the whole batch; the gradients reduce over the data group
    alone, here one rank, so not at all): the parameters after 3 steps,
    the gradients of step 1 and the loss log of each rank equal the
    one-rank run's bit for bit."""
    one = unlg["one"][0]
    for rank in unlg["two"]:
        got = rank[6]
        _ranks_bit_equal(got["state"], one["state"])
        assert got["loss_log"] == one["loss_log"]
        for k, g in one["grads"][1].items():
            assert (g is None) == (got["grads"][1][k] is None), k
            assert g is None or np.array_equal(got["grads"][1][k], g), k


# ------------------------------------------------------------------- (b)

def test_unlgformer_two_ranks_train_as_one(unlg):
    """Drop 0, 3 Adam steps: the ranks' parameters bit-equal, the
    two-rank parameters equivalent to the one-rank port's, the logged
    losses (the global batch's) within float32 noise."""
    one, (two0, two1) = unlg["one"][0], [r[0] for r in unlg["two"]]
    _ranks_bit_equal(two0["state"], two1["state"])
    _assert_params_equivalent(_leaves(two0["state"]), _leaves(one["state"]),
                              lr=LR, label="2 ranks vs 1")
    assert [it for it, _ in two0["loss_log"]] == [1, 2, 3]
    for (_, a), (_, b) in zip(two0["loss_log"], one["loss_log"]):
        assert abs(a["rec_loss"] - b["rec_loss"]) <= PART_REL * b["rec_loss"]
    assert two0["loss_log"] == two1["loss_log"]


def test_unlgformer_summed_gradient_matches_jax_mesh(unlg, data, tree):
    """The first step's gradient summed over the two ranks against JAX's
    gradient of the same loss under jax.jit on a {"data": 2} mesh (the
    JAX Runner's data parallelism), at test_torch_port_train.py's
    bounds; the logged loss against JAX's."""
    two0 = unlg["two"][0][0]
    cfg = _cfg(data, unlg["root"] / "unused")
    batch = next(train_iterator(PSDataset([data["train"]]), BATCH,
                                seed=cfg.seed))
    jcfg = JaxConfig(model_type="UnlgFormer", ms_chans=BANDS,
                     loss_cfg={"rec_loss": JaxLossCfg("l1", 1.0)},
                     model_cfg={"core_module": {"stage": 1,
                                                "drop_rate": 0.0}})
    method = build_jax_model("UnlgFormer", jcfg)
    mesh = jax_make_mesh({"data": 2})

    @jax.jit
    def value_and_grad(params, batch):
        return jax.value_and_grad(lambda p: method.losses(
            p, batch, rng=jax.random.PRNGKey(0))[0])(params)

    params = jax.device_put({"core_module": jax.tree.map(jnp.asarray, tree)},
                            jax_replicated(mesh))
    loss, grads = value_and_grad(params, jax_shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    assert abs(two0["loss_log"][0][1]["rec_loss"] - float(loss)) <= 3e-6
    got = {k.removeprefix("core_module."): v
           for k, v in two0["grads"][1].items()}
    back = convert_state_dict("UnlgFormer", {
        k: np.zeros_like(unlg["weights"][k]) if v is None else v
        for k, v in got.items()})
    want = jax.tree_util.tree_leaves_with_path(grads["core_module"])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        grads["core_module"])
    for (path, w), g in zip(want, jax.tree_util.tree_leaves(back)):
        assert float(np.max(np.abs(g - np.asarray(w)))) <= 3e-5, \
            jax.tree_util.keystr(path)


# ------------------------------------------------------------------- (c)

def test_unlgformer_dropout_two_ranks_train_as_one(unlg):
    """Drop 0.1, 3 Adam steps: the two-rank run (each rank's masks its
    rows of the one-rank masks) trains as the one-rank run."""
    one, (two0, two1) = unlg["one"][1], [r[1] for r in unlg["two"]]
    _ranks_bit_equal(two0["state"], two1["state"])
    _assert_params_equivalent(_leaves(two0["state"]), _leaves(one["state"]),
                              lr=LR, label="drop 0.1, 2 ranks vs 1")


def test_dropout_masks_are_rows_of_the_one_rank_masks(data, tree,
                                                      monkeypatch):
    """A training forward at drop 0.1: the masks that rank r draws from
    its ShardGenerator are rows r*B/2.. of the masks of the one-rank
    forward at the same seed, and the two ranks' masks differ."""
    from lgteun_tpu_torch.models.common import lgt

    masks = []
    real_draw = lgt.mesh.draw
    monkeypatch.setattr(lgt.mesh, "draw", lambda *a: masks.append(
        real_draw(*a)) or masks[-1])
    method = build_model("UnlgFormer", _cfg(data, "unused", drop=0.1),
                         device="cpu")
    method.load_state_dict(lgteun_from_flax(tree))
    method.train()
    batch = next(train_iterator(PSDataset([data["train"]]), BATCH, seed=5))
    ms = torch.from_numpy(batch["input_lr"]).permute(0, 3, 1, 2)
    pan = torch.from_numpy(batch["input_pan"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        method.forward(ms, pan, step_generator(7, 3, "cpu"))
        full, masks[:] = list(masks), []
        per_rank = []
        for r in range(2):
            rows = slice(2 * r, 2 * r + 2)
            shard = Shard(Mesh(rank=r, world=2), rows.start, rows.stop, 4)
            gen = ShardGenerator("cpu", shard).manual_seed(
                step_generator(7, 3, "cpu").initial_seed())
            method.forward(ms[rows], pan[rows], gen)
            per_rank.append(list(masks))
            masks[:] = []
    assert len(full) == len(per_rank[0]) == len(per_rank[1]) > 0
    for r, got in enumerate(per_rank):
        for g, f in zip(got, full):
            assert torch.equal(g, f[2 * r:2 * r + 2])
    assert all(not torch.equal(a, b) for a, b in zip(*per_rank))


# ------------------------------------------------------------------- (d)

@pytest.fixture(scope="module")
def traps(data, tmp_path_factory):
    """One step each, one rank and two, with an l2 rec_loss (l1's sign()
    would turn a float32 difference of the forward at another batch size,
    where output and target nearly tie, into a discrete gradient step),
    and the Runner's modes on two ranks (remat, mixed_precision in both
    forms): MutInf at iteration 3 of 4 (the
    ramp at 0.75; its `mi` clipped at 1, as at this size it is, so the
    `mi` regulariser is also held alone, with drawn and with injected
    noise), UnlgFormer with l1 + 0.1 QNR_loss, and UnlgFormer with
    a WGAN-GP PatchDiscriminator."""
    root = tmp_path_factory.mktemp("mesh_traps")
    disc = dict(type="PatchDiscriminator", n_feats=8, n_layers=2,
                norm_type="IN")

    batch = next(train_iterator(PSDataset([data["train"]]), BATCH,
                                seed=11))
    noise = tuple(np.random.default_rng(12).normal(size=(BATCH, 4)).astype(
        np.float32) for _ in range(2))

    def jobs(tag):
        w = root / tag
        mi_cfg = _cfg(data, w / "mi", "MutInf")
        return [
            (ranks.train_job, dict(cfg=_cfg(
                data, w / "mutinf", "MutInf", max_iter=4,
                loss_cfg={"rec_loss": LossCfg("l2", 1.0),
                          "MI_rec_loss": LossCfg("l1", 0.1)},
                model_cfg={}), start=3)),
            (ranks.train_job, dict(cfg=_cfg(
                data, w / "qnr", max_iter=1,
                loss_cfg={"rec_loss": LossCfg("l2", 1.0),
                          "QNR_loss": LossCfg("qnr", 0.1)}))),
            (ranks.train_job, dict(cfg=_cfg(
                data, w / "wgan", max_iter=1,
                loss_cfg={"rec_loss": LossCfg("l2", 1.0),
                          "adv_loss": LossCfg("WGAN-GP", 1e-2)},
                model_cfg={"core_module": {"stage": 1, "drop_rate": 0.0},
                           "discriminator": disc}))),
            (ranks.mi_job, dict(cfg=mi_cfg, batch=batch, iter_id=2)),
            (ranks.mi_job, dict(cfg=mi_cfg, batch=batch, noise=noise)),
            (ranks.train_job, dict(cfg=_cfg(
                data, w / "remat", drop=0.1, max_iter=1,
                loss_cfg={"rec_loss": LossCfg("l2", 1.0)},
                extras={"remat": True}))),
            (ranks.train_job, dict(cfg=_cfg(
                data, w / "mixed", max_iter=1,
                loss_cfg={"rec_loss": LossCfg("l2", 1.0)},
                extras={"mixed_precision": True}))),
            (ranks.train_job, dict(cfg=_cfg(
                data, w / "blanket", "lightnet", max_iter=1,
                loss_cfg={"rec_loss": LossCfg("l2", 1.0)},
                extras={"mixed_precision": True}))),
        ]

    one = [job(make_mesh(device="cpu"), **kw) for job, kw in jobs("one")]
    two = ranks.spawn(jobs("two"), 2, str(root / "spawn"), device="cpu")
    return one, two


def _hold_step(one: dict, two: list, modules: set, rel: float = GRAD_REL,
               part_rel: float = PART_REL) -> None:
    """One step on two ranks against one rank: the loss parts (within
    `part_rel`), every module's gradients (reduced; `_hold_grads` at
    `rel`), the parameters, and the ranks' parameters bit-equal."""
    a, b = two
    _ranks_bit_equal(a["state"], b["state"])
    (_, got), = a["loss_log"]
    (_, want), = one["loss_log"]
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= part_rel * abs(want[k]) + 1e-7, k
    g_two, g_one = a["grads"][max(a["grads"])], one["grads"][max(
        one["grads"])]
    assert {k.split(".")[0] for k, v in g_one.items()
            if v is not None} == modules
    _hold_grads(g_one, g_two, rel)
    _assert_params_equivalent(_leaves(a["state"]), _leaves(one["state"]),
                              lr=LR, label="one step, 2 ranks vs 1")


def _hold_grads(one: dict, two: dict, rel: float = GRAD_REL) -> None:
    """Two ranks' reduced gradients against one rank's: each within `rel`
    of its tensor's largest plus GRAD_ATOL of the largest."""
    largest = max(float(np.max(np.abs(v))) for v in one.values()
                  if v is not None)
    for k, want in one.items():
        if want is None:
            assert two[k] is None, k
            continue
        err = float(np.max(np.abs(two[k] - want)))
        assert err <= (rel * float(np.max(np.abs(want)))
                       + GRAD_ATOL * largest), k


def test_mutinf_step_two_ranks_as_one(traps):
    """A MutInf step at iteration 3 of 4 (rec_loss and the ramped, clipped
    `mi` term) on two ranks as on one."""
    one, two = traps
    _hold_step(one[0], [r[0] for r in two], {"core_module", "mi"})
    (_, parts), = one[0]["loss_log"]
    assert parts["MI_rec_loss"] > 0


@pytest.mark.parametrize("job", [3, 4], ids=["drawn", "injected"])
def test_mutinf_mi_regulariser_two_ranks_as_one(traps, job):
    """The `mi` regulariser before its clip (BCE sums over the batch and a
    mean KL: averaging the ranks' values would halve the sums) with the
    noise drawn (each rank its rows of the global draw) or injected (each
    rank its rows of the given eps): the global batch's value and its
    gradients in the core and `mi` modules, on both ranks."""
    one, two = traps
    want, (a, b) = one[job], [r[job] for r in two]
    assert a["value"] == b["value"]
    assert abs(a["value"] - want["value"]) <= PART_REL * abs(want["value"])
    assert abs(want["value"]) > 1
    _ranks_bit_equal({k: v for k, v in a["grads"].items() if v is not None},
                     {k: v for k, v in b["grads"].items() if v is not None})
    assert {k.split(".")[0] for k, v in want["grads"].items()
            if v is not None} == {"core_module", "mi"}
    _hold_grads(want["grads"], a["grads"])


def test_qnr_loss_two_ranks_as_one(traps):
    """l1 + 0.1 QNR: D_lambda and D_s from the global batch's per-image
    Q means."""
    one, two = traps
    _hold_step(one[1], [r[1] for r in two], {"core_module"})


def test_wgan_gp_step_two_ranks_as_one(traps):
    """The adversarial step: the discriminator's gradients reduced
    before its step, the generator's after the G term; WGAN-GP's eps
    rows of the one-rank draw."""
    one, two = traps
    _hold_step(one[2], [r[2] for r in two], {"core_module", "discriminator"})


def test_remat_step_two_ranks_as_one(traps):
    """remat at drop 0.1: the checkpointed loss replays its collectives
    and its draws (the rank's rows of the global masks) in the
    backward."""
    one, two = traps
    _hold_step(one[5], [r[5] for r in two], {"core_module"})


@pytest.mark.parametrize("job", [6, 7], ids=["selective", "blanket"])
def test_mixed_precision_step_two_ranks_as_one(traps, job):
    """mixed_precision: UnlgFormer's selective bf16 blocks and LightNet
    under the blanket cast (the loss shares reduced in bf16), two ranks
    as one within a bf16 rounding."""
    one, two = traps
    _hold_step(one[job], [r[job] for r in two], {"core_module"},
               rel=BF16_REL, part_rel=BF16_PART)


# ------------------------------------------------------------------- (e)

def test_runner_test_two_ranks_scores_as_one(unlg):
    """Both splits (6 images, eval batch 4: the second batch's two real
    rows on rank 0 alone): eval_results and image_scores equal the
    one-rank run's (the forward and every metric bit-equal but D_s and
    the QNR made from it, within D_S_ATOL); each TIFF written once, by
    the rank that scored it, and equal to the one-rank run's."""
    one, two = unlg["one"][2], [r[2] for r in unlg["two"]]
    for r in two:
        assert r["image_scores"].keys() == one["image_scores"].keys()
        for tag, scores in one["image_scores"].items():
            assert r["image_scores"][tag]["image_id"] == scores["image_id"]
            for k, v in scores.items():
                if k in D_S_NOISE:
                    np.testing.assert_allclose(r["image_scores"][tag][k], v,
                                               rtol=0, atol=D_S_ATOL)
                elif k != "image_id":
                    assert r["image_scores"][tag][k] == v, (tag, k)
        for key, curve in one["eval_results"].items():
            if key.split("/")[1] in D_S_NOISE:
                np.testing.assert_allclose(r["eval_results"][key], curve,
                                           rtol=0, atol=D_S_ATOL)
            else:
                assert r["eval_results"][key] == curve, key
    for ref in (True, False):
        written = two[0]["outputs"][ref] + two[1]["outputs"][ref]
        names = [os.path.basename(p) for p in written]
        assert len(names) == len(set(names)) == 6
        assert sorted(names) == sorted(os.path.basename(p)
                                       for p in one["outputs"][ref])
        assert len(two[1]["outputs"][ref]) == 2
        from lgteun_tpu_torch.data.tiff import read_tiff
        for p in written:
            want = [q for q in one["outputs"][ref]
                    if os.path.basename(q) == os.path.basename(p)][0]
            assert np.abs(read_tiff(p).astype(np.int64)
                          - read_tiff(want).astype(np.int64)).max() <= 1


# ------------------------------------------------------------------- (f)

def test_resume_on_two_ranks_equals_the_straight_run(unlg):
    """Rank 0 saves at iteration 2 (every rank waits for it); a fresh
    two-rank Runner resumes from it to iteration 4: bit-equal to the
    uninterrupted two-rank run, which is equivalent to one rank's."""
    one, two = unlg["one"][3], [r[3] for r in unlg["two"]]
    for r in two:
        assert r["last_iter"] == 4
        _ranks_bit_equal(r["resumed"], r["straight"])
    _ranks_bit_equal(two[0]["resumed"], two[1]["resumed"])
    _assert_params_equivalent(_leaves(two[0]["straight"]),
                              _leaves(one["straight"]), lr=LR,
                              label="resume, 2 ranks vs 1")
    ckpts = glob.glob(str(unlg["root"] / "two" / "resume" / "**" / "*.pt"),
                      recursive=True)
    assert sorted(map(os.path.basename, ckpts)) == ["model_iter_2.pt",
                                                    "model_iter_4.pt"]


# ------------------------------------------------------------------- (g)

def test_fuse_scene_two_ranks_as_one_and_as_jax_mesh(unlg, scene_tree):
    """fuse_scene(mesh=) on two ranks (each fuses 2 of every 4 tiles)
    equals the one-rank scene at tests/test_scene.py's bound, and JAX's
    fuse_scene(mesh=) on a {"data": 2} mesh at the port's scene bound."""
    one, two = unlg["one"][4], [r[4] for r in unlg["two"]]
    for r in two:
        np.testing.assert_allclose(r["scene"], one["scene"], rtol=1e-5,
                                   atol=1e-6)
    ms, pan = _scene_inputs()
    cfg = JaxConfig(model_type="UnlgFormer", ms_chans=BANDS,
                    loss_cfg={"rec_loss": JaxLossCfg()},
                    model_cfg={"core_module": {"stage": 1}})
    method = build_jax_model("UnlgFormer", cfg)
    want = np.asarray(jax_scene.fuse_scene(
        method, {"core_module": jax.tree.map(jnp.asarray, scene_tree)}, ms,
        pan,
        tile=32, halo=8, batch=4, mesh=jax_make_mesh({"data": 2})))
    assert float(np.max(np.abs(two[0]["scene"] - want))) <= 5e-4


# ---------------------------------------------------------- the entry point

def test_main_cli_two_ranks(unlg):
    """`main.cli` under the launcher's environment: rank 0 alone writes
    the log file, the checkpoint and eval_curves.json; each TIFF once;
    the scores those of the one-rank cli."""
    one, two = unlg["one"][5], [r[5] for r in unlg["two"]]
    assert two[0]["eval_results"] == two[1]["eval_results"]
    for key, curve in one["eval_results"].items():
        np.testing.assert_allclose(two[0]["eval_results"][key], curve,
                                   rtol=1e-3)
    work = unlg["root"] / "two" / "cli"
    assert [os.path.basename(p) for p in glob.glob(
        str(work / "**" / "*.pt"), recursive=True)] == ["model_iter_2.pt"]
    assert len(glob.glob(str(work / "**" / "eval_curves.json"),
                         recursive=True)) == 1
    tiffs = two[0]["outputs"] + two[1]["outputs"]
    assert len(tiffs) == len(set(tiffs)) == 6
    assert len(glob.glob(str(unlg["root"] / "two" / "logs" / "*.log"))) == 1


# ------------------------------------------------------------------- (h)

def test_mesh_refusals(data):
    """mesh_shape is never ignored: a data axis other than the world
    size names both numbers, and so does a data x space grid of another
    size than the world (the `space` axis is ported: {"space": 1} and
    {"data": 1, "space": 1} fit one rank); a scene batch must divide by
    the ranks."""
    with pytest.raises(ValueError, match=r"data=2 .*world size 1"):
        make_mesh({"data": 2}, device="cpu")
    with pytest.raises(ValueError, match=r"data=1 x space=2 .*world size 1"):
        make_mesh({"data": 1, "space": 2}, device="cpu")
    for shape in ({"space": 1}, {"data": 1, "space": 1}):
        mesh = make_mesh(shape, device="cpu")
        assert (mesh.world, mesh.data_world, mesh.space_world) == (1, 1, 1)
    make_mesh({"data": 1}, device="cpu")
    cfg = _cfg(data, "unused", mesh_shape={"data": 8})
    with pytest.raises(ValueError, match=r"data=8 .*world size 1"):
        Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"), "cpu")
    method = build_model("UnlgFormer", _cfg(data, "unused"), device="cpu")
    ms, pan = _scene_inputs()
    with pytest.raises(ValueError, match="batch must divide"):
        scene.fuse_scene(method, ms, pan, tile=32, halo=8, batch=4,
                         mesh=Mesh(rank=0, world=3))


def test_mesh_shape_is_a_config_field(tmp_path):
    """The config's mesh_shape is a field (JAX's name, type and default),
    not an extra."""
    path = tmp_path / "c.py"
    path.write_text("mesh_shape = {'data': 2}\n")
    cfg = load_config(str(path))
    assert cfg.mesh_shape == {"data": 2} and "mesh_shape" not in cfg.extras
    field = {f.name: f for f in dataclasses.fields(Config)}["mesh_shape"]
    jfield = {f.name: f for f in dataclasses.fields(JaxConfig)}["mesh_shape"]
    assert field.type == jfield.type
    assert field.default_factory() == jfield.default_factory() == {}
