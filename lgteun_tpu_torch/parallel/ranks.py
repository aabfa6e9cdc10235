"""Data-parallel runs on local ranks without a launcher, and the Runner
jobs that the port's multi-rank checks run.

    spawn(jobs, world, workdir, device="cuda")

starts `world` processes (`torch.multiprocessing.spawn`: the spawn start
method, so each child imports only what unpickling its entry needs: this
package, never jax), each of which sets the launcher's environment
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE), joins a process group
through a file:// rendezvous under `workdir` (`make_mesh`: gloo on the
CPU and where the ranks share a card, NCCL where each has its own), runs
every `(job, kwargs)` of `jobs` as `job(mesh, **kwargs)` and writes its
results; it returns [rank][job] results. A rank that raises fails the
call (the other ranks are ended). Each job is a function of this module
and returns plain data (numpy arrays), so that the one-rank run is the
same function called in the caller's process with `make_mesh(device=)`:

    train_job    Runner.train of a config from seeded (or given) weights:
                 every module's parameters and buffers, the loss log and
                 the reduced gradients after each of `stops`
    resume_job   Runner.train with a checkpoint at `save_at`, then a
                 fresh Runner resumed from it: both runs' parameters
    test_job     Runner.test of the config's splits, with `save`: the
                 scores, the per-image scores and the TIFFs each rank
                 wrote
    scene_job    parallel.scene.fuse_scene(mesh=) of one scene
    cli_job      `main.cli(argv)`, the entry point, on the rank
    mi_job       MutInf's `mi` regulariser before MutInf.losses clips it
                 (the one loss term that sums over the batch): its value
                 and reduced gradients on the rank's rows of a batch
    spatial_job  `parallel.spatial.run_spatially_sharded` of each case on a
                 mesh of another shape laid over the rank's group (a
                 `space` axis): the rank's rows, the gathered output, the
                 kernel launches of one forward and its time

`train_job` also takes a `mesh_shape` to lay over the group (e.g.
{"data": 1, "space": 2}: every rank of the space group holds the whole
batch).

A config is passed as the port's `Config` (a picklable dataclass) whose
dataset directories exist on disk; the kernels' environment switches
(LGTEUN_FUSE_LEVEL, ...) are inherited from the caller's environment.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.multiprocessing as mp

from lgteun_tpu_torch.parallel.mesh import Mesh, make_mesh, require_device

__all__ = ["spawn", "train_job", "resume_job", "test_job", "scene_job",
           "cli_job", "mi_job", "spatial_job", "SPATIAL_WRAPPERS"]


# seconds after which spawned ranks still running (a collective that one
# rank never joins) are killed
SPAWN_TIMEOUT = 900.0


def spawn(jobs: list, world: int, workdir: str, *,
          device="cuda") -> list[list]:
    """Run `jobs` [(job, kwargs), ...] on `world` local ranks on `device`
    (module docstring; the cards unless the caller asks for the CPU),
    each with one intra-op thread; [rank][job] results. Raises where
    `device` is a card and there is none (`mesh.require_device`), and
    TimeoutError after SPAWN_TIMEOUT seconds."""
    require_device(device)
    workdir = os.path.abspath(workdir)   # a file:// URL takes no relative path
    os.makedirs(workdir, exist_ok=True)
    rendezvous = os.path.join(workdir, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    ctx = mp.spawn(_rank_main, args=(world, f"file://{rendezvous}", device,
                                     jobs, workdir),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
                proc.join()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{SPAWN_TIMEOUT:g} s")
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, init_method: str, device,
               jobs: list, workdir: str) -> None:
    """The spawned entry: one rank's mesh, its jobs, its results file
    (each result with `jax_imported`, whether anything imported jax)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    mesh = make_mesh(device=device, init_method=init_method)
    try:
        results = [job(mesh, **kwargs) for job, kwargs in jobs]
    finally:
        mesh.close()
    for r in results:
        r["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _runner(mesh: Mesh, cfg, weights: dict | None = None):
    """The config's Runner on the rank's device, seeded (cfg.seed) or
    with the reference-keyed `weights` of its core module."""
    from lgteun_tpu_torch.main import build_runner

    runner = build_runner(cfg, mesh.device,
                          logging.getLogger("lgteun_torch.ranks"), mesh)
    runner.init()
    if weights is not None:
        runner.load({k: torch.as_tensor(v) for k, v in weights.items()})
    return runner


def _state(runner) -> dict:
    """{module.key: numpy} of every module's parameters and buffers."""
    return {f"{m}.{k}": v.detach().cpu().numpy()
            for m, mod in runner.method.modules().items()
            for k, v in mod.state_dict().items()}


def _grads(runner) -> dict:
    """{module.key: numpy, or None without a gradient}."""
    return {f"{m}.{k}": None if p.grad is None
            else p.grad.detach().cpu().numpy()
            for m, mod in runner.method.modules().items()
            for k, p in mod.named_parameters()}


def train_job(mesh: Mesh, cfg, start: int = 0, stops: tuple = (),
              weights: dict | None = None,
              mesh_shape: dict | None = None) -> dict:
    """`Runner.train` of `cfg` from iteration `start` (the iterator
    fast-forwarded as a resume does; fresh optimisers) to cfg.max_iter,
    pausing after each iteration of `stops` to read the gradients the
    last step's optimisers took (reduced over the ranks; a pause sets
    cfg.max_iter, which MutInf's ramp reads). "seconds": {stop: the wall
    time of the train() call that ended there, the device synchronised}
    (a first stop takes the process's one-time costs). `mesh_shape`: a
    mesh of that shape over the rank's group in place of `mesh`."""
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, device=mesh.device)
    runner = _runner(mesh, cfg, weights)
    runner.set_optim()
    runner.last_iter = start
    grads, max_iter, seconds = {}, cfg.max_iter, {}
    try:
        for stop in (*stops, max_iter):
            cfg.max_iter = stop
            mesh.barrier()  # the ranks start each timed call together
            t0 = time.perf_counter()
            runner.train()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            seconds[stop] = time.perf_counter() - t0
            grads[stop] = _grads(runner)
    finally:
        cfg.max_iter = max_iter
    return {"state": _state(runner), "grads": grads,
            "loss_log": runner.loss_log, "seconds": seconds}


def resume_job(mesh: Mesh, cfg, save_at: int,
               weights: dict | None = None) -> dict:
    """Runner.train of `cfg` to cfg.max_iter with a checkpoint at
    iteration `save_at` (rank 0 writes it), then a fresh Runner that
    loads it on every rank and trains to cfg.max_iter: {"straight":,
    "resumed":} parameters and buffers."""
    cfg.save_freq = save_at
    straight = _runner(mesh, cfg, weights).set_optim()
    straight.train()
    path = os.path.join(cfg.work_dir, cfg.datas, "train_out",
                        f"model_iter_{save_at}.pt")
    resumed = _runner(mesh, cfg)
    resumed.load_checkpoint(path).set_optim()
    resumed.train()
    return {"straight": _state(straight), "resumed": _state(resumed),
            "last_iter": resumed.last_iter}


def test_job(mesh: Mesh, cfg, save: bool = True,
             weights: dict | None = None) -> dict:
    """Runner.test of the reduced split (ref=True) and, where the config
    has one, the full split (ref=False), with `save`: {"eval_results",
    "image_scores", "outputs": {ref: TIFFs this rank wrote},
    "time_per_image": {ref: s}}."""
    runner = _runner(mesh, cfg, weights)
    outputs, times = {}, {}
    for ref in (True, False):
        if (runner.test_ds_reduced if ref else runner.test_ds_full) is None:
            continue
        runner.test(iter_id=0, save=save, ref=ref)
        outputs[ref] = list(runner.last_outputs)
        times[ref] = runner.last_time_per_image
    return {"eval_results": runner.eval_results,
            "image_scores": runner.image_scores, "outputs": outputs,
            "time_per_image": times}


def scene_job(mesh: Mesh, cfg, ms: np.ndarray, pan: np.ndarray,
              tile: int, halo: int, batch: int,
              weights: dict | None = None) -> dict:
    """`fuse_scene(method, ms, pan, tile=, halo=, batch=, mesh=)`:
    {"scene": the fused scene, numpy}."""
    from lgteun_tpu_torch.parallel.scene import fuse_scene

    method = _runner(mesh, cfg, weights).method
    out = fuse_scene(method, ms, pan, tile=tile, halo=halo, batch=batch,
                     mesh=mesh)
    return {"scene": out.cpu().numpy()}


def cli_job(mesh: Mesh, argv: list) -> dict:
    """`python -m lgteun_tpu_torch.main` with `argv` on the rank (it
    joins the rank's process group): {"eval_results", "outputs": the
    TIFFs this rank wrote in the last split scored}."""
    from lgteun_tpu_torch.main import cli

    runner = cli(argv)
    return {"eval_results": runner.eval_results,
            "outputs": list(runner.last_outputs)}


def mi_job(mesh: Mesh, cfg, batch: dict, noise: tuple | None = None,
           iter_id: int = 0) -> dict:
    """MutInf's `mi` (`losses.MutualInfoReg`) on the core module's PAN
    and MS features of the rank's rows of the global `batch` (numpy,
    normalised), its noise the rank's rows of the step generator's draw
    at (cfg.seed + 1, iter_id), or of `noise` = (eps_a, eps_b) given for
    the global batch: {"value": the global batch's value, "grads": every
    module's gradient of it, reduced over the ranks}."""
    from lgteun_tpu_torch.models.base import _nchw
    from lgteun_tpu_torch.parallel.mesh import (all_reduce_grads,
                                                shard_batch)
    from lgteun_tpu_torch.runner import step_generator

    runner = _runner(mesh, cfg)
    method = runner.method.train()
    n = len(batch["input_lr"])
    shard, rows = mesh.shard(n), mesh.rows(n) or slice(0, n)
    local = runner.to_device(shard_batch(batch, mesh))
    gen = step_generator(cfg.seed + 1, iter_id, mesh.device, shard)
    _, panf, mhrf = method.module(_nchw(local["input_lr"], mesh.device),
                                  _nchw(local["input_pan"], mesh.device))
    eps = None if noise is None else tuple(e[rows] for e in noise)
    value = method.mi(panf, mhrf, gen, eps)
    value.backward()
    all_reduce_grads(method.modules().values(), mesh,
                     average=shard is None)
    return {"value": value.item(), "grads": _grads(runner)}


# the wrappers whose launches `spatial_job` counts: every kernel on a
# height-sharded path (B1-B6, B8-B12)
SPATIAL_WRAPPERS = ("ln_mixer_head", "window_attention", "block_tail",
                    "lightnet_stack", "global_mixer",
                    "window_attention_windows", "ln_ffn", "lgb_block",
                    "neighborhood_attention", "texture_match", "patch_match")


def _spatial_wrappers() -> dict:
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail, ln_ffn
    from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block
    from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_stack
    from lgteun_tpu_torch.ops.nonlocal_kernel import neighborhood_attention
    from lgteun_tpu_torch.ops.patch_match_kernel import patch_match
    from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                      ln_mixer_head)
    from lgteun_tpu_torch.ops.texture_match_kernel import texture_match
    from lgteun_tpu_torch.ops.window_attention import (
        window_attention, window_attention_windows)

    found = {fn.__name__: fn for fn in (
        ln_mixer_head, window_attention, block_tail, lightnet_stack,
        global_mixer, window_attention_windows, ln_ffn, lgb_block,
        neighborhood_attention, texture_match, patch_match)}
    return {name: found[name] for name in SPATIAL_WRAPPERS}


def spatial_job(mesh: Mesh, mesh_shape: dict, cases: list,
                timed: int = 0) -> dict:
    """`run_spatially_sharded` of each case on a mesh of `mesh_shape`
    laid over the rank's group. A case is a dict: "name", "method" (a
    registered model type), "cfg" (the port's Config), "weights"
    (reference-keyed numpy, or None: seeded with cfg.seed), "batch"
    (NHWC numpy), "batch_axis" (None or "data"), and optionally "env"
    (the switches read when the method is built: LGTEUN_FUSE_LEVEL,
    LGTEUN_FUSED_ATTENTION, LGTEUN_EVAL_DTYPE, LGTEUN_FUSED_TM,
    LGTEUN_LIGHTNET_DTYPE, each set only while the method is built).
    {name: {"rows": the rank's rows of the output, "whole": `gather_h`
    of every rank's (on rank 0; None on the others), "launches":
    {wrapper: launches of one forward}, "exchanges": the collectives of
    one forward by kind (`spatial.EXCHANGES`), "ms": the mean of `timed`
    forwards after a barrier (None at 0)}}; with `timed`, also
    "exchange_ms": the mean ms of `timed` 1-row halo exchanges of a
    [1, 8, 1, 128] tensor alone."""
    from lgteun_tpu_torch.parallel import spatial
    from lgteun_tpu_torch.parallel.spatial import (gather_h,
                                                   run_spatially_sharded)
    from lgteun_tpu_torch.registry import build_model

    mesh = make_mesh(mesh_shape, device=mesh.device)
    # FP32 convolutions and products, as the Runner sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = _spatial_wrappers()
    out = {}
    for case in cases:
        cfg, axis = case["cfg"], case.get("batch_axis")
        with mock.patch.dict(os.environ, case.get("env", {})):
            method = build_model(case["method"], cfg, mesh.device)
        if case.get("weights") is None:
            method.init_params(torch.Generator().manual_seed(cfg.seed))
        else:
            method.load_state_dict({k: torch.as_tensor(v) for k, v in
                                    case["weights"].items()})
        method.eval()
        run = lambda: run_spatially_sharded(method, case["batch"], mesh,
                                            batch_axis=axis)
        for fn in wrappers.values():
            fn.launches = 0
        spatial.EXCHANGES.clear()
        rows = run()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        exchanges = dict(spatial.EXCHANGES)
        whole = gather_h(rows, mesh, batch_axis=axis)
        ms = _mean_ms(mesh, run, timed) if timed else None
        out[case["name"]] = {"rows": rows.cpu().numpy(),
                             "whole": (whole.cpu().numpy() if mesh.rank == 0
                                       else None),
                             "launches": launches, "exchanges": exchanges,
                             "ms": ms}
    if timed:
        probe = torch.ones(1, 8, 1, 128, device=mesh.device)
        out["exchange_ms"] = _mean_ms(
            mesh, lambda: spatial.halo_rows(probe, 1, 1, mesh, "zero"), timed)
    return out


def _mean_ms(mesh: Mesh, call, n: int) -> float:
    """The mean wall ms of n calls after a barrier, the device synced."""
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) / n * 1e3
