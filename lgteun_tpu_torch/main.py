"""Entry point of the port (counterpart of `lgteun_tpu/main.py`):

    python -m lgteun_tpu_torch.main -c CONFIG.py [--test-only]
        [--checkpoint PATH] [--device cuda]
    python -m torch.distributed.run --nproc_per_node N \
        -m lgteun_tpu_torch.main -c CONFIG.py [...]

Config -> logger (stdout and {log_dir}/{name}.log, log_dir defaulting
to logs/{model_type}/{datas}) -> seeds -> the config's datasets ->
method and Runner -> init, then the checkpoint (`--checkpoint`, the
config's `checkpoint`) or the `pretrained` weights -> the optimiser for
a trainable method -> training when `not only_test and max_iter > 0`
(then a checkpoint at max_iter) -> the reduced-resolution split scored
and its fused images written (`Runner.test(ref=True, save=True)`), the
full-resolution split too when the config has one (`ref=False`) ->
`eval_curves.json`. An exception is logged with its traceback and
raised again.

The method runs on `--device`, the card by default; the CPU (the
kernels' plain versions) only when asked for with `--device cpu`, and a
card asked for where there is none raises. The JAX entry's
`LGTEUN_MATMUL_PRECISION=highest` for `only_test` runs maps to TF32 off,
which the Runner sets for the process. With `only_test` the training
split is not read.

Under a launcher (`torchrun` / `python -m torch.distributed.run`: RANK,
WORLD_SIZE, LOCAL_RANK in the environment) each rank runs on
`cuda:LOCAL_RANK` (`--device cpu`: the CPU, gloo), joins the process
group (`parallel.mesh.make_mesh`: NCCL where every rank has its own
card, gloo where ranks share one) and trains and scores data-parallel
(`runner.py`); the config's `mesh_shape` is {} or {"data": D},
{"space": S}, {"data": D, "space": S} with D * S the world size (the
ranks of a space group hold the same rows, as JAX's P("data")).
Only rank 0 writes the log file, the checkpoints, `eval_curves.json` and
its info lines; each rank writes the TIFFs of the images it scored (the
first rank of each space group). The
process group ends when `main` returns or raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
import traceback

import numpy as np
import torch

from lgteun_tpu_torch.config import Config, load_config
from lgteun_tpu_torch.data.dataset import PSDataset
from lgteun_tpu_torch.parallel.mesh import Mesh, launcher, make_mesh
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

__all__ = ["main", "build_runner", "make_logger", "set_random_seed", "cli"]


def set_random_seed(seed: int) -> None:
    """Seed python, numpy and torch (reference main.py:42-58; the Runner
    draws the weights from its own generator seeded by cfg.seed)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_logger(cfg: Config, rank: int = 0) -> logging.Logger:
    """The "lgteun_torch" logger writing to stdout and to
    {log_dir}/{name}.log, and not on to the root logger (which would
    print each line twice where the root has a stdout handler); a later
    call (another config in the same process) replaces the handlers of
    the earlier one. `cli` hands the logger back as it found it. A rank
    other than 0 of a launch writes its warnings and errors to stderr
    and no file."""
    logger = logging.getLogger("lgteun_torch")
    logger.setLevel(getattr(logging, cfg.log_level, logging.INFO))
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if rank:
        handlers = [logging.StreamHandler(sys.stderr)]
        handlers[0].setLevel(logging.WARNING)
    else:
        log_dir = cfg.log_dir or os.path.join("logs", cfg.model_type.lower(),
                                              cfg.datas)
        os.makedirs(log_dir, exist_ok=True)
        handlers = [logging.StreamHandler(sys.stdout),
                    logging.FileHandler(os.path.join(log_dir,
                                                     f"{cfg.name}.log"))]
    for handler in handlers:
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def _release_logger(logger: logging.Logger, level: int = logging.NOTSET,
                   propagate: bool = True) -> None:
    """Close and detach the handlers `make_logger` attached and restore
    the level and propagation, so that the package's loggers (the
    Runner's, "lgteun_torch.fuse") reach the root logger again and no
    later Runner writes into this run's log file."""
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(level)
    logger.propagate = propagate


def build_runner(cfg: Config, device, logger=None,
                 mesh: Mesh | None = None) -> Runner:
    """The config's datasets (reference main.py:71-99), method and
    Runner on `device`, one rank of `mesh` (None: `make_mesh`)."""
    def make_ds(loader_cfg):
        if not loader_cfg.dataset.image_dirs:
            return None
        return PSDataset(loader_cfg.dataset.image_dirs,
                         bit_depth=loader_cfg.dataset.bit_depth,
                         norm_input=False)

    train_ds = None if cfg.only_test else make_ds(cfg.train_set_cfg)
    method = build_model(cfg.model_type, cfg, device=device)
    return Runner(cfg, method, device, logger=logger, train_ds=train_ds,
                  test_ds_full=make_ds(cfg.test_set0_cfg),
                  test_ds_reduced=make_ds(cfg.test_set1_cfg), mesh=mesh)


def main(cfg: Config, logger: logging.Logger, device="cuda") -> Runner:
    """One run of `cfg` on `device` ("cuda": under a launcher the rank's
    card), data-parallel over the launch's ranks (module docstring)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch sees no "
                           "CUDA device; pass --device cpu to run the plain "
                           "versions on the CPU")
    mesh = make_mesh(cfg.mesh_shape, device=device)
    try:
        set_random_seed(cfg.seed)
        runner = build_runner(cfg, mesh.device, logger, mesh)
        runner.init()
        if cfg.checkpoint:
            runner.load_checkpoint(cfg.checkpoint)
        elif cfg.pretrained:
            runner.load_pretrained(cfg.pretrained)
        if runner.method.trainable:
            runner.set_optim()
        if not cfg.only_test and cfg.max_iter > 0:
            runner.train()
            runner.save(cfg.max_iter)
        runner.test(iter_id=cfg.max_iter, save=True, ref=True)
        if runner.test_ds_full is not None:
            runner.test(iter_id=cfg.max_iter, save=True, ref=False)
        runner.log_eval_curves()
        return runner
    finally:
        mesh.close()


def cli(argv=None) -> Runner:
    parser = argparse.ArgumentParser(prog="python -m lgteun_tpu_torch.main",
                                     description="lgteun_tpu_torch runner")
    parser.add_argument("-c", "--config", required=True,
                        help="path to a Python config file")
    parser.add_argument("--test-only", action="store_true",
                        help="skip training (the reference's shipped "
                             "only_test=True flow)")
    parser.add_argument("--checkpoint", default=None,
                        help="a Runner checkpoint or a reference-keyed "
                             "torch state_dict file (overrides the "
                             "config's)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions of the kernels)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.test_only:
        cfg.only_test = True
    if args.checkpoint:
        cfg.checkpoint = args.checkpoint
    found = logging.getLogger("lgteun_torch")
    level, propagate = found.level, found.propagate
    logger = make_logger(cfg, rank=launcher()[0])
    try:
        logger.info(f"config: {cfg}")
        return main(cfg, logger, args.device)
    except Exception:
        logger.error(traceback.format_exc())
        raise
    finally:
        _release_logger(logger, level, propagate)


if __name__ == "__main__":
    cli()
