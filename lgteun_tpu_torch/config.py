"""The port's config: the fields of a shipped config file that its eval
and training paths read.

A config file (e.g. `lgteun_tpu/configs/unlg_former.py`) is plain
Python, executed as in `lgteun_tpu/config.py::load_config`; its
module-level names become attributes. The fields below keep that
Config's names, types and defaults (`lgteun_tpu/config.py:28-128`); the
loader configs, `sched_cfg`, and each entry of `optim_cfg` and
`loss_cfg` become their dataclasses. Every other name is kept in
`extras`: `remat` and `mixed_precision`, which the Runner reads with
`get`, and the TPU-only `steps_per_dispatch`, of which the Runner warns
when it is not 1.
"""

from __future__ import annotations

import dataclasses
import runpy
import types
from dataclasses import dataclass, field
from typing import Any

__all__ = ["DatasetCfg", "LoaderCfg", "OptimCfg", "SchedCfg", "LossCfg",
           "Config", "load_config"]


@dataclass
class DatasetCfg:
    image_dirs: list[str] = field(default_factory=list)
    bit_depth: int = 11
    norm_input: bool = False
    type: str = "PSDataset"


@dataclass
class LoaderCfg:
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    batch_size: int = 4
    shuffle: bool = True
    num_workers: int = 0  # accepted for parity; the host pipeline ignores it


@dataclass
class OptimCfg:
    """Per-module optimiser (reference base_model.py:116-135; Adam lr
    1e-4 when absent)."""

    type: str = "Adam"
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0  # SGD/RMSprop


@dataclass
class SchedCfg:
    """StepLR (reference base_model.py:137-150)."""

    step_size: int = 10000
    gamma: float = 0.99


@dataclass
class LossCfg:
    type: str = "l1"
    w: float = 1.0
    soft_label: bool = False
    gp_w: float = 10.0


@dataclass
class Config:
    name: str = "run"
    model_type: str = "UnlgFormer"
    datas: str = "synthetic"
    ms_chans: int = 4
    bit_depth: int = 11
    norm_input: bool = True
    seed: int = 19971118
    only_test: bool = False
    checkpoint: str | None = None
    pretrained: str | None = None
    work_dir: str = "runs"
    log_dir: str | None = None
    log_level: str = "INFO"
    # data
    train_set_cfg: LoaderCfg = field(default_factory=LoaderCfg)
    test_set0_cfg: LoaderCfg = field(default_factory=LoaderCfg)  # full-res
    test_set1_cfg: LoaderCfg = field(default_factory=LoaderCfg)  # reduced
    aug_dict: dict | None = field(default_factory=dict)
    # schedule
    max_iter: int = 0
    save_freq: int = 10000
    test_freq: int = 10000
    eval_freq: int = 10000
    log_freq: int = 10
    # per-module optimisation
    optim_cfg: dict[str, OptimCfg] = field(default_factory=dict)
    sched_cfg: SchedCfg = field(default_factory=SchedCfg)
    loss_cfg: dict[str, LossCfg] = field(default_factory=dict)
    model_cfg: dict[str, dict] = field(default_factory=dict)
    eval_batch_size: int = 16
    # data-parallel ranks: {} every rank of the launch, {"data": n} n of
    # them (the launch's world size; `parallel/mesh.py::make_mesh`)
    mesh_shape: dict[str, int] = field(default_factory=dict)
    extras: dict[str, Any] = field(default_factory=dict)

    def get(self, key, default=None):
        if hasattr(self, key):
            return getattr(self, key)
        return self.extras.get(key, default)


def _coerce(cls, value):
    """A dataclass `cls` from a plain dict (a DatasetCfg inside), as
    `lgteun_tpu/config.py::_coerce` builds it; anything else as is."""
    if not isinstance(value, dict):
        return value
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: (_coerce(DatasetCfg, v) if k == "dataset" else v)
              for k, v in value.items() if k in names}
    return cls(**kwargs)


_NESTED = {"train_set_cfg": LoaderCfg, "test_set0_cfg": LoaderCfg,
           "test_set1_cfg": LoaderCfg, "sched_cfg": SchedCfg}
_PER_MODULE = {"optim_cfg": OptimCfg, "loss_cfg": LossCfg}


def load_config(path: str) -> Config:
    """Execute a Python config file and collect its namespace."""
    fields = {f.name for f in dataclasses.fields(Config)} - {"extras"}
    cfg = Config()
    for key, value in runpy.run_path(path).items():
        if key.startswith("_") or callable(value) or isinstance(
                value, types.ModuleType):
            continue
        if key in _NESTED:
            value = _coerce(_NESTED[key], value)
        elif key in _PER_MODULE:
            value = {k: _coerce(_PER_MODULE[key], v)
                     for k, v in value.items()}
        if key in fields:
            setattr(cfg, key, value)
        else:
            cfg.extras[key] = value
    return cfg
