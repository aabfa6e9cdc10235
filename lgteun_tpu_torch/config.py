"""The port's config: the eval slice's fields of a shipped config file.

A config file (e.g. `lgteun_tpu/configs/unlg_former.py`) is plain
Python, executed as in `lgteun_tpu/config.py::load_config`; its
module-level names become attributes. The fields below keep that
Config's names and defaults; every other name is kept in `extras`.
Training, data-loader and multi-device fields come with later slices.
"""

from __future__ import annotations

import dataclasses
import runpy
import types
from dataclasses import dataclass, field
from typing import Any

__all__ = ["Config", "load_config"]


@dataclass
class Config:
    model_type: str = "UnlgFormer"
    datas: str = "synthetic"
    ms_chans: int = 4
    bit_depth: int = 11
    norm_input: bool = True
    seed: int = 19971118
    model_cfg: dict[str, dict] = field(default_factory=dict)
    eval_batch_size: int = 16
    extras: dict[str, Any] = field(default_factory=dict)

    def get(self, key, default=None):
        if hasattr(self, key):
            return getattr(self, key)
        return self.extras.get(key, default)


def load_config(path: str) -> Config:
    """Execute a Python config file and collect its namespace."""
    fields = {f.name for f in dataclasses.fields(Config)} - {"extras"}
    cfg = Config()
    for key, value in runpy.run_path(path).items():
        if key.startswith("_") or callable(value) or isinstance(
                value, types.ModuleType):
            continue
        if key in fields:
            setattr(cfg, key, value)
        else:
            cfg.extras[key] = value
    return cfg
