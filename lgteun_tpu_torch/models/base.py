"""Method abstraction of the port (counterpart of
`lgteun_tpu/models/base.py`).

A `TorchMethod` owns one `nn.Module` (the reference's `core_module`) on
an explicit device. The module is built on the meta device and gets
storage from `init_params(generator)` (seeded torch-default init) or
`load_state_dict` (reference-keyed weights). `apply(batch)` keeps the
JAX Method's batch layout: NHWC `input_lr` [B, h, w, C] and `input_pan`
[B, 4h, 4w, 1] in, NHWC [B, 4h, 4w, C] out.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.models.common.layers import init_parameters

__all__ = ["TorchMethod"]


def _nchw(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32).permute(
        0, 3, 1, 2).contiguous()


class TorchMethod:
    """One core module on one device, eval only (training is a later
    slice)."""

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device("meta"):
            self.module = self.make_module()
        self.module.eval()

    def make_module(self) -> nn.Module:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator) -> "TorchMethod":
        """Allocate on `self.device` and draw every parameter from
        `generator` (a CPU generator: the draws are made on the CPU and
        copied, so a seed gives the same weights on every device)."""
        self.module.to_empty(device="cpu")
        init_parameters(self.module, generator)
        self.module.to(self.device)
        return self

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        """Load reference-keyed weights (see `convert/from_jax.py`)."""
        self.module.to_empty(device=self.device)
        return self.module.load_state_dict(state_dict, strict=strict)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    @torch.inference_mode()
    def apply(self, batch: dict) -> torch.Tensor:
        """batch (NHWC numpy arrays or tensors) -> fused HrMS, NHWC, on
        `self.device`."""
        ms = _nchw(batch["input_lr"], self.device)
        pan = _nchw(batch["input_pan"], self.device)
        return self.module(ms, pan).permute(0, 2, 3, 1)
