"""Method abstraction of the port (counterpart of
`lgteun_tpu/models/base.py`).

A `TorchMethod` owns one `nn.Module` (the reference's `core_module`) on
an explicit device. The module is built on the meta device and gets
storage from `init_params(generator)` (seeded torch-default init) or
`load_state_dict` (reference-keyed weights). It starts in eval mode;
`train()` / `eval()` switch it. Both entries keep the JAX Method's batch
layout, NHWC `input_lr` [B, h, w, C] and `input_pan` [B, 4h, 4w, 1]:

    apply(batch)                  inference (torch.inference_mode), NHWC
                                  [B, 4h, 4w, C] out
    losses(batch, generator)      the training loss with its autograd
                                  graph: weighted reconstruction losses
                                  against batch["target"] plus
                                  "full_loss", as `Method.losses`
                                  (`lgteun_tpu/models/base.py:56-88`);
                                  `generator` draws the dropout masks
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.losses import build_loss_weights, reconstruction_loss
from lgteun_tpu_torch.models.common.layers import init_parameters

__all__ = ["TorchMethod"]


def _nchw(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32).permute(
        0, 3, 1, 2).contiguous()


class TorchMethod:
    """One core module on one device."""

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device("meta"):
            self.module = self.make_module()
        self.module.eval()

    def make_module(self) -> nn.Module:
        raise NotImplementedError

    def forward(self, ms: torch.Tensor, pan: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The module on NCHW inputs; `generator` is for a module with
        dropout (UnlgFormer) and ignored here."""
        return self.module(ms, pan)

    def init_params(self, generator: torch.Generator) -> "TorchMethod":
        """Allocate on `self.device` and draw every parameter from
        `generator` (a CPU generator: the draws are made on the CPU and
        copied, so a seed gives the same weights on every device)."""
        self.module.to_empty(device="cpu")
        init_parameters(self.module, generator)
        self.module.to(self.device)
        return self

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        """Load reference-keyed weights (see `convert/from_jax.py`), in
        place once the module has storage (an optimizer keeps its
        parameters)."""
        if any(p.is_meta for p in self.module.parameters()):
            self.module.to_empty(device=self.device)
        return self.module.load_state_dict(state_dict, strict=strict)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def train(self, mode: bool = True) -> "TorchMethod":
        self.module.train(mode)
        return self

    def eval(self) -> "TorchMethod":
        return self.train(False)

    @torch.inference_mode()
    def apply(self, batch: dict) -> torch.Tensor:
        """batch (NHWC numpy arrays or tensors) -> fused HrMS, NHWC, on
        `self.device`."""
        ms = _nchw(batch["input_lr"], self.device)
        pan = _nchw(batch["input_pan"], self.device)
        return self.forward(ms, pan).permute(0, 2, 3, 1)

    def losses(self, batch: dict, generator: torch.Generator | None = None):
        """-> (total, {name: value}) with gradients; batch as `apply`'s
        plus `target` [B, 4h, 4w, C]. Each weighted `loss_cfg` entry
        whose name holds `rec_loss` is an output-vs-target
        reconstruction; any other weighted entry (`QNR_loss`,
        `*adv_loss*`) raises NotImplementedError rather than train
        without it."""
        weights = build_loss_weights(self.cfg.loss_cfg)
        for name in weights:
            if "rec_loss" not in name:
                raise NotImplementedError(
                    f"loss_cfg entry {name!r}: the port computes only the "
                    "*rec_loss* reconstruction terms; QNR and adversarial "
                    "losses are not ported yet (ROADMAP A.7)")
        out = self.forward(_nchw(batch["input_lr"], self.device),
                           _nchw(batch["input_pan"], self.device), generator)
        target = _nchw(batch["target"], self.device)
        total = torch.zeros((), device=self.device)
        parts = {}
        for name, lcfg in weights.items():
            parts[name] = reconstruction_loss(out, target, lcfg.type)
            total = total + lcfg.w * parts[name]
        parts["full_loss"] = total
        return total, parts
