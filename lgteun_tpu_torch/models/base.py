"""Method abstraction of the port (counterpart of
`lgteun_tpu/models/base.py`).

A `TorchMethod` owns one `nn.Module` (the reference's `core_module`) on
an explicit device, and a method that trains more than one (MutInf's
`mi`) names them in `module_names` and returns them from `modules()`.
Each module is built on the meta device and gets storage from
`init_params(generator)` (seeded torch-default init) or
`load_state_dict` (reference-keyed weights of the core module;
`load_module_state_dict` for another). It starts in eval mode;
`train()` / `eval()` switch every module. Both entries keep the JAX
Method's batch layout, NHWC `input_lr` [B, h, w, C] and `input_pan`
[B, 4h, 4w, 1]:

    apply(batch)                  inference (torch.inference_mode), NHWC
                                  [B, 4h, 4w, C] out
    losses(batch, generator, iter_id)
                                  the training loss with its autograd
                                  graph: weighted reconstruction losses
                                  against batch["target"] plus
                                  "full_loss", as `Method.losses`
                                  (`lgteun_tpu/models/base.py:56-88`);
                                  `generator` draws the dropout masks
                                  (and MutInf's reparameterisation
                                  noise), `iter_id` is the 0-based
                                  iteration (MutInf's MI ramp)

`LGTEUN_EVAL_DTYPE=bf16` (`ops.storage_dtype`) is UnlgFormer's bf16
storage mode, the one method with `bf16_storage`; building any other
method under it raises, as the JAX package's blanket bf16 autocast of
the rest of the zoo (`lgteun_tpu/models/base.py:163-189`) is not ported
yet (ROADMAP A.5.1). "bf16res" changes nothing for them, as in JAX.

A `ClassicalMethod` (GSA, SFIM, Wavelet) has no module and no
parameters: `trainable` is False and `apply` is its fuse function on
NHWC tensors on `self.device` (`lgteun_tpu/models/base.py:192-204`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.losses import build_loss_weights, reconstruction_loss
from lgteun_tpu_torch.models.common.layers import init_parameters
from lgteun_tpu_torch.ops import storage_dtype

__all__ = ["TorchMethod", "ClassicalMethod"]


def _nchw(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32).permute(
        0, 3, 1, 2).contiguous()


class TorchMethod:
    """One core module on one device."""

    trainable = True
    module_names: tuple[str, ...] = ("core_module",)
    bf16_storage = False   # takes LGTEUN_EVAL_DTYPE=bf16 (module docstring)

    def __init__(self, cfg: Config, device):
        if not self.bf16_storage and storage_dtype() == (torch.bfloat16,
                                                         False):
            raise NotImplementedError(
                f"{type(self).__name__}: LGTEUN_EVAL_DTYPE=bf16 is "
                "UnlgFormer's storage mode; the blanket bf16 autocast of "
                "the other methods is not ported (ROADMAP A.5.1)")
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

    def modules(self) -> dict[str, nn.Module]:
        """{name: module} of `module_names`, the core module first."""
        return {"core_module": self.module}

    def init_params(self, generator: torch.Generator,
                    sample_hw: tuple[int, int] | None = None
                    ) -> "TorchMethod":
        """Allocate on `self.device` and draw every parameter of every
        module, in `module_names` order, from `generator` (a CPU
        generator: the draws are made on the CPU and copied, so a seed
        gives the same weights on every device). `sample_hw` = (LrMS
        side, PAN side) of the data, for a module whose widths follow
        it (the JAX Method's argument)."""
        for module in self.modules().values():
            module.to_empty(device="cpu")
            init_parameters(module, generator)
            module.to(self.device)
        return self

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        """Load reference-keyed weights (see `convert/from_jax.py`), in
        place once the module has storage (an optimizer keeps its
        parameters)."""
        if any(p.is_meta for p in self.module.parameters()):
            self.module.to_empty(device=self.device)
        return self.module.load_state_dict(state_dict, strict=strict)

    def load_module_state_dict(self, name: str, state_dict: dict,
                               strict: bool = True):
        """Weights of module `name` (the core module's are
        `load_state_dict`'s)."""
        if name == "core_module":
            return self.load_state_dict(state_dict, strict)
        module = self.modules()[name]
        if any(p.is_meta for p in module.parameters()):
            module.to_empty(device=self.device)
        return module.load_state_dict(state_dict, strict=strict)

    def param_count(self) -> int:
        """The core module's parameters."""
        return sum(p.numel() for p in self.module.parameters())

    def param_counts(self) -> dict[str, int]:
        """{module name: parameters}, as the JAX Method's."""
        return {name: sum(p.numel() for p in m.parameters())
                for name, m in self.modules().items()}

    def state_dict(self) -> dict:
        """The core module's reference-keyed weights."""
        return self.module.state_dict()

    @property
    def training(self) -> bool:
        return self.module.training

    def train(self, mode: bool = True) -> "TorchMethod":
        for module in self.modules().values():
            module.train(mode)
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

    def loss_weights(self) -> dict:
        """The weighted `loss_cfg` entries; raises NotImplementedError for
        one the port does not compute (`QNR_loss`, `*adv_loss*`: ROADMAP
        A.8) rather than train without it. Every entry the port computes
        has `rec_loss` in its name."""
        weights = build_loss_weights(self.cfg.loss_cfg)
        for name in weights:
            if "rec_loss" not in name:
                raise NotImplementedError(
                    f"loss_cfg entry {name!r}: the port computes only the "
                    "*rec_loss* reconstruction terms; QNR and adversarial "
                    "losses are not ported yet (ROADMAP A.8, was A.7)")
        return weights

    def losses(self, batch: dict, generator: torch.Generator | None = None,
               iter_id: int = 0):
        """-> (total, {name: value}) with gradients; batch as `apply`'s
        plus `target` [B, 4h, 4w, C]. Each weighted `loss_cfg` entry
        whose name holds `rec_loss` is an output-vs-target
        reconstruction; any other weighted entry (`QNR_loss`,
        `*adv_loss*`) raises NotImplementedError rather than train
        without it. `iter_id` is for a method whose loss follows the
        iteration (MutInf)."""
        weights = self.loss_weights()
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


class ClassicalMethod:
    """A training-free method: no module and no parameters, and of
    `TorchMethod`'s surface what the Runner calls on such a method.
    `fuse_fn(lrms, pan)` takes NHWC [B, h, w, C] and [B, H, W, 1] tensors
    in [0, 1] and returns [B, H, W, C] clipped to [0, 1]."""

    trainable = False
    training = False
    fuse_fn = None  # staticmethod set by a subclass

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)

    def init_params(self, generator: torch.Generator,
                    sample_hw=None) -> "ClassicalMethod":
        return self

    def modules(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        if strict and state_dict:
            raise ValueError(f"{type(self).__name__} has no parameters; "
                             f"got {sorted(state_dict)[:4]}...")

    def state_dict(self) -> dict:
        return {}

    def train(self, mode: bool = True) -> "ClassicalMethod":
        return self

    def eval(self) -> "ClassicalMethod":
        return self

    @torch.inference_mode()
    def apply(self, batch: dict) -> torch.Tensor:
        lr, pan = (torch.as_tensor(batch[k], dtype=torch.float32,
                                   device=self.device)
                   for k in ("input_lr", "input_pan"))
        return type(self).fuse_fn(lr, pan)
