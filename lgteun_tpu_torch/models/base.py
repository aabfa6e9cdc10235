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
    losses(batch, generator, iter_id, with_output=False)
                                  the training loss with its autograd
                                  graph: the weighted `*rec_loss*`
                                  entries against batch["target"], a
                                  weighted `QNR_loss` (no reference),
                                  and "full_loss", as `Method.losses`
                                  (`lgteun_tpu/models/base.py:56-88`);
                                  `generator` draws the dropout masks
                                  (and MutInf's reparameterisation
                                  noise), `iter_id` is the 0-based
                                  iteration (MutInf's MI ramp);
                                  `with_output` also returns the NCHW
                                  output, so that the adversarial step
                                  makes one generator forward

Adversarial training (`lgteun_tpu/models/base.py:95-144`): a weighted
`loss_cfg` entry whose name holds `adv_loss` gives the method a second
module, "discriminator" (`model_cfg["discriminator"]`: its `type`,
PatchDiscriminator by default with instance norm, and its arguments;
`models/common/discriminators.py`), which the Runner trains with its own
optimiser in its two-optimiser step (`runner.py`). The entry's `type` is
the GAN kind ("GAN", "LSGAN", "WGAN-GP"), `w` the generator term's
weight and `gp_w` WGAN-GP's penalty weight; `losses` itself leaves the
adversarial term to the Runner.

Training under `mixed_precision` (`runner.py`): a method with
`handles_mixed` (UnlgFormer) runs it inside its module; every other runs
`losses` inside `training_cast`, the JAX Runner's blanket cast
(`lgteun_tpu/runner.py:187-229`): a differentiable bfloat16 copy of
every module's floating parameters (the gradients reach the float32
masters), bfloat16 inputs and the ops promoted as `jax_promotion` says.
LightNet and MutInf train under it too: their eval opt-outs below are
the JAX package's `apply`, not its Runner's cast.

`LGTEUN_EVAL_DTYPE=bf16` (`ops.storage_dtype`, read when the method is
built) is UnlgFormer's bf16 storage mode (`bf16_storage`). For every
other DL method it is the JAX package's blanket cast
(`lgteun_tpu/models/base.py:163-189`): `apply` runs the eval forward on
a bfloat16 copy of the module's floating parameters (made once per
weight version; the float32 parameters stay the ones that train and
checkpoint) and on bfloat16 inputs, and returns float32. Buffers are
not cast: a tensor that JAX builds inside the module as a float32
constant (PanFormer's window masks) stays float32 and promotes the
stream as JAX's does (INNT's and SFIIN's invertible 1x1 conv keep their
permutation and signs as buffers, exact in bfloat16). Where an operand
of a conv, linear layer, matmul or norm is float32 and the other
bfloat16, both are promoted to float32, as flax's `promote_dtype` and
jnp's promotion do (`jax_promotion`); elementwise ops promote on their
own. A bf16 forward that records a gradient raises. MutInf opts out
(`bf16_cast` False): JAX's MutInf overrides `apply` and never casts
(`lgteun_tpu/models/mutinf.py:235-239`), so it runs float32 under the
mode. LightNet runs its own bf16 path (`models/lightnet.py`).
"bf16res" changes nothing for these methods, as in JAX.

A `ClassicalMethod` (GSA, SFIM, Wavelet) has no module and no
parameters: `trainable` is False and `apply` is its fuse function on
NHWC tensors on `self.device` (`lgteun_tpu/models/base.py:192-204`).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.losses import (build_loss_weights, qnr_loss,
                                     reconstruction_loss)
from lgteun_tpu_torch.models.common import discriminators
from lgteun_tpu_torch.models.common.layers import init_parameters
from lgteun_tpu_torch.ops import storage_dtype
from lgteun_tpu_torch.parallel.mesh import batch_mean

__all__ = ["TorchMethod", "ClassicalMethod", "jax_promotion", "swapped"]

# the zoo's ops whose float operands torch requires to share one dtype,
# where jnp / flax promote them to the wider one (elementwise ops and cat
# promote in torch too)
_PROMOTED = {F.conv2d, F.linear, F.layer_norm, F.instance_norm,
             torch.matmul}


def _cast(a, dtype, made: dict):
    """Argument `a` of a promoted op in float dtype `dtype`."""
    if not isinstance(a, torch.Tensor) or not a.is_floating_point() \
            or a.dtype == dtype:
        return a
    t = made.get((id(a), dtype))
    return a.to(dtype) if t is None else t


class jax_promotion(TorchFunctionMode):  # noqa: N801  (a context manager)
    """Inside it, the ops of `_PROMOTED` promote a bfloat16 operand to
    float32 where another is float32, as jnp and flax's layers do (torch
    raises on the mixed dtypes); a bfloat16 conv or linear layer adds its
    bias after the product, rounding each, as flax's `Conv` and `Dense`
    do (torch's bf16 conv adds it before its one rounding); every other
    op runs as it is. `made`: {(id(t), dtype): t in dtype} made
    beforehand (the cast parameters' float32 values, so that a promoted
    weight costs no launch)."""

    def __init__(self, made: dict | None = None):
        super().__init__()
        self.made = made or {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTED:
            dtypes = {a.dtype for a in (*args, *kwargs.values())
                      if isinstance(a, torch.Tensor) and a.is_floating_point()}
            if len(dtypes) > 1:
                dtype = functools.reduce(torch.promote_types, dtypes)
                args = tuple(_cast(a, dtype, self.made) for a in args)
                kwargs = {k: _cast(v, dtype, self.made)
                          for k, v in kwargs.items()}
            if func in (F.conv2d, F.linear):
                return _bias_after(func, args, kwargs)
        return func(*args, **kwargs)


def _bias_after(func, args: tuple, kwargs: dict):
    """conv2d / linear with a bfloat16 bias added after the product."""
    args, kwargs = list(args), dict(kwargs)
    bias = args[2] if len(args) > 2 else kwargs.get("bias")
    if bias is None or bias.dtype != torch.bfloat16:
        return func(*args, **kwargs)
    if len(args) > 2:
        args[2] = None
    else:
        kwargs["bias"] = None
    out = func(*args, **kwargs)
    if func is F.conv2d:
        return out + bias.view(-1, *([1] * (out.dim() - 2)))
    return out + bias


def _nchw(a, device: torch.device) -> torch.Tensor:
    """NHWC array or tensor -> NCHW on `device`, float32 (a bfloat16
    tensor, the blanket cast's input, stays bfloat16)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    dtype = torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32
    return t.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()


class TorchMethod:
    """One core module on one device."""

    trainable = True
    module_names: tuple[str, ...] = ("core_module",)
    bf16_storage = False   # LGTEUN_EVAL_DTYPE is its storage mode
    bf16_cast = True       # else "bf16" is the blanket cast (docstring)
    handles_mixed = False  # its module runs mixed_precision training

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        # the blanket cast's dtype, or None
        self.eval_dtype = (torch.bfloat16 if self.bf16_cast
                           and not self.bf16_storage and storage_dtype()
                           == (torch.bfloat16, False) else None)
        self._cast_params = (None, {}, {})
        with torch.device("meta"):
            self.module = self.make_module()
        self.module.eval()
        self.adv_name = self.adv_cfg = self.disc = None
        for name, lcfg in build_loss_weights(cfg.loss_cfg).items():
            if "adv_loss" in name:
                self.adv_name, self.adv_cfg = name, lcfg
                self.module_names = (*type(self).module_names,
                                     "discriminator")
                break

    def make_module(self) -> nn.Module:
        raise NotImplementedError

    def _make_discriminator(self, pan_size: int) -> nn.Module:
        """The discriminator of `model_cfg["discriminator"]` on the meta
        device, for HrMS of side `pan_size` (the width of a VGG's fc0).
        It is built once, where that side is known: by `init_params`
        (`sample_hw`, else 32, the JAX Method's default sample side) or
        by the first load of its weights (the side of their fc0)."""
        dcfg = dict(self.cfg.model_cfg.get("discriminator", {}))
        kind = dcfg.pop("type", "PatchDiscriminator")
        table = {"PatchDiscriminator": discriminators.PatchDiscriminator,
                 "PixelDiscriminator": discriminators.PixelDiscriminator,
                 "VGGDiscriminator": discriminators.VGGDiscriminator}
        if kind not in table:
            raise KeyError(f"no such discriminator {kind!r}; available: "
                           f"{sorted(table)}")
        if kind == "VGGDiscriminator":
            dcfg["in_size"] = pan_size
        else:
            dcfg.setdefault("norm_type", "IN")
        with torch.device("meta"):
            disc = table[kind](self.cfg.ms_chans, **dcfg)
        return disc.train(self.module.training)

    def _disc_modules(self) -> dict:
        return {} if self.disc is None else {"discriminator": self.disc}

    def forward(self, ms: torch.Tensor, pan: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The module on NCHW inputs; `generator` is for a module with
        dropout (UnlgFormer) and ignored here."""
        return self.module(ms, pan)

    def modules(self) -> dict[str, nn.Module]:
        """{name: module} of `module_names`, the core module first."""
        return {"core_module": self.module, **self._disc_modules()}

    def init_params(self, generator: torch.Generator,
                    sample_hw: tuple[int, int] | None = None
                    ) -> "TorchMethod":
        """Allocate on `self.device` and draw every parameter of every
        module, in `module_names` order, from `generator` (a CPU
        generator: the draws are made on the CPU and copied, so a seed
        gives the same weights on every device). `sample_hw` = (LrMS
        side, PAN side) of the data, for a module whose widths follow
        it (the JAX Method's argument)."""
        if self.adv_name is not None and self.disc is None:
            self.disc = self._make_discriminator(
                32 if sample_hw is None else sample_hw[1])
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
        if name == "discriminator" and self.disc is None:
            side = 1
            if "fc0.weight" in state_dict:
                side = math.isqrt(state_dict["fc0.weight"].shape[1]
                                  // discriminators.VGG_FEATS[-1])
            self.disc = self._make_discriminator(32 * side)
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
        `self.device` (float32)."""
        ms = _nchw(batch["input_lr"], self.device)
        pan = _nchw(batch["input_pan"], self.device)
        return self.eval_forward(ms, pan).permute(0, 2, 3, 1)

    def eval_forward(self, ms: torch.Tensor, pan: torch.Tensor
                     ) -> torch.Tensor:
        """`forward` as `apply` runs it: under the blanket cast
        (`eval_dtype`, outside training) on the bfloat16 copy of the
        parameters and bfloat16 ms, pan, the output upcast to
        float32."""
        dtype = self.eval_dtype
        if dtype is None or self.training:
            return self.forward(ms, pan)
        cast, made = self.cast_parameters(dtype, ms, pan)
        with swapped(self.module, cast), jax_promotion(made):
            out = self.forward(ms.to(dtype), pan.to(dtype))
        return out.float()

    def cast_parameters(self, dtype: torch.dtype, *inputs) -> tuple:
        """({name: the module's parameter in `dtype`}, {(id(cast), float32):
        its float32 value}), made once per weight version; raises if a
        gradient would be recorded through `inputs` or the parameters (a
        cast forward is an eval mode without a backward)."""
        params = dict(self.module.named_parameters())
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (*inputs, *params.values())):
            raise RuntimeError(
                f"{type(self).__name__}: the bf16 eval forward "
                "(LGTEUN_EVAL_DTYPE=bf16) is an eval mode without a "
                "backward: run it with gradients off (torch.no_grad / "
                "inference_mode); training runs float32")
        key = (dtype,) + tuple((p.data_ptr(), p._version)
                               for p in params.values())
        if self._cast_params[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                cast = {name: p.detach().to(dtype) if p.is_floating_point()
                        else p for name, p in params.items()}
                # each cast value upcast again (exact), for the ops where
                # it meets a float32 operand
                made = {(id(t), torch.float32): t.float()
                        for t in cast.values() if t.dtype == dtype}
                self._cast_params = (key, cast, made)
        return self._cast_params[1:]

    def losses(self, batch: dict, generator: torch.Generator | None = None,
               iter_id: int = 0, with_output: bool = False):
        """-> (total, {name: value}) with gradients, and the NCHW output
        with `with_output`; batch as `apply`'s plus `target` [B, 4h, 4w,
        C]. Each weighted `loss_cfg` entry whose name holds `rec_loss` is
        an output-vs-target reconstruction, one holding `QNR_loss` is
        1 - QNR of the output against the batch's LrMS and PAN (the PAN
        bicubic-downsampled, `losses.qnr_loss`); any other entry is no
        term of this total (the adversarial one is the Runner's).
        `iter_id` is for a method whose loss follows the iteration
        (MutInf). Under a data-parallel step's generator
        (`parallel.mesh.ShardGenerator`: the batch is the rank's rows)
        every part is the global batch's value, and the rank's backward
        reaches its own rows (`mesh.batch_mean`, `batch_sum`,
        `batch_rows`)."""
        ms = _nchw(batch["input_lr"], self.device)
        pan = _nchw(batch["input_pan"], self.device)
        out = self.forward(ms, pan, generator)
        total = torch.zeros((), device=self.device)
        parts = {}
        for name, lcfg in build_loss_weights(self.cfg.loss_cfg).items():
            if "rec_loss" in name:
                value = batch_mean(reconstruction_loss(
                    out, _nchw(batch["target"], self.device), lcfg.type),
                    generator)
            elif "QNR_loss" in name:
                nhwc = lambda t: t.permute(0, 2, 3, 1)
                value = qnr_loss(nhwc(pan), nhwc(ms), nhwc(out),
                                 generator=generator)
            else:
                continue
            total = total + lcfg.w * value
            parts[name] = value
        parts["full_loss"] = total
        return (total, parts, out) if with_output else (total, parts)

    @contextlib.contextmanager
    def training_cast(self, dtype: torch.dtype):
        """Inside it, every module's floating parameters are a `dtype`
        copy made with gradients (`.to(dtype)`, so that a backward reaches
        the float32 parameters, as the JAX Runner's `cast16` of its
        params is differentiable) and the ops promote as `jax_promotion`
        says; the float32 parameters are put back on leaving."""
        with contextlib.ExitStack() as stack:
            for module in self.modules().values():
                stack.enter_context(swapped(module, {
                    name: p.to(dtype) for name, p in module.named_parameters()
                    if p.is_floating_point()}))
            stack.enter_context(jax_promotion())
            yield


class swapped:  # noqa: N801  (a context manager)
    """Module `module`'s parameters named in `tensors` replaced by those
    tensors while inside, the parameters put back on leaving."""

    def __init__(self, module: nn.Module, tensors: dict):
        self.module, self.tensors, self.saved = module, tensors, []

    def __enter__(self):
        for name, t in self.tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = self.module.get_submodule(owner)
            self.saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        return self

    def __exit__(self, *exc):
        for mod, leaf, p in reversed(self.saved):
            mod._parameters[leaf] = p
        self.saved = []


class ClassicalMethod:
    """A training-free method: no module and no parameters, and of
    `TorchMethod`'s surface what the Runner calls on such a method.
    `fuse_fn(lrms, pan)` takes NHWC [B, h, w, C] and [B, H, W, 1] tensors
    in [0, 1] and returns [B, H, W, C] clipped to [0, 1]."""

    trainable = False
    training = False
    handles_mixed = False
    adv_name = None
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
