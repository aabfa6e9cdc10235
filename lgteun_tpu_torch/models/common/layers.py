"""Shared building blocks on [B, C, H, W] (counterpart of
`lgteun_tpu/models/common/layers.py`).

Every module with parameters has `reset_from(generator)`, which draws
them as torch's defaults do (Conv2d: U(+-1/sqrt(fan_in)) for weight and
bias; LayerNorm: ones/zeros) but from an explicit `torch.Generator`;
`init_parameters` walks a module tree and calls it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.ops.norm import channel_layer_norm
from lgteun_tpu_torch.ops.resize import sample_scale as sampling

__all__ = ["Conv", "PointConv", "point_conv_mixed", "DepConv",
           "ChannelLayerNorm", "Resample",
           "sampling", "trunc_normal_", "init_parameters"]


class Conv(nn.Conv2d):
    """nn.Conv2d with 'same' padding for odd kernels and a seeded
    torch-default init."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size,
                         padding=kernel_size // 2, groups=groups, bias=bias)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)


class PointConv(Conv):
    """1x1 conv (reference `point_conv`). On a bfloat16 input (the bf16
    storage mode's inter-scale convs, `ops.storage_dtype`) it runs as the
    JAX package's `_pointconv_cm` with a storage dtype: operands rounded
    to bfloat16, the product and the bias in float32, one rounding of the
    result to bfloat16."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        w = self.weight.to(torch.bfloat16).float()
        return F.conv2d(x.float(), w, self.bias).to(torch.bfloat16)


def point_conv_mixed(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """A 1x1 conv as flax's `Conv(dtype=bf16)` computes it (the JAX
    package's `PointConv(dtype=)`, `lgteun_tpu/models/common/layers.py:
    36-78`; UnlgFormer's selective `mixed_precision` proj): x, weight
    [out, in, 1, 1] and bias cast to `dtype`, the product rounded to
    `dtype`, then the bias add in `dtype` (rounded again). The product is
    float32 on the rounded operands."""
    y = F.conv2d(x.to(dtype).float(), weight.to(dtype).float()).to(dtype)
    return y + bias.to(dtype)[None, :, None, None]


class DepConv(Conv):
    """Depthwise kxk conv, zero padding k//2 (reference `dep_conv`)."""

    def __init__(self, ch: int, kernel_size: int = 3):
        super().__init__(ch, ch, kernel_size, groups=ch)


class ChannelLayerNorm(nn.Module):
    """Parameters `weight`/`bias` [C] of a channel LayerNorm."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layer_norm(x, self.weight, self.bias, self.eps)


class Resample(nn.Module):
    """`sampling` as a parameter-free module (it holds an index in the
    reference's nn.Sequential containers, which the state_dict keys
    count). A bfloat16 input is resampled in float32 and rounded once
    (`ops.resize`)."""

    def __init__(self, s_factor: float):
        super().__init__()
        self.s_factor = s_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sampling(x, self.s_factor)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, a: float, b: float,
                  generator: torch.Generator) -> torch.Tensor:
    """torch's trunc_normal_ (mean 0, absolute bounds [a, b]) by inverse
    CDF from a seeded uniform draw."""
    cdf = lambda v: (1.0 + math.erf(v / math.sqrt(2.0))) / 2.0
    lo, hi = cdf(a / std), cdf(b / std)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0))
    return t.clamp_(a, b)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` from `generator`, in module
    registration order (so a seed fixes the whole tree)."""
    for m in module.modules():
        if hasattr(m, "reset_from"):
            m.reset_from(generator)
