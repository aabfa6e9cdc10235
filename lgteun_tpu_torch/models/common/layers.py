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
from torch import nn

from lgteun_tpu_torch.ops.norm import channel_layer_norm
from lgteun_tpu_torch.ops.resize import sample_scale as sampling

__all__ = ["Conv", "PointConv", "DepConv", "ChannelLayerNorm", "Resample",
           "sampling", "trunc_normal_", "init_parameters"]


class Conv(nn.Conv2d):
    """nn.Conv2d with 'same' padding for odd kernels and a seeded
    torch-default init."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 groups: int = 1):
        super().__init__(in_ch, out_ch, kernel_size,
                         padding=kernel_size // 2, groups=groups)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


class PointConv(Conv):
    """1x1 conv (reference `point_conv`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 1)


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
    count)."""

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
