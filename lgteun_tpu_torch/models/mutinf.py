"""MutInf's building blocks on [B, C, H, W] (counterpart of
`lgteun_tpu/models/mutinf.py`; reference MutInf.py:137-160).

Only `_XConv1` and `_HINConvBlock` so far, which INNT shares; the rest of
MutInf comes with its slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.common.layers import Conv

__all__ = ["_XConv1", "_HINConvBlock"]


class _XConv1(Conv):
    """Conv with xavier-normal (scale 1) weights and zero bias: the
    init the reference's `initialize()` leaves (MutInf.py:279-293,
    INNT.py:319-333)."""

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        std = math.sqrt(2.0 / ((in_ch + out_ch) * kh * kw))
        self.weight.normal_(0.0, std, generator=generator)
        self.bias.zero_()


class _HINConvBlock(nn.Module):
    """conv3x3 -> instance norm of the first half of the channels
    (population variance, eps 1e-5, affine) -> leaky ReLU -> conv3x3 ->
    leaky ReLU, plus a 1x1 identity conv of the input."""

    def __init__(self, in_ch: int, out_ch: int, relu_slope: float = 0.1):
        super().__init__()
        self.relu_slope = relu_slope
        self.identity = _XConv1(in_ch, out_ch, 1)
        self.conv_1 = _XConv1(in_ch, out_ch, 3)
        self.conv_2 = _XConv1(out_ch, out_ch, 3)
        # instance statistics at eval too (no running stats)
        self.norm = nn.InstanceNorm2d(out_ch // 2, affine=True,
                                      track_running_stats=False)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_1(x)
        half = self.norm.num_features
        out = F.leaky_relu(torch.cat([self.norm(out[:, :half]),
                                      out[:, half:]], dim=1),
                           self.relu_slope)
        out = F.leaky_relu(self.conv_2(out), self.relu_slope)
        return out + self.identity(x)
