"""Invertible-network parts on [B, C, H, W] (counterpart of
`lgteun_tpu/models/common/inv_blocks.py`; reference SFIIN.py:26-207),
shared by SFIIN, MutInf and INNT:

- `InvertibleConv1x1`: the LU-parameterised invertible 1x1 conv;
- `UNetConvBlock` / `DenseBlock`: SFIIN's affine-coupling subnets, on
  `_XConv` (xavier-normal x 0.1 weights, zero bias, optional dilation);
- `InvBlock`: the invertible 1x1 mixing, then the affine coupling
  y1 = x1 + F(x2), y2 = x2 * exp(clamp * (2 sigmoid(H(y1)) - 1)) + G(y1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InvertibleConv1x1", "UNetConvBlock", "DenseBlock", "InvBlock"]


class InvertibleConv1x1(nn.Module):
    """LU-parameterised invertible 1x1 conv. The permutation `p` and
    `sign_s` are buffers; `l` (strict lower part used), `log_s` and `u`
    (strict upper part used) are parameters:

        w = p @ (l * tril_-1 + I) @ (u * triu_1 + diag(sign_s * exp(log_s)))
    """

    def __init__(self, num_channels: int):
        super().__init__()
        c = num_channels
        self.register_buffer("p", torch.empty(c, c))
        self.register_buffer("sign_s", torch.empty(c))
        self.l = nn.Parameter(torch.empty(c, c))
        self.log_s = nn.Parameter(torch.empty(c))
        self.u = nn.Parameter(torch.empty(c, c))

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """QR of a standard normal draw, then its LU factors (the
        buffers are filled too)."""
        c = self.log_s.shape[0]
        q = torch.linalg.qr(torch.randn(c, c, generator=generator))[0]
        p, l, u = torch.linalg.lu(q)
        s = torch.diagonal(u)
        self.p.copy_(p)
        self.sign_s.copy_(torch.sign(s))
        self.l.copy_(l)
        self.log_s.copy_(torch.log(torch.abs(s)))
        self.u.copy_(torch.triu(u, 1))

    def weight(self) -> torch.Tensor:
        """w in the parameters' dtype, or float32 where they are bfloat16
        (the blanket cast): the strict-triangle mask is a float32
        constant, as JAX's `l_mask` (`lgteun_tpu/models/common/
        inv_blocks.py:61`), so it promotes l and u there."""
        c = self.log_s.shape[0]
        lower = torch.tril(torch.ones(
            c, c, device=self.l.device,
            dtype=torch.promote_types(self.l.dtype, torch.float32)), -1)
        l = self.l * lower + torch.eye(c, device=lower.device,
                                       dtype=lower.dtype)
        u = self.u * lower.T + torch.diag(self.sign_s * torch.exp(self.log_s))
        return self.p @ l @ u

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight()[:, :, None, None])


class _XConv(nn.Conv2d):
    """Conv with xavier-normal weights times `scale` and zero bias, 'same'
    padding at its dilation (the reference's
    `initialize_weights_xavier(..., 0.1)`, SFIIN.py:117-134)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dilation: int = 1, scale: float = 0.1):
        super().__init__(in_ch, out_ch, kernel_size,
                         padding=dilation * (kernel_size - 1) // 2,
                         dilation=dilation)
        self.scale = scale

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        std = self.scale * math.sqrt(2.0 / ((in_ch + out_ch) * kh * kw))
        self.weight.normal_(0.0, std, generator=generator)
        self.bias.zero_()


class UNetConvBlock(nn.Module):
    """conv3x3 -> leaky ReLU -> conv3x3 -> leaky ReLU, plus a 1x1
    identity conv of the input (reference SFIIN.py:137-152)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 relu_slope: float = 0.1):
        super().__init__()
        self.relu_slope = relu_slope
        self.identity = _XConv(in_ch, out_ch, 1)
        self.conv_1 = _XConv(in_ch, out_ch, 3, dilation)
        self.conv_2 = _XConv(out_ch, out_ch, 3, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.conv_1(x), self.relu_slope)
        out = F.leaky_relu(self.conv_2(out), self.relu_slope)
        return out + self.identity(x)


class DenseBlock(nn.Module):
    """Two UNetConvBlocks and a conv3x3 over the dense concat
    (reference SFIIN.py:155-173)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 gc: int = 8):
        super().__init__()
        self.conv1 = UNetConvBlock(in_ch, gc, dilation)
        self.conv2 = UNetConvBlock(gc, gc, dilation)
        self.conv3 = _XConv(in_ch + 2 * gc, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.leaky_relu(self.conv1(x), 0.2)
        x2 = F.leaky_relu(self.conv2(x1), 0.2)
        return F.leaky_relu(self.conv3(torch.cat([x, x1, x2], dim=1)), 0.2)


class InvBlock(nn.Module):
    """Invertible 1x1 mixing, then the affine coupling over subnets
    `subnet(in_ch, out_ch)` (DenseBlock by default; reference
    SFIIN.py:176-207)."""

    def __init__(self, channel_num: int, channel_split_num: int,
                 clamp: float = 0.8, subnet=DenseBlock):
        super().__init__()
        s1, s2 = channel_split_num, channel_num - channel_split_num
        self.split, self.clamp = s1, clamp
        self.invconv = InvertibleConv1x1(channel_num)
        self.F = subnet(s2, s1)
        self.G = subnet(s1, s2)
        self.H = subnet(s1, s2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.invconv(x)
        x1, x2 = x[:, :self.split], x[:, self.split:]
        y1 = x1 + self.F(x2)
        s = self.clamp * (torch.sigmoid(self.H(y1)) * 2 - 1)
        y2 = x2 * torch.exp(s) + self.G(y1)
        return torch.cat([y1, y2], dim=1)
