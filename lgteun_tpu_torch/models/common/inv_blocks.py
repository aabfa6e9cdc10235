"""Invertible-network parts on [B, C, H, W] (counterpart of
`lgteun_tpu/models/common/inv_blocks.py`; reference SFIIN.py:26-94).

Only `InvertibleConv1x1` so far: SFIIN's `UNetConvBlock`, `DenseBlock`
and `InvBlock` come with the SFIIN slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InvertibleConv1x1"]


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
        c = self.log_s.shape[0]
        lower = torch.tril(torch.ones(c, c, device=self.l.device,
                                      dtype=self.l.dtype), -1)
        l = self.l * lower + torch.eye(c, device=lower.device,
                                       dtype=lower.dtype)
        u = self.u * lower.T + torch.diag(self.sign_s * torch.exp(self.log_s))
        return self.p @ l @ u

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight()[:, :, None, None])
