"""Central-difference convolutions on [B, C, H, W] (counterpart of
`lgteun_tpu/models/common/cdc.py`; reference CDC.py:77-185).

`_FiveTapConv` holds 5 taps per (out, in) pair, stored as the
reference's (1, 5) kernel, scattered into a 3x3 cross or diagonal
pattern; it subtracts theta times the 1x1 conv whose weight is the sum
of the taps. `CDCConv` blends the cross and diagonal branches with a
sigmoid gate (`HP_branch`, initialised to 0: an even blend; the
reference leaves it uninitialised) and adds the identity. No biases;
torch-default init of the taps (fan-in 5 x in).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CDCConv"]

# the taps' positions in the 3x3 kernel, row-major flat indices
_CROSS_POS = (1, 3, 4, 5, 7)    # (0,1) (1,0) (1,1) (1,2) (2,1)
_DIAG_POS = (0, 2, 4, 6, 8)     # (0,0) (0,2) (1,1) (2,0) (2,2)


@functools.lru_cache(maxsize=None)
def _positions_on(positions: tuple, device: torch.device) -> torch.Tensor:
    """The positions as an index tensor on `device`, made once (a Python
    list index would be copied to the card, and waited for, each call),
    outside inference mode (a training step may save it)."""
    with torch.inference_mode(False):
        return torch.tensor(positions, device=device)


class _FiveTapConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, positions: tuple,
                 theta: float = 0.8):
        super().__init__()
        self.positions, self.theta = positions, theta
        self.conv = nn.Conv2d(in_ch, out_ch, (1, 5), bias=False)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(5 * self.conv.in_channels)
        self.conv.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        taps = self.conv.weight[:, :, 0]                     # [out, in, 5]
        kernel = taps.new_zeros(*taps.shape[:2], 9)
        kernel[..., _positions_on(self.positions, taps.device)] = taps
        out = F.conv2d(x, kernel.view(*taps.shape[:2], 3, 3), padding=1)
        diff = F.conv2d(x, taps.sum(-1)[..., None, None])
        return out - self.theta * diff


class CDCConv(nn.Module):
    """sigmoid(g) * cross + (1 - sigmoid(g)) * diagonal + x."""

    def __init__(self, ch: int, theta: float = 0.8):
        super().__init__()
        self.h_conv = _FiveTapConv(ch, ch, _CROSS_POS, theta)
        self.d_conv = _FiveTapConv(ch, ch, _DIAG_POS, theta)
        self.HP_branch = nn.Parameter(torch.empty(1))

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.HP_branch.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.sigmoid(self.HP_branch[0])
        return g * self.h_conv(x) + (1.0 - g) * self.d_conv(x) + x
