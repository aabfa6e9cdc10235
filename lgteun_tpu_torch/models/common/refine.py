"""Channel-attention refinement tails on [B, C, H, W] (counterpart of
`lgteun_tpu/models/common/refine.py`; reference mz_refine.py:16-117).
Torch-default conv init.

    CALayer      conv3x3-relu-conv3x3 -> mean -> squeeze/excite
    Refine       conv_in -> n_ca CALayers -> conv_last
    Refine2      Refine with two CALayers (MutInf's tail)
    DenseModule  three chained 3x3 convs (LeakyReLU 0.2) and a 1x1 conv
                 over the concat of the input and the three
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.common.layers import Conv

__all__ = ["CALayer", "Refine", "Refine2", "DenseModule"]


class CALayer(nn.Module):
    """conv3x3-relu-conv3x3 -> global mean -> squeeze/excite -> z*y + x.
    The residual adds the *pooled* z*y, a per-channel bias (the
    reference's quirk, kept)."""

    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        self.process = nn.Sequential(Conv(ch, ch, 3), nn.ReLU(),
                                     Conv(ch, ch, 3))
        self.conv_du = nn.Sequential(Conv(ch, ch // reduction, 1), nn.ReLU(),
                                     Conv(ch // reduction, ch, 1),
                                     nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.process(x).mean(dim=(2, 3), keepdim=True)
        return self.conv_du(y) * y + x


class Refine(nn.Module):
    """conv_in -> n_ca CALayers -> conv_last."""

    def __init__(self, in_ch: int, out_ch: int, n_ca: int = 1):
        super().__init__()
        self.conv_in = Conv(in_ch, in_ch, 3)
        self.process = nn.Sequential(*(CALayer(in_ch, 4)
                                       for _ in range(n_ca)))
        self.conv_last = Conv(in_ch, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_last(self.process(self.conv_in(x)))


class Refine2(Refine):
    """Refine with two CALayers (reference mz_refine.py:100-117)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, n_ca=2)


class DenseModule(nn.Module):
    """conv1 -> conv2 -> conv3 (3x3, LeakyReLU 0.2 after each), then the
    1x1 conv4 of cat(x, the three): C -> C (reference
    mz_refine.py:16-31)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3)
        self.conv2 = Conv(ch, ch, 3)
        self.conv3 = Conv(ch, ch, 3)
        self.conv4 = Conv(4 * ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = F.leaky_relu(self.conv1(x), 0.2)
        b = F.leaky_relu(self.conv2(a), 0.2)
        d = F.leaky_relu(self.conv3(b), 0.2)
        return self.conv4(torch.cat([x, a, b, d], dim=1))
