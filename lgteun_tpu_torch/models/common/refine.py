"""Channel-attention refinement tail on [B, C, H, W] (counterpart of
`lgteun_tpu/models/common/refine.py`; reference mz_refine.py:34-117).
Torch-default conv init. The JAX package's `Refine2` (MutInf's tail) is
`Refine(..., n_ca=2)` here. Its `DenseModule` has no caller in any JAX
model and is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from lgteun_tpu_torch.models.common.layers import Conv

__all__ = ["CALayer", "Refine"]


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
