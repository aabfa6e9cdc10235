"""LGTEUN unfolding network on [B, C, H, W] (counterpart of
`lgteun_tpu/models/lgteun.py`; reference unlg_former.py:21-67):

    Z_0 = bicubic_up4(ms)
    for i in 0..K-1:
        Z <- Z - eta_i * (DT(D(Z) - ms) + RT(R(Z) - pan))
    return LGT_{K-1}(Z)

The reference records every prior's output but never feeds it back into
Z and returns only the last one, so the earlier priors are dead code.
They keep their parameters (checkpoints carry them) but are not run:
torch has no dead-code elimination, and running them would double the
prior's cost for outputs the reference throws away. In training they get
no gradient (`.grad` stays None; JAX's is exactly zero). `mixed`
(bfloat16 under `mixed_precision`) reaches the priors' LGB blocks
(`common/lgt.py`); the unfolding steps stay float32, as JAX's
(`lgteun_tpu/models/lgteun.py:78-103`).
"""

from __future__ import annotations

import torch
from torch import nn

from lgteun_tpu_torch.models.common.layers import (
    DepConv,
    PointConv,
    Resample,
    sampling,
)
from lgteun_tpu_torch.models.common.lgt import LGT

__all__ = ["LGTEUN"]


class LGTEUN(nn.Module):
    """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> HrMS [B, C, 4h, 4w]."""

    def __init__(self, ms_chans: int, stage: int = 2, window_size: int = 8,
                 num_heads: int = 2, level: int = 2, drop_rate: float = 0.1,
                 windows: bool = False, storage: tuple = (None, False),
                 mixed: torch.dtype | None = None):
        super().__init__()
        c = ms_chans
        self.stage = stage
        self.D = nn.Sequential(Resample(0.5), DepConv(c), Resample(0.5),
                               DepConv(c))
        self.DT = nn.Sequential(Resample(2), DepConv(c), Resample(2),
                                DepConv(c))
        self.R = PointConv(c, 1)
        self.RT = PointConv(1, c)
        self.eta = nn.ParameterList(
            nn.Parameter(torch.empty(())) for _ in range(stage))
        self.prior_module = nn.ModuleList(
            LGT(c, c * 4, window_size, (2, 1), num_heads, level, drop_rate,
                windows, storage, mixed)
            for _ in range(stage))

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        for eta in self.eta:
            eta.fill_(0.1)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`generator` draws the priors' dropout masks in training
        (`common/lgt.py`)."""
        z = sampling(ms, 4)
        for eta in self.eta:
            ms_term = self.DT(self.D(z) - ms)
            pan_term = self.RT(self.R(z) - pan)
            z = z - eta * (ms_term + pan_term)
        return self.prior_module[self.stage - 1](z, generator)
