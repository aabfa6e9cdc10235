"""PanFormer, the cross Swin transformer (ICME'22), on [B, C, H, W]
(counterpart of `lgteun_tpu/models/panformer.py`; reference
panformer.py:21-108).

    pan_feat = 2 Swin stages at downscale 2 each   (PAN 4h -> h)
    ms_feat  = 2 Swin stages at downscale 1        (stays h)
    n_blocks x: pan_feat, ms_feat = cross(pan_feat <- ms_feat),
                                    cross(ms_feat <- pan_feat)
               (k, v from the first stream, q from the other)
    out = HR_tail(cat(pan_feat, ms_feat)): conv3x3, PixelShuffle 2, ReLU,
          conv3x3, PixelShuffle 2, ReLU, conv3x3, ReLU, conv3x3
    clamped to [0, 1] (norm_input) or [0, 2^bit_depth - 0.5]

`forward(ms, pan)` takes JAX's argument order (the reference's module
takes (pan, ms)); `unclamped` is the tail's output before the clamp. The
Swin stages work in NHWC (`common/swin.py`). The attribute names are the
reference's (`pan_encoder.0.patch_partition.linear.weight`,
`ms_cross_pan.2.layers.0.1.attention_block.fn.fn.to_q.weight`,
`HR_tail.8.bias`, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from lgteun_tpu_torch.models.common.layers import Conv
from lgteun_tpu_torch.models.common.swin import SwinModule

__all__ = ["CrossSwinTransformer"]


class CrossSwinTransformer(nn.Module):
    def __init__(self, ms_chans: int, n_feats: int = 64, n_heads: int = 4,
                 head_dim: int = 16, win_size: int = 4, n_blocks: int = 3,
                 norm_input: bool = True, bit_depth: int = 11):
        super().__init__()
        self.hi = 1.0 if norm_input else 2.0 ** bit_depth - 0.5

        def swin(in_ch, ds, cross=False):
            return SwinModule(in_ch, n_feats, 2, ds, n_heads, head_dim,
                              win_size, cross)

        self.pan_encoder = nn.Sequential(swin(1, 2), swin(n_feats, 2))
        self.ms_encoder = nn.Sequential(swin(ms_chans, 1), swin(n_feats, 1))
        self.pan_cross_ms = nn.ModuleList(swin(n_feats, 1, True)
                                          for _ in range(n_blocks))
        self.ms_cross_pan = nn.ModuleList(swin(n_feats, 1, True)
                                          for _ in range(n_blocks))
        self.HR_tail = nn.Sequential(
            Conv(n_feats * 2, n_feats * 4, 3), nn.PixelShuffle(2), nn.ReLU(),
            Conv(n_feats, n_feats * 4, 3), nn.PixelShuffle(2), nn.ReLU(),
            Conv(n_feats, n_feats, 3), nn.ReLU(),
            Conv(n_feats, ms_chans, 3))

    def unclamped(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> [B, C, 4h, 4w] before
        the clamp; h and w multiples of the window."""
        pan_feat = self.pan_encoder(pan.permute(0, 2, 3, 1))
        ms_feat = self.ms_encoder(ms.permute(0, 2, 3, 1))
        for pan_cross, ms_cross in zip(self.pan_cross_ms, self.ms_cross_pan):
            pan_feat, ms_feat = (pan_cross(pan_feat, ms_feat),
                                 ms_cross(ms_feat, pan_feat))
        x = torch.cat([pan_feat, ms_feat], dim=-1).permute(0, 3, 1, 2)
        return self.HR_tail(x)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        return self.unclamped(ms, pan).clamp(0.0, self.hi)
