"""LightNet, the SpanConv lightweight CNN (IJCAI'22), on [B, C, H, W]
(counterpart of `lgteun_tpu/models/lightnet.py`; reference
lightnet.py:85-135).

    lms = bicubic_up2(bicubic_up2(ms))
    out = lms + stack(cat(pan, lms))

The stack is ten SpanConv layers (head C+1 -> C+1 -> 20 -> 32 + ReLU,
two bellies of SpanConv -> ReLU -> SpanConv, tail 32 -> 16 -> 8 -> C);
it runs as one call of `lightnet_stack`. The attribute names are the
reference's, so `state_dict()` carries its keys (`head_conv.0.
point_wise_1.weight`, `belly_conv.1.conv2.depth_wise_2.bias`, ...).

Init: kaiming-normal (fan_out) conv weights and zero biases (reference
lightnet.py:113-117), drawn from an explicit generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_stack
from lgteun_tpu_torch.ops.resize import sample_scale as sampling

__all__ = ["LightNetModule"]


class _SpanConv(nn.Module):
    """Two parallel pointwise -> depthwise 3x3 branches, summed
    (reference lightnet.py:19-67)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.point_wise_1 = nn.Conv2d(in_ch, out_ch, 1)
        self.depth_wise_1 = nn.Conv2d(out_ch, out_ch, 3, padding=1,
                                      groups=out_ch)
        self.point_wise_2 = nn.Conv2d(in_ch, out_ch, 1)
        self.depth_wise_2 = nn.Conv2d(out_ch, out_ch, 3, padding=1,
                                      groups=out_ch)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        for conv in (self.point_wise_1, self.depth_wise_1,
                     self.point_wise_2, self.depth_wise_2):
            w = conv.weight
            fan_out = w.shape[0] * w.shape[2] * w.shape[3]
            w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            conv.bias.zero_()

    def weights(self) -> tuple[torch.Tensor, ...]:
        """(pw1, pb1, dw1, db1, pw2, pb2, dw2, db2), as `lightnet_stack`
        takes them."""
        return tuple(t for conv in (self.point_wise_1, self.depth_wise_1,
                                    self.point_wise_2, self.depth_wise_2)
                     for t in (conv.weight, conv.bias))


class _Belly(nn.Module):
    """SpanConv -> ReLU -> SpanConv (reference lightnet.py:71-82)."""

    def __init__(self, ch: int = 32):
        super().__init__()
        self.conv1 = _SpanConv(ch, ch)
        self.conv2 = _SpanConv(ch, ch)


class LightNetModule(nn.Module):
    """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> HrMS [B, C, 4h, 4w]."""

    def __init__(self, ms_chans: int):
        super().__init__()
        c5 = ms_chans + 1
        self.head_conv = nn.ModuleList([_SpanConv(c5, c5), _SpanConv(c5, 20),
                                        _SpanConv(20, 32)])
        self.belly_conv = nn.ModuleList([_Belly(32), _Belly(32)])
        self.tail_conv = nn.ModuleList([_SpanConv(32, 16), _SpanConv(16, 8),
                                        _SpanConv(8, ms_chans)])

    def spans(self) -> list[_SpanConv]:
        """The ten SpanConvs in the order of `lightnet_layers`."""
        belly = [conv for blk in self.belly_conv
                 for conv in (blk.conv1, blk.conv2)]
        return [*self.head_conv, *belly, *self.tail_conv]

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        lms = sampling(sampling(ms, 2), 2)
        x = torch.cat([pan, lms], dim=1)
        return lightnet_stack(x, lms, [s.weights() for s in self.spans()])
