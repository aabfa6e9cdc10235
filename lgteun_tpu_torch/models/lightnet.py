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

The bf16 tap path (`lightnet_fast_forward`, counterpart of
`lgteun_tpu/models/lightnet.py:87-143`): the JAX package's bf16
LightNet on the TPU runs the stack as plain XLA in NCHW, not its
kernel: each pointwise conv, each of the nine depthwise taps' multiply
and add, each bias add and ReLU on bf16 tensors with bf16 weights, one
rounding an op; the upsampled lms stays float32 and the output is lms +
the stack's float32 upcast. Here it is the same chain of plain torch
ops, each rounding to the dtype it is given (`tap_dtype`).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_stack
from lgteun_tpu_torch.ops.resize import sample_scale as sampling

__all__ = ["LightNetModule", "lightnet_fast_forward", "tap_stack",
           "tap_dtype"]


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
        if ms.dtype == torch.bfloat16:
            return self._module_forward(ms, pan)
        lms = sampling(sampling(ms, 2), 2)
        x = torch.cat([pan, lms], dim=1)
        return lightnet_stack(x, lms, [s.weights() for s in self.spans()])

    def _module_forward(self, ms: torch.Tensor,
                        pan: torch.Tensor) -> torch.Tensor:
        """The forward on bfloat16 inputs and weights (the JAX Runner's
        blanket `mixed_precision` cast) as the JAX package's flax module
        computes it (`lgteun_tpu/models/lightnet.py:65-80`): each resize
        in float32, rounded once; each conv rounded, then its bias add.
        JAX trains LightNet on this module, never on its kernel or its
        tap path (`:165-167`), so no kernel of either package computes
        this function: these are plain torch ops by design, not a plain
        version standing in for `lightnet_stack` (float32 only)."""
        lms = sampling(sampling(ms, 2), 2)

        def conv(x, c):
            return F.conv2d(x, c.weight, padding=c.padding,
                            groups=c.groups) + c.bias[None, :, None, None]

        def span(x, s):
            return (conv(conv(x, s.point_wise_1), s.depth_wise_1)
                    + conv(conv(x, s.point_wise_2), s.depth_wise_2))

        spans = self.spans()
        x = torch.cat([pan, lms], dim=1)
        for s in spans[:3]:
            x = span(x, s)
        x = F.relu(x)
        for conv1, conv2 in (spans[3:5], spans[5:7]):
            x = span(F.relu(span(x, conv1)), conv2)
        for s in spans[7:]:
            x = span(x, s)
        return lms + x


def tap_dtype() -> torch.dtype | None:
    """torch.bfloat16 where LightNet's eval forward takes the bf16 tap
    path (env LGTEUN_LIGHTNET_DTYPE, else LGTEUN_EVAL_DTYPE, equal to
    "bf16"; read when the method is built), else None (the kernel,
    float32). JAX's `lightnet.apply` tests `"bf16" in` the same value
    (`lgteun_tpu/models/lightnet.py:172-174`), so "bf16res" puts its
    LightNet on the bf16 path too; bf16res is UnlgFormer's mixer-branch
    mode and `_eval_dtype` tests == "bf16", so here it leaves LightNet
    float32 (ROADMAP C.39)."""
    mode = (os.environ.get("LGTEUN_LIGHTNET_DTYPE")
            or os.environ.get("LGTEUN_EVAL_DTYPE"))
    return torch.bfloat16 if mode == "bf16" else None


def _pw_nchw(x, conv: nn.Conv2d, dtype):
    """1x1 conv, then the bias add (two roundings, as the JAX einsum and
    add)."""
    y = F.conv2d(x, conv.weight.to(dtype))
    return y + conv.bias.to(dtype)[None, :, None, None]


def _dw_nchw(x, conv: nn.Conv2d, dtype):
    """3x3 depthwise conv as 9 shifted scaled adds in (dy, dx) order,
    then the bias add."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    kern = conv.weight.to(dtype)
    acc = None
    for dy in range(3):
        for dx in range(3):
            piece = xp[:, :, dy:dy + h, dx:dx + w] * kern[:, 0, dy, dx][
                None, :, None, None]
            acc = piece if acc is None else acc + piece
    return acc + conv.bias.to(dtype)[None, :, None, None]


def _span_nchw(x, span: _SpanConv, dtype):
    a = _dw_nchw(_pw_nchw(x, span.point_wise_1, dtype), span.depth_wise_1,
                 dtype)
    b = _dw_nchw(_pw_nchw(x, span.point_wise_2, dtype), span.depth_wise_2,
                 dtype)
    return a + b


def lightnet_fast_forward(module: LightNetModule, ms: torch.Tensor,
                          pan: torch.Tensor,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The tap path (module docstring): ms [B, C, h, w] + pan [B, 1, 4h,
    4w] float32 -> [B, C, 4h, 4w] float32, the stack in `dtype`."""
    lms = sampling(sampling(ms, 2), 2)
    x = tap_stack(module, torch.cat([pan, lms], dim=1).to(dtype), dtype)
    return lms + x.to(lms.dtype)


def tap_stack(module: LightNetModule, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The tap path's ten SpanConvs on x = cat(pan, lms) in `dtype`; each
    depthwise conv zero-pads its own input along H and W."""
    spans = module.spans()
    for span in spans[:3]:
        x = _span_nchw(x, span, dtype)
    x = F.relu(x)
    for conv1, conv2 in (spans[3:5], spans[5:7]):
        x = _span_nchw(F.relu(_span_nchw(x, conv1, dtype)), conv2, dtype)
    for span in spans[7:]:
        x = _span_nchw(x, span, dtype)
    return x
