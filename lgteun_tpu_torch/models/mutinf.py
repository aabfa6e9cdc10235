"""MutInf, mutual-information-driven pan-sharpening (CVPR'22), on
[B, C, H, W] (counterpart of `lgteun_tpu/models/mutinf.py`; reference
MutInf.py:137-383).

    m_hr = bicubic(ms, pan size, align_corners=True)
    panf, mhrf = extract_pan(pan), extract_ms(m_hr)   (n_feat/2 each:
                 1x1 conv, two edge blocks of convs + a gated CDC)
    4 InvBlocks over `_DenseBlockMscale` subnets; fuse the outputs of
    blocks 1..3; hr = Refine(n_ca=2)(fused) + m_hr

`GPPNNMutInf` returns (hr, panf, mhrf) as the JAX module does; the eval
path takes hr, training also panf and mhrf (the `mi` module,
`losses.MutualInfoReg`). The coupling subnets are re-initialised
xavier-normal at scale 1 (the reference's `initialize()`,
MutInf.py:279-293).
`_XConv1` and `_HINConvBlock` are INNT's too. The attribute names are the
reference's (`extract_pan.block1.CDC.h_conv.conv.weight`,
`interact.operations.0.F.fusepool.1.weight`, `refine.process.1...`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.common.cdc import CDCConv
from lgteun_tpu_torch.models.common.inv_blocks import InvBlock, _XConv
from lgteun_tpu_torch.models.common.layers import Conv
from lgteun_tpu_torch.models.common.refine import Refine
from lgteun_tpu_torch.ops.resize import resize_bicubic, resize_bilinear

__all__ = ["_XConv1", "_HINConvBlock", "GPPNNMutInf"]


class _XConv1(_XConv):
    """Conv with xavier-normal (scale 1) weights and zero bias: the
    init the reference's `initialize()` leaves (MutInf.py:279-293,
    INNT.py:319-333)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__(in_ch, out_ch, kernel_size, scale=1.0)


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


class _DenseBlockHIN(nn.Module):
    """Two HIN conv blocks (gc = 16) and a conv3x3 over the dense concat
    (reference MutInf.py:163-181)."""

    def __init__(self, in_ch: int, out_ch: int, gc: int = 16):
        super().__init__()
        self.conv1 = _HINConvBlock(in_ch, gc)
        self.conv2 = _HINConvBlock(gc, gc)
        self.conv3 = _XConv1(in_ch + 2 * gc, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.leaky_relu(self.conv1(x), 0.2)
        x2 = F.leaky_relu(self.conv2(x1), 0.2)
        return F.leaky_relu(self.conv3(torch.cat([x, x1, x2], dim=1)), 0.2)


def _gate(ch: int) -> nn.Sequential:
    return nn.Sequential(_XConv1(ch, ch, 1), nn.LeakyReLU(0.1))


class _DenseBlockMscale(nn.Module):
    """One dense block shared over 1x, 1/2x and 1/4x (bilinear,
    align_corners=False, down and back up), the three outputs weighted by
    SE-style gates from their pooled sum and fused by a 1x1 conv
    (reference MutInf.py:184-211). H and W must be multiples of 4: the
    JAX package resizes to H // 2 and H // 4, the reference by a scale
    factor, and the two agree only there."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.ops = _DenseBlockHIN(in_ch, out_ch)
        self.fusepool = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                      *_gate(out_ch))
        self.fc1, self.fc2, self.fc3 = (_gate(out_ch) for _ in range(3))
        self.fuse = _XConv1(3 * out_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if h % 4 or w % 4:
            raise ValueError(f"MutInf's multi-scale block needs sides that "
                             f"are multiples of 4, got {h}x{w}")
        x1 = self.ops(x)
        x2 = resize_bilinear(self.ops(resize_bilinear(x, (h // 2, w // 2))),
                             (h, w))
        x3 = resize_bilinear(self.ops(resize_bilinear(x, (h // 4, w // 4))),
                             (h, w))
        att = self.fusepool(x1 + x2 + x3)
        return self.fuse(torch.cat([x1 * self.fc1(att), x2 * self.fc2(att),
                                    x3 * self.fc3(att)], dim=1))


class _EdgeBlock(nn.Module):
    """conv3x3, then a conv-ReLU-conv residual plus the gated CDC of the
    same features (reference MutInf.py:356-368)."""

    def __init__(self, ch: int):
        super().__init__()
        self.process = Conv(ch, ch, 3)
        self.Res = nn.Sequential(Conv(ch, ch, 3), nn.ReLU(), Conv(ch, ch, 3))
        self.CDC = CDCConv(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.process(x)
        return self.Res(x) + self.CDC(x)


class _FeatureExtract(nn.Module):
    """1x1 conv and two edge blocks (reference MutInf.py:371-383)."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv = Conv(in_ch, ch, 1)
        self.block1 = _EdgeBlock(ch)
        self.block2 = _EdgeBlock(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(self.conv(x)))


class _FeatureInteract(nn.Module):
    def __init__(self, n_feat: int, block_num: int):
        super().__init__()
        self.operations = nn.ModuleList(
            InvBlock(n_feat, n_feat // 2, subnet=_DenseBlockMscale)
            for _ in range(block_num))
        self.fuse = _XConv1(n_feat * (block_num - 1), n_feat, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, op in enumerate(self.operations):
            x = op(x)
            if i >= 1:
                outs.append(x)
        return self.fuse(torch.cat(outs, dim=1))


class GPPNNMutInf(nn.Module):
    """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> (HrMS [B, C, 4h, 4w],
    panf, mhrf) (reference MutInf.py:313-345); 4h and 4w multiples of
    4."""

    def __init__(self, ms_chans: int, n_feat: int = 8, block_num: int = 4):
        super().__init__()
        self.extract_pan = _FeatureExtract(1, n_feat // 2)
        self.extract_ms = _FeatureExtract(ms_chans, n_feat // 2)
        self.interact = _FeatureInteract(n_feat, block_num)
        self.refine = Refine(n_feat, ms_chans, n_ca=2)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor):
        m_hr = resize_bicubic(ms, tuple(pan.shape[-2:]), align_corners=True)
        panf = self.extract_pan(pan)
        mhrf = self.extract_ms(m_hr)
        fused = self.interact(torch.cat([panf, mhrf], dim=1))
        return self.refine(fused) + m_hr, panf, mhrf
