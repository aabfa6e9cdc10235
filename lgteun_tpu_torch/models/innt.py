"""INNT (CTINN, AAAI'22), the invertible network with a texture
transformer, on [B, C, H, W] (counterpart of `lgteun_tpu/models/innt.py`;
reference INNT.py).

    m_hr   = bicubic(ms, pan size, align_corners=True)
    panf, mhrf = convpan(pan), convms(m_hr)           (n_feat/2 each)
    out    = cat(conv_fusion(cat(mhrf, panf)), PatchFusion(mhrf, panf))
    3 InvBlocks over HIN dense subnets; fuse(cat(input, block 2 output))
    hr     = Refine(hr) + m_hr

`PatchFusion` cuts 24x24 patches at stride 8 (padding 8) and reads the
unfold output [B, C*576, L] as [B*L, C, 24, 24] with a plain view, no
permute: the reference's layout scramble, which its trained weights
expect. The fold back sums the overlaps with no normalisation. Inside,
`TransformerFusion` matches each MS patch-image (the query) against the
PAN one (the ref) through `texture_match` (whole chain), or with
`whole_chain=False` through F.unfold + norm, `patch_match` and F.fold.

The attribute names are the reference's, so `state_dict()` carries its
keys (`conv_process.convms.weight`, `extract.operations.0.invconv.p`,
`refine.process.0.conv_du.0.bias`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.common.inv_blocks import InvBlock
from lgteun_tpu_torch.models.common.layers import Conv
from lgteun_tpu_torch.models.common.refine import Refine
from lgteun_tpu_torch.models.mutinf import _HINConvBlock, _XConv1
from lgteun_tpu_torch.ops.patch_match_kernel import patch_match
from lgteun_tpu_torch.ops.patches import extract_patches, fold_patches
from lgteun_tpu_torch.ops.resize import resize_bicubic
from lgteun_tpu_torch.ops.texture_match_kernel import (row_normalize,
                                                       texture_match)

__all__ = ["TransformerFusion", "PatchFusion", "GPPNNINNT"]

_PATCH, _STRIDE, _PAD = 24, 8, 8


class TransformerFusion(nn.Module):
    """Normalised cross-correlation search of 3x3 sub-patches and hard
    transfer (reference INNT.py:100-143) on [N, C, h, h] patch-images:
    conv_trans(cat(t, lrsr)) * s + lrsr."""

    def __init__(self, features: int, whole_chain: bool = True):
        super().__init__()
        self.whole_chain = whole_chain
        self.conv_trans = nn.Sequential(Conv(2 * features, features, 3),
                                        nn.ReLU(), Conv(features, features, 3))

    def forward(self, lrsr: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        n, c, h, w = lrsr.shape
        if self.whole_chain:
            t, s = texture_match(lrsr.reshape(n, c, h * w),
                                 ref.reshape(n, c, h * w))
            t = t.view(n, c, h, w)
        else:
            lr_u = extract_patches(lrsr, 3, 1, 1)        # [N, 9C, L]
            ref_u = extract_patches(ref, 3, 1, 1)
            t_u, s = patch_match(
                row_normalize(lr_u, 1).transpose(1, 2).contiguous(),
                row_normalize(ref_u, 1).transpose(1, 2).contiguous(), ref_u)
            t = fold_patches(t_u, (h, w), 3, 1, 1) / 9.0
        s = s.view(n, 1, h, w)
        return self.conv_trans(torch.cat([t, lrsr], dim=1)) * s + lrsr


class PatchFusion(nn.Module):
    """24x24 / stride-8 patch decomposition around TransformerFusion
    with the reference's scrambling views (INNT.py:148-163)."""

    def __init__(self, features: int, whole_chain: bool = True):
        super().__init__()
        self.fuse = TransformerFusion(features, whole_chain)

    def forward(self, msf: torch.Tensor, panf: torch.Tensor) -> torch.Tensor:
        b, c, h, w = msf.shape
        ms_u = extract_patches(msf, _PATCH, _STRIDE, _PAD)  # [B, C*576, L]
        pan_u = extract_patches(panf, _PATCH, _STRIDE, _PAD)
        length = ms_u.shape[-1]
        scramble = lambda u: u.view(b * length, c, _PATCH, _PATCH)
        fused = self.fuse(scramble(ms_u), scramble(pan_u))
        return fold_patches(fused.reshape(b, c * _PATCH * _PATCH, length),
                            (h, w), _PATCH, _STRIDE, _PAD)


class _DenseBlockINNT(nn.Module):
    """Two chained HIN conv blocks, gc = 16 (reference INNT.py:235-253)."""

    def __init__(self, in_ch: int, out_ch: int, gc: int = 16):
        super().__init__()
        self.conv1 = _HINConvBlock(in_ch, gc)
        self.conv2 = _HINConvBlock(gc, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.leaky_relu(self.conv1(x), 0.2)
        return F.leaky_relu(self.conv2(x1), 0.2)


class _FeatureExtract(nn.Module):
    """The InvBlock stack and its 1x1 fuse. The fuse takes the stack's
    input and the outputs of the blocks after the second only
    (reference INNT.py:335-341)."""

    def __init__(self, n_feat: int, block_num: int):
        super().__init__()
        self.operations = nn.ModuleList(
            InvBlock(n_feat, n_feat // 2, subnet=_DenseBlockINNT)
            for _ in range(block_num))
        self.fuse = _XConv1(n_feat * (block_num - 1), n_feat, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        for i, op in enumerate(self.operations):
            x = op(x)
            if i > 1:
                outs.append(x)
        return self.fuse(torch.cat(outs, dim=1))


class _ConvProcess(nn.Module):
    def __init__(self, ms_chans: int, half: int):
        super().__init__()
        self.convpan = Conv(1, half, 3)
        self.convms = Conv(ms_chans, half, 3)


class _ConvFusion(nn.Module):
    def __init__(self, n_feat: int, half: int):
        super().__init__()
        self.conv = Conv(n_feat, half, 3)


class GPPNNINNT(nn.Module):
    """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> HrMS [B, C, 4h, 4w]
    (reference INNT.py:370-404)."""

    def __init__(self, ms_chans: int, n_feat: int = 8, block_num: int = 3,
                 whole_chain: bool = True):
        super().__init__()
        half = n_feat // 2
        self.conv_process = _ConvProcess(ms_chans, half)
        self.conv_fusion = _ConvFusion(n_feat, half)
        self.transform_fusion = PatchFusion(half, whole_chain)
        self.extract = _FeatureExtract(n_feat, block_num)
        self.refine = Refine(n_feat, ms_chans)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        m_hr = resize_bicubic(ms, tuple(pan.shape[-2:]), align_corners=True)
        panf = self.conv_process.convpan(pan)
        mhrf = self.conv_process.convms(m_hr)
        conv_f = self.conv_fusion.conv(torch.cat([mhrf, panf], dim=1))
        trans_f = self.transform_fusion(mhrf, panf)
        hr = self.extract(torch.cat([conv_f, trans_f], dim=1))
        return self.refine(hr) + m_hr
