"""Local-Global Transformer (LGT), LGTEUN's prior, on [B, C, H, W].

Counterpart of `lgteun_tpu/models/common/lgt.py` with the semantics of
`lgteun_tpu/models/lgteun_fast.py::_lgb_cm` / `_lgt_cm`:

  patch_embed -> [LGB, down x2ch]* -> bottleneck LGB
              -> [up /2ch, skip-fuse, LGB]* -> tail + residual

The module tree keeps the reference's attribute names, so `state_dict()`
carries the reference's keys (e.g. `encoder_layers.0.0.blocks.0.0.fn.fn.
local_mixer.to_qkv.weight`) and `lgteun_tpu.convert.convert_state_dict`
maps it onto the flax tree. `_Residual` / `_PreNorm` / `LGMixer` /
`GlobalMixer` / `FeedForward` hold parameters under those names; each LGB
block runs as three kernels (`LGB.forward`):

    y1, x2 = ln_mixer_head(x)          LN, split, FFT global mixer
    x1     = window_attention(y1)      the local mixer
    x      = block_tail(x, x1, x2)     proj + residual, LN + FFN + residual

Dropout(0.1) after the mixer proj is inert at eval and is not modelled
(training is a later slice).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lgteun_tpu_torch.models.common.layers import (
    ChannelLayerNorm,
    Conv,
    DepConv,
    PointConv,
    Resample,
    trunc_normal_,
)
from lgteun_tpu_torch.ops.ffn_kernel import block_tail
from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head
from lgteun_tpu_torch.ops.window_attention import window_attention

__all__ = ["LocalMixer", "GlobalMixer", "LGMixer", "FeedForward", "LGB",
           "LGT"]


class LocalMixer(nn.Module):
    """8x8-window MHSA with a learned [1, heads, S, S] position bias
    (reference LGT.py:112-146)."""

    def __init__(self, ch: int, win: int = 8, heads: int = 2):
        super().__init__()
        self.win, self.heads = win, heads
        s = win * win
        self.pos_emb = nn.Parameter(torch.empty(1, heads, s, s))
        self.to_qkv = PointConv(ch, 3 * ch)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pos_emb, std=1.0, a=-2.0, b=2.0,
                      generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        c = y.shape[1]
        return window_attention(y, self.to_qkv.weight.view(3 * c, c),
                                self.to_qkv.bias, self.pos_emb[0],
                                self.heads, self.win)


class GlobalMixer(nn.Module):
    """Per-channel affine on FFT amplitude and phase: the reference's
    1x1 depthwise conv_amp / conv_pha (reference LGT.py:149-180). Its
    computation runs inside `ln_mixer_head`."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv_amp = nn.Sequential(Conv(ch, ch, 1, groups=ch))
        self.conv_pha = nn.Sequential(Conv(ch, ch, 1, groups=ch))

    def affine(self):
        """(amp_w, amp_b, pha_w, pha_b), each [C]."""
        a, p = self.conv_amp[0], self.conv_pha[0]
        return a.weight.view(-1), a.bias, p.weight.view(-1), p.bias


class LGMixer(nn.Module):
    """Half-channel local/global split and the 1x1 proj (reference
    LGT.py:183-219)."""

    def __init__(self, ch: int, win: int = 8, heads: int = 2):
        super().__init__()
        self.local_mixer = LocalMixer(ch // 2, win, heads)
        self.global_mixer = GlobalMixer(ch // 2)
        self.proj = PointConv(ch, ch)


class _DepthwiseConv(nn.Module):
    """point conv then depthwise 3x3 (reference `depthwise_conv`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.point_conv = PointConv(in_ch, out_ch)
        self.depth_conv = DepConv(out_ch, 3)


class FeedForward(nn.Module):
    """point(4x) -> GELU -> point+depthwise -> GELU -> point
    (reference LGT.py:91-109). Its computation runs inside
    `block_tail`."""

    def __init__(self, ch: int, ratio: int = 4):
        super().__init__()
        self.net = nn.Sequential(PointConv(ch, ch * ratio), nn.GELU(),
                                 _DepthwiseConv(ch * ratio, ch * ratio),
                                 nn.GELU(), PointConv(ch * ratio, ch))


class _PreNorm(nn.Module):
    def __init__(self, ch: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(ch)
        self.fn = fn


class _Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class LGB(nn.Module):
    """num_blocks x [x += mixer(LN(x)); x += ffn(LN(x))]
    (reference LGT.py:222-248), each block as the three kernels."""

    def __init__(self, ch: int, num_blocks: int, win: int = 8,
                 heads: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleList([
                _Residual(_PreNorm(ch, LGMixer(ch, win, heads))),
                _Residual(_PreNorm(ch, FeedForward(ch))),
            ]) for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        for mix_res, ffn_res in self.blocks:
            norm, mixer = mix_res.fn.norm, mix_res.fn.fn
            y1, x2 = ln_mixer_head(x, norm.weight, norm.bias,
                                   *mixer.global_mixer.affine(),
                                   eps=norm.eps)
            x1 = mixer.local_mixer(y1)
            ffn_norm, net = ffn_res.fn.norm, ffn_res.fn.fn.net
            c4 = net[0].weight.shape[0]
            ffn = {"ln_w": ffn_norm.weight, "ln_b": ffn_norm.bias,
                   "w1": net[0].weight.view(c4, c), "b1": net[0].bias,
                   "w2": net[2].point_conv.weight.view(c4, c4),
                   "b2": net[2].point_conv.bias,
                   "dw": net[2].depth_conv.weight.view(c4, 3, 3),
                   "bdw": net[2].depth_conv.bias,
                   "w3": net[4].weight.view(c, c4), "b3": net[4].bias}
            x = block_tail(x, x1, x2, mixer.proj.weight.view(c, c),
                           mixer.proj.bias, ffn, eps=ffn_norm.eps)
        return x


class _PatchEmbed(nn.Module):
    """depthwise 1x1 + point conv + channel LN (reference LGT.py:64-88,
    patch_size 1)."""

    def __init__(self, in_ch: int, embed: int):
        super().__init__()
        self.proj = nn.Sequential(Conv(in_ch, in_ch, 1, groups=in_ch),
                                  PointConv(in_ch, embed))
        self.norm = ChannelLayerNorm(embed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class LGT(nn.Module):
    """U-shaped local-global transformer (reference LGT.py:251-344):
    [B, in_ch, H, W] -> [B, in_ch, H, W] with a residual add."""

    def __init__(self, in_ch: int, embed: int, win: int = 8,
                 num_block: Sequence[int] = (2, 1), heads: int = 2):
        super().__init__()
        self.patch_embed = _PatchEmbed(in_ch, embed)
        scales = len(num_block)
        ch = embed
        enc = []
        for i in range(scales - 1):
            enc.append(nn.ModuleList([
                LGB(ch, num_block[i], win, heads),
                nn.Sequential(Resample(0.5), PointConv(ch, ch * 2))]))
            ch *= 2
        self.encoder_layers = nn.ModuleList(enc)
        self.bottleneck = LGB(ch, num_block[-1], win, heads)
        dec = []
        for i in range(scales - 1):
            dec.append(nn.ModuleList([
                nn.Sequential(Resample(2), PointConv(ch, ch // 2)),
                PointConv(ch, ch // 2),
                LGB(ch // 2, num_block[scales - 2 - i], win, heads)]))
            ch //= 2
        self.decoder_layers = nn.ModuleList(dec)
        self.tail = nn.Sequential(Resample(1), PointConv(embed, in_ch))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        fea = self.patch_embed(z)
        skips = []
        for lgb, down in self.encoder_layers:
            fea = lgb(fea)
            skips.append(fea)
            fea = down(fea)
        fea = self.bottleneck(fea)
        for up, fuse, lgb in self.decoder_layers:
            fea = fuse(torch.cat([up(fea), skips.pop()], dim=1))
            fea = lgb(fea)
        return self.tail(fea) + z
