"""MDCUN, the memory-augmented deep conditional unfolding network
(CVPR'22), on [B, C, H, W] (counterpart of `lgteun_tpu/models/mdcun.py`;
reference MDCUN.py:311-419 `pan_unfolding`). T stages of:

    uk = conv_u[i](cat(uk_1..uk_{i-1}, x));  decode_u = denoise(uk) + uk
    nl = blockNL(x)                        (neighbourhood attention)
    vk = conv_u[i](cat(vk_1..vk_{i-1}, nl)); decode_v = denoise(vk) + vk
    x <- x - delta_i (up(down(x) - ms + u_i (down(nl) - ms))
                      + eta_i (x - decode_u) + gama_i (nl - decode_v))

starting from x = bilinear_up4(ms). `denoise` gates a high-pass PAN
pyramid (pan - bicubic_up(bicubic_down(pan, s)), s = 2, 4, 8, mixed by a
1x1 conv) with the shared spatial attention `rm1` of each of the first
four bands (the reference hard-codes four; >4-band inputs go back to C
bands through `conv1x1`). The four per-band calls share weights and run
as one call with the bands folded into the batch, as the JAX package
does.

The attribute names are the reference's, so `state_dict()` carries its
keys, including two the flax tree has no leaf for: the aliases of each
ResnetBlock's convs and PReLU under `layers.N` (the reference registers
them twice) and `conv1x1`, which exists for 4-band models too though
only >4-band inputs use it. The scalars u/eta/gama/delta and every
PReLU slope hold one value each, as shape [1] tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.common.layers import Conv
from lgteun_tpu_torch.ops.nonlocal_kernel import neighborhood_attention
from lgteun_tpu_torch.ops.resize import resize_bicubic, resize_bilinear

__all__ = ["AttSpatial", "BlockNL", "PanUnfolding"]


def _scalar_as_one(state_dict: dict, key: str) -> None:
    """A 0-d entry `key` of `state_dict` (the flax tree's form) as the
    shape [1] the module holds; any other shape is left to the strict
    load, which raises on it."""
    t = state_dict.get(key)
    if isinstance(t, torch.Tensor) and t.dim() == 0:
        state_dict[key] = t.reshape(1)


class _PReLU(nn.Module):
    """nn.PReLU with one shared slope, initialised to 0.5. Loads the
    slope as [1] or [] (stored as [1])."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        _scalar_as_one(state_dict, prefix + "weight")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.weight.fill_(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight)


class _ConvBlock(nn.Module):
    """Bias-free 3x3 conv -> PReLU (the reference's ConvBlock with
    bias=False, norm=None)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, 3, bias=False)
        self.act = _PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))


class _ResnetBlock(nn.Module):
    """conv -> PReLU -> conv -> PReLU, plus the input, with one shared
    PReLU and residual scale 1.0 (reference MDCUN.py:254-311; its
    `ResnetBlock(32, 3, 1, 1, 0.1, ...)` puts the 0.1 on `bias`)."""

    def __init__(self, ch: int = 32):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3)
        self.conv2 = Conv(ch, ch, 3)
        self.act = _PReLU()
        # the reference registers the same modules again (aliased keys)
        self.layers = nn.Sequential(self.conv1, self.act, self.conv2,
                                    self.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x) + x


class AttSpatial(nn.Module):
    """Spatial attention of (band, pan) pairs [N, 2, H, W] -> gate
    [N, 1, H, W] (reference MDCUN.py:178-196, res_num = 3)."""

    def __init__(self, res_num: int = 3):
        super().__init__()
        self.block = nn.Sequential(_ConvBlock(2, 32),
                                   *(_ResnetBlock(32) for _ in range(res_num)))
        self.spatial = _ConvBlock(2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        compress = torch.cat([y.amax(dim=1, keepdim=True),
                              y.mean(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.spatial(compress))


class BlockNL(nn.Module):
    """15x15 neighbourhood non-local attention (reference
    MDCUN.py:64-107): bias-free 1x1 projections t, p, g, w around
    `neighborhood_attention`."""

    def __init__(self, ch: int, fs: int = 15):
        super().__init__()
        self.fs = fs
        self.t = Conv(ch, ch, 1, bias=False)
        self.p = Conv(ch, ch, 1, bias=False)
        self.g = Conv(ch, ch, 1, bias=False)
        self.w = Conv(ch, ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mats = [m.weight.flatten(1) for m in (self.t, self.p, self.g, self.w)]
        return neighborhood_attention(x, *mats, self.fs)


class _Resampler(nn.Module):
    """conv-relu, then x4 nearest up (Conv_up) or 4x4 max-pool
    (Conv_down), then two convs (reference MDCUN.py:110-175)."""

    def __init__(self, ch: int, mid: int, up: bool):
        super().__init__()
        self.body = nn.Sequential(Conv(ch, mid, 3), nn.ReLU())
        self.tail = nn.Sequential(
            nn.Upsample(scale_factor=4) if up else nn.MaxPool2d(4),
            Conv(mid, ch, 3), Conv(ch, ch, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.body(x))


class _Scalars(nn.ParameterList):
    """One [1] parameter a stage; loads each as [1] or [] (stored as
    [1])."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for i in range(len(self)):
            _scalar_as_one(state_dict, f"{prefix}{i}")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _scalars(stages: int) -> nn.ParameterList:
    return _Scalars(nn.Parameter(torch.empty(1)) for _ in range(stages))


class PanUnfolding(nn.Module):
    """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> HrMS [B, C, 4h, 4w]."""

    def __init__(self, ms_chans: int, mid_channels: int = 64,
                 stages: int = 4):
        super().__init__()
        c = ms_chans
        self.stages = stages
        self.hf_pan = Conv(3, 1, 1)
        self.conv1x1 = Conv(4, c, 1)
        self.rm1 = AttSpatial()
        self.NLBlock = BlockNL(c)
        self.conv_up = _Resampler(c, mid_channels, up=True)
        self.conv_down = _Resampler(c, mid_channels, up=False)
        self.conv_u = nn.ModuleList(
            nn.Sequential(Conv((i + 1) * c, 64, 3), Conv(64, c, 3))
            for i in range(stages))
        self.u, self.eta = _scalars(stages), _scalars(stages)
        self.gama, self.delta = _scalars(stages), _scalars(stages)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        for plist, value in ((self.u, 0.5), (self.eta, 0.5),
                             (self.gama, 0.5), (self.delta, 0.1)):
            for p in plist:
                p.fill_(value)

    def _denoise(self, feat, pan, pan_hp):
        """Per-band (first four) spatial gates on the high-pass PAN
        (reference MDCUN.py:369-388)."""
        b = feat.shape[0]
        bands = feat[:, :4].transpose(0, 1).reshape(4 * b, 1,
                                                    *feat.shape[2:])
        gates = self.rm1(torch.cat([bands, pan.repeat(4, 1, 1, 1)], dim=1))
        decoded = pan_hp + gates.view(4, b, *gates.shape[2:]).transpose(
            0, 1) * pan_hp
        if feat.shape[1] > 4:
            decoded = self.conv1x1(decoded)
        return decoded

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        big = tuple(pan.shape[-2:])

        def highpass(s):
            down = resize_bicubic(pan, (big[0] // s, big[1] // s))
            return pan - resize_bicubic(down, big)

        pan_hp = self.hf_pan(torch.cat([highpass(2), highpass(4),
                                        highpass(8)], dim=1))
        x = resize_bilinear(ms, big)
        uk_list: list[torch.Tensor] = []
        vk_list: list[torch.Tensor] = []
        for i in range(self.stages):
            uk = self.conv_u[i](torch.cat(uk_list + [x], dim=1))
            decode_u = self._denoise(uk, pan, pan_hp) + uk
            uk_list.append(decode_u)
            nl = self.NLBlock(x)
            vk = self.conv_u[i](torch.cat(vk_list + [nl], dim=1))
            decode_v = self._denoise(vk, pan, pan_hp) + vk
            vk_list.append(decode_v)
            x = x - self.delta[i] * (
                self.conv_up(self.conv_down(x) - ms
                             + self.u[i] * (self.conv_down(nl) - ms))
                + self.eta[i] * (x - decode_u)
                + self.gama[i] * (nl - decode_v))
        return x
