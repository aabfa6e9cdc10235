"""The discriminators of adversarial training on [B, C, H, W]
(counterpart of `lgteun_tpu/models/common/discriminators.py:58-200`;
reference models/common/modules.py:111-160, 225-262).

    PixelDiscriminator   1x1 convs: n -> 2n (+ norm) -> 1 logit a pixel
    PatchDiscriminator   PatchGAN: 4x4 stride-2 convs (pad 1), n_layers
                         deep, a stride-1 4x4 conv, a 4x4 conv to 1 logit
    VGGDiscriminator     ten 3x3 convs, stride 2 at the odd ones, then
                         Dense 1024 and Dense 1: one logit an image

Norms: "IN" (the default) is instance norm with a learned per-channel
scale and bias, as flax `GroupNorm(group_size=1)`: eps 1e-6, not torch's
1e-5; None is no norm; "BN" raises, as in the JAX package (its batch
statistics do not fit the two-optimiser step). LeakyReLU slope 0.2.

Two of the JAX package's geometries are kept (ROADMAP C.41, C.42):
`VGGDiscriminator`'s 3x3 convs pad as flax "SAME" does, which at stride 2
on an even side is (0, 1), not torch's symmetric (1, 1); and its fc0
takes the NHWC flatten, (h, w, c). The port flattens NCHW, (c, h, w), so
`convert/from_jax.py::discriminator_from_flax` permutes fc0's rows, as
`mi_from_flax` does for MutInf (C.34), and the port computes JAX's
function with the carried weights.

Every parameter has a seeded torch-default init (`reset_from`):
U(+-1/sqrt(fan_in)) for conv and linear weights and biases, ones and
zeros for a norm.

The blocks of the same reference file (JAX `:108-237`):

    ResBlock        conv0-norm0-relu-conv1-norm1 + x (reference
                    modules.py:50-66)
    ResChAttnBlock  c1a-n1a-relu-c1b-n1b, a channel attention (the mean,
                    fc0 to C / 2, relu, fc1, sigmoid) a, c2 of cat(a * y,
                    y) and n2, + x (reference modules.py:69-108)
    SFTLayer        features * (scale + 1) + shift, each of scale and
                    shift two 1x1 convs of the conditions with LeakyReLU
                    0.1 between (reference modules.py:263-276)
    mean_shift      the frozen per-channel affine x / std + sign *
                    rgb_range * mean / std (reference modules.py:169-180)
    VGGFeat         torchvision vgg19 `features[0:12]` after the ImageNet
                    mean_shift, read at relu1_1, relu2_1 and relu3_1
                    (reference modules.py:182-223)

The first three take the JAX module's layer names (the JAX package maps
no reference keys to them, and the repository records none); `VGGFeat`
is an `nn.Sequential` whose
state_dict is torchvision's `features[0:12]` one (weights at 0, 2, 5, 7,
10), so a torchvision state_dict loads as it is and
`convert/from_jax.py::vgg_feat_from_flax` is the inverse of JAX's
`convert_vgg_feat`. The 3x3 convs pad 1; "BN" raises as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["PixelDiscriminator", "PatchDiscriminator", "VGGDiscriminator",
           "ResBlock", "ResChAttnBlock", "SFTLayer", "mean_shift", "VGGFeat",
           "same_pad", "vgg_side"]

_SLOPE = 0.2
_IN_EPS = 1e-6      # flax GroupNorm's default epsilon


class _Conv(nn.Conv2d):
    """nn.Conv2d with a seeded torch-default init."""

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


class _Linear(nn.Linear):
    """nn.Linear with a seeded torch-default init."""

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


class _InstanceNorm(nn.GroupNorm):
    """flax GroupNorm(group_size=1): one group a channel, eps 1e-6. flax
    takes the variance as E[x^2] - E[x]^2 (`use_fast_variance`), the same
    function, which loses digits to cancellation in float32 where the
    mean is large against the spread (2.1e-4 of max|out| off float64 on
    a case of `tests/test_torch_port_gan.py`); here the mean is taken
    out first."""

    def __init__(self, ch: int):
        super().__init__(ch, ch, eps=_IN_EPS)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def _norm(norm_type: str | None, ch: int) -> nn.Module:
    if norm_type is None:
        return nn.Identity()
    if norm_type == "BN":
        raise ValueError(
            "norm_type='BN' is not supported for discriminators (batch "
            "statistics do not fit the two-optimiser GAN step); use "
            "norm_type='IN' (instance norm) or None")
    if norm_type == "IN":
        return _InstanceNorm(ch)
    raise ValueError(f"no such norm layer: {norm_type!r}")


class PixelDiscriminator(nn.Module):
    """1x1-conv per-pixel discriminator: [B, C, H, W] -> [B, 1, H, W]."""

    def __init__(self, in_ch: int, n_feats: int = 64,
                 norm_type: str | None = "IN"):
        super().__init__()
        self.conv0 = _Conv(in_ch, n_feats, 1)
        self.conv1 = _Conv(n_feats, n_feats * 2, 1)
        self.norm1 = _norm(norm_type, n_feats * 2)
        self.conv2 = _Conv(n_feats * 2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv0(x), _SLOPE)
        y = F.leaky_relu(self.norm1(self.conv1(y)), _SLOPE)
        return self.conv2(y)


class PatchDiscriminator(nn.Module):
    """PatchGAN: [B, C, H, W] -> [B, 1, H / 2^n_layers - 2, ...] logits.
    Layers `conv0`, `conv{n}` + `norm{n}` for n < n_layers, `conv_pen` +
    `norm_pen`, `conv_out`: the flax module's names."""

    def __init__(self, in_ch: int, n_feats: int = 64, n_layers: int = 3,
                 norm_type: str | None = "IN"):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = _Conv(in_ch, n_feats, 4, stride=2, padding=1)
        ch = n_feats
        for n in range(1, n_layers):
            out = n_feats * min(2 ** n, 8)
            setattr(self, f"conv{n}", _Conv(ch, out, 4, stride=2, padding=1))
            setattr(self, f"norm{n}", _norm(norm_type, out))
            ch = out
        out = n_feats * min(2 ** n_layers, 8)
        self.conv_pen = _Conv(ch, out, 4, stride=1, padding=1)
        self.norm_pen = _norm(norm_type, out)
        self.conv_out = _Conv(out, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv0(x), _SLOPE)
        for n in range(1, self.n_layers):
            conv, norm = getattr(self, f"conv{n}"), getattr(self, f"norm{n}")
            y = F.leaky_relu(norm(conv(y)), _SLOPE)
        y = F.leaky_relu(self.norm_pen(self.conv_pen(y)), _SLOPE)
        return self.conv_out(y)


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (low, high) of a side n for kernel k and
    stride s: the output has ceil(n / s) positions, the odd pad goes
    high. At k 3, s 2 an even side pads (0, 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


VGG_FEATS = (32, 32, 64, 64, 128, 128, 256, 256, 512, 512)


def vgg_side(in_size: int) -> int:
    """The side of `VGGDiscriminator`'s last feature map for an input of
    side `in_size` (five stride-2 "SAME" convs: ceil(n / 2) each)."""
    side = in_size
    for _ in range(len(VGG_FEATS) // 2):
        side = -(-side // 2)
    return side


class VGGDiscriminator(nn.Module):
    """VGG-style discriminator: [B, C, in_size, in_size] -> [B, 1]. Its
    fc0 is as wide as the flatten of an `in_size` input, as flax's Dense
    takes its width from the input the module is built on (the JAX
    module's own `in_size` field is read by nothing); the flatten is
    NCHW, (c, h, w) (module docstring, C.42)."""

    def __init__(self, in_ch: int, in_size: int = 160):
        super().__init__()
        self.in_size = in_size
        ch = in_ch
        for i, f in enumerate(VGG_FEATS):
            setattr(self, f"conv{i}",
                    _Conv(ch, f, 3, stride=2 if i % 2 else 1, padding=0))
            ch = f
        self.fc0 = _Linear(ch * vgg_side(in_size) ** 2, 1024)
        self.fc1 = _Linear(1024, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(VGG_FEATS)):
            conv = getattr(self, f"conv{i}")
            s = conv.stride[0]
            (ht, hb), (wl, wr) = (same_pad(n, 3, s) for n in x.shape[-2:])
            x = F.leaky_relu(conv(F.pad(x, (wl, wr, ht, hb))), _SLOPE)
        x = F.leaky_relu(self.fc0(x.flatten(1)), _SLOPE)
        return self.fc1(x)


class ResBlock(nn.Module):
    """conv0-norm0-relu-conv1-norm1 + x on n_feats channels."""

    def __init__(self, n_feats: int, norm_type: str | None = "IN"):
        super().__init__()
        self.conv0 = _Conv(n_feats, n_feats, 3, padding=1)
        self.norm0 = _norm(norm_type, n_feats)
        self.conv1 = _Conv(n_feats, n_feats, 3, padding=1)
        self.norm1 = _norm(norm_type, n_feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm0(self.conv0(x)))
        return self.norm1(self.conv1(y)) + x


class ResChAttnBlock(nn.Module):
    """The residual channel-attention block (module docstring)."""

    def __init__(self, n_feats: int, norm_type: str | None = "IN"):
        super().__init__()
        self.c1a = _Conv(n_feats, n_feats, 3, padding=1)
        self.n1a = _norm(norm_type, n_feats)
        self.c1b = _Conv(n_feats, n_feats, 3, padding=1)
        self.n1b = _norm(norm_type, n_feats)
        self.fc0 = _Linear(n_feats, n_feats // 2)
        self.fc1 = _Linear(n_feats // 2, n_feats)
        self.c2 = _Conv(2 * n_feats, n_feats, 3, padding=1)
        self.n2 = _norm(norm_type, n_feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.n1b(self.c1b(F.relu(self.n1a(self.c1a(x)))))
        attn = torch.sigmoid(self.fc1(F.relu(self.fc0(y.mean(dim=(2, 3))))))
        z = self.c2(torch.cat([attn[:, :, None, None] * y, y], dim=1))
        return self.n2(z) + x


class SFTLayer(nn.Module):
    """Spatial feature transform of n_feats-channel features by
    cond_ch-channel conditions (default n_feats)."""

    def __init__(self, n_feats: int = 32, cond_ch: int | None = None):
        super().__init__()
        cond_ch = n_feats if cond_ch is None else cond_ch
        self.scale0 = _Conv(cond_ch, n_feats // 2, 1)
        self.scale1 = _Conv(n_feats // 2, n_feats, 1)
        self.shift0 = _Conv(cond_ch, n_feats // 2, 1)
        self.shift1 = _Conv(n_feats // 2, n_feats, 1)

    def forward(self, features: torch.Tensor,
                conditions: torch.Tensor) -> torch.Tensor:
        s = self.scale1(F.leaky_relu(self.scale0(conditions), 0.1))
        t = self.shift1(F.leaky_relu(self.shift0(conditions), 0.1))
        return features * (s + 1.0) + t


def mean_shift(x: torch.Tensor, rgb_range: float, rgb_mean, rgb_std,
               sign: int = -1) -> torch.Tensor:
    """x / std + sign * rgb_range * mean / std, per channel of
    [B, C, H, W]."""
    mean = torch.as_tensor(rgb_mean, dtype=x.dtype,
                           device=x.device)[:, None, None]
    std = torch.as_tensor(rgb_std, dtype=x.dtype,
                          device=x.device)[:, None, None]
    return x / std + sign * rgb_range * mean / std


class VGGFeat(nn.Sequential):
    """vgg19 `features[0:12]` (module docstring): [B, 3, H, W] ->
    (relu1_1 [B, 64, H, W], relu2_1 [B, 128, H/2, W/2], relu3_1
    [B, 256, H/4, W/4]), after the ImageNet mean_shift when
    `shift_enable`."""

    def __init__(self, rgb_range: float = 1.0, shift_enable: bool = True):
        layers = []
        for conv in ((3, 64), (64, 64), None, (64, 128), (128, 128), None,
                     (128, 256)):
            if conv is None:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [_Conv(*conv, 3, padding=1), nn.ReLU()]
        super().__init__(*layers)
        self.rgb_range, self.shift_enable = rgb_range, shift_enable

    def forward(self, x: torch.Tensor) -> tuple:
        if self.shift_enable:
            x = mean_shift(x, self.rgb_range, (0.485, 0.456, 0.406),
                           tuple(s * self.rgb_range
                                 for s in (0.229, 0.224, 0.225)))
        levels = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in (1, 6, 11):
                levels.append(x)
        return tuple(levels)
