"""SFIIN, the spatial-frequency information integration network (ECCV'22),
on [B, C, H, W] (counterpart of `lgteun_tpu/models/sfiin.py`; reference
SFIIN.py:210-340).

    m_hr = bicubic(ms, pan size, align_corners=True)
    msf, panf = conv_p(m_hr), conv_p1(pan)
    5 SpaFre blocks: a spatial branch (InvBlock over cat(msf, panf),
    1x1), a frequency branch (FreProcess), spatial-attention gating of
    their difference, contrast + mean channel attention
    hr = Refine(fuse(cat of the 5 block outputs)) + m_hr

FreProcess fuses the rfft2 amplitudes and phases of the MS and PAN
features with 1x1 convs and returns |irfft2| of the fused half
spectrum, which is not hermitian. On every device it takes the spectrum
as the UnlgFormer mixer's plain version does (`ops/spectral_kernel.py`):
`plane_rfft2` (the exactly zero bins of constant planes kept zero),
`amp_phase` (the self-conjugate bins exactly real, +0.0 as their
imaginary part: the +pi branch, which JAX's CPU FFT takes at power-of-two
sides) and `mixer_inverse` (an explicit H inverse, then a c2r along W
that drops the imaginary parts of columns 0 and W/2, irfft2's
semantics), so cuFFT gives what pocketfft does. The reference's
epsilons are kept: +1e-8 on pre1 / pre2, then real + 1e-8 + 1e-8 and
imag + 1e-8.

Training adds the reference's frequency losses (SFIIN.py:359-408; JAX
`models/sfiin.py:128-158`): the configured reconstruction loss between
the amplitudes, and between the phases, of the rfft2 over H, W (norm
"backward") of the output and of the target (`spectrum_amp_phase`).

Under the blanket cast (`LGTEUN_EVAL_DTYPE=bf16`, `models/base.py`) the
FFT follows the JAX package's TPU path: its matmul DFT takes the bf16
features to float32 and gives float32 (`lgteun_tpu/ops/fft.py:129`,
`:149-150`, `:183`, `:201-202`; torch.fft has no bfloat16 either), so
FreProcess upcasts before `plane_rfft2`; from there the amplitudes,
phases and the branch's output are float32 and the stream promotes as
JAX's does (the convs after it take float32 inputs with bfloat16
weights: both float32, `base.jax_promotion`), as does the invertible
1x1 conv's float32 mask (`common/inv_blocks.py`).

The attribute names are the reference's (`process.conv_p.weight`,
`process.block3.fre_process.pha_fuse.2.bias`,
`process.block.spa_process.0.invconv.p`, `refine.conv_last.weight`).
"""

from __future__ import annotations

import torch
from torch import nn

from lgteun_tpu_torch.models.common.inv_blocks import InvBlock
from lgteun_tpu_torch.models.common.layers import Conv
from lgteun_tpu_torch.models.common.refine import Refine
from lgteun_tpu_torch.ops import upcast
from lgteun_tpu_torch.ops.resize import resize_bicubic
from lgteun_tpu_torch.ops.spectral_kernel import (amp_phase, mixer_inverse,
                                                  plane_rfft2,
                                                  safe_amp_phase)

__all__ = ["FreProcess", "SpaFre", "SFIINNet", "spectrum_amp_phase"]

_BLOCKS = ("block", "block1", "block2", "block3", "block4")


def _fuse(ch: int) -> nn.Sequential:
    return nn.Sequential(Conv(2 * ch, ch, 1), nn.LeakyReLU(0.1),
                         Conv(ch, ch, 1))


class FreProcess(nn.Module):
    """The frequency branch (reference SFIIN.py:210-237)."""

    def __init__(self, ch: int):
        super().__init__()
        self.pre1 = Conv(ch, ch, 1)
        self.pre2 = Conv(ch, ch, 1)
        self.amp_fuse = _fuse(ch)
        self.pha_fuse = _fuse(ch)
        self.post = Conv(ch, ch, 1)

    def forward(self, msf: torch.Tensor, panf: torch.Tensor) -> torch.Tensor:
        w = msf.shape[-1]
        ms_amp, ms_pha = amp_phase(
            plane_rfft2(upcast(self.pre1(msf) + 1e-8)), w)
        pan_amp, pan_pha = amp_phase(
            plane_rfft2(upcast(self.pre2(panf) + 1e-8)), w)
        amp = self.amp_fuse(torch.cat([ms_amp, pan_amp], dim=1))
        pha = self.pha_fuse(torch.cat([ms_pha, pan_pha], dim=1))
        real = amp * torch.cos(pha) + 1e-8 + 1e-8
        imag = amp * torch.sin(pha) + 1e-8
        return self.post(mixer_inverse(torch.complex(real, imag), w))


class SpaFre(nn.Module):
    """One spatial / frequency fusion block (reference SFIIN.py:240-271)
    -> (msf', the PAN features after `panprocess`)."""

    def __init__(self, ch: int):
        super().__init__()
        self.panprocess = Conv(ch, ch, 3)
        self.panpre = Conv(ch, ch, 1)
        self.spa_process = nn.Sequential(InvBlock(2 * ch, ch),
                                         Conv(2 * ch, ch, 1))
        self.fre_process = FreProcess(ch)
        self.spa_att = nn.Sequential(Conv(ch, ch // 2, 3), nn.LeakyReLU(0.1),
                                     Conv(ch // 2, ch, 3), nn.Sigmoid())
        self.cha_att = nn.Sequential(Conv(2 * ch, ch // 2, 1),
                                     nn.LeakyReLU(0.1),
                                     Conv(ch // 2, 2 * ch, 1), nn.Sigmoid())
        self.post = Conv(2 * ch, ch, 3)

    def forward(self, msf: torch.Tensor, pan: torch.Tensor):
        panpre = self.panprocess(pan)
        panf = self.panpre(panpre)
        spa = self.spa_process(torch.cat([msf, panf], dim=1))
        fre = self.fre_process(msf, panf)
        spa_res = fre * self.spa_att(spa - fre) + spa
        cat_f = torch.cat([spa_res, fre], dim=1)
        mean = cat_f.mean(dim=(2, 3), keepdim=True)
        # population std over the plane (not torch.std)
        contrast = (cat_f - mean).square().mean(dim=(2, 3),
                                                keepdim=True).sqrt()
        cha_res = self.post(self.cha_att(contrast + mean) * cat_f)
        return cha_res + msf, panpre


class _Process(nn.Module):
    def __init__(self, ms_chans: int, ch: int):
        super().__init__()
        self.conv_p = Conv(ms_chans, ch, 3)
        self.conv_p1 = Conv(1, ch, 3)
        for name in _BLOCKS:
            self.add_module(name, SpaFre(ch))
        self.fuse = Conv(len(_BLOCKS) * ch, ch, 1)


class SFIINNet(nn.Module):
    """ms [B, C, h, w] + pan [B, 1, 4h, 4w] -> HrMS [B, C, 4h, 4w]
    (reference SFIIN.py:317-340; channels 8)."""

    def __init__(self, ms_chans: int, channels: int = 8):
        super().__init__()
        self.process = _Process(ms_chans, channels)
        self.refine = Refine(channels, ms_chans)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        m_hr = resize_bicubic(ms, tuple(pan.shape[-2:]), align_corners=True)
        msf = self.process.conv_p(m_hr)
        panf = self.process.conv_p1(pan)
        feats = []
        for name in _BLOCKS:
            msf, panf = getattr(self.process, name)(msf, panf)
            feats.append(msf)
        fused = self.process.fuse(torch.cat(feats, dim=1))
        return self.refine(fused) + m_hr


def spectrum_amp_phase(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(amplitude, phase) of torch.fft.rfft2(x) over H, W of x
    [B, C, H, W], as the frequency losses take them (JAX `SFIIN.losses`
    with `_safe_amp_pha`: 0 and 0, with a finite gradient, at exactly
    zero bins).

    Where H and W are powers of two it runs `amp_phase`, which sets the
    self-conjugate bins exactly real (+0.0 imaginary, so a negative real
    part takes +pi): XLA's CPU FFT leaves those bins so at such sides, so
    the port gives JAX's values there on every device, and cuFFT's
    rounding noise cannot move a target bin across the branch cut. At
    other sides XLA's FFT leaves rounding noise in those bins (ROADMAP
    C.22) and no rule reproduces it; there the FFT's own values go
    through `safe_amp_phase`, the copy of `_safe_amp_pha`. A bfloat16 x
    (the blanket `mixed_precision` cast's target) is upcast first, as the
    JAX package's matmul DFT takes bf16 to float32 (module docstring)."""
    h, w = x.shape[-2:]
    z = torch.fft.rfft2(upcast(x), norm="backward")
    if h & (h - 1) == 0 and w & (w - 1) == 0:
        return amp_phase(z, w)
    return safe_amp_phase(z.real, z.imag)
