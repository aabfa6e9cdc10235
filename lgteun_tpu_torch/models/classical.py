"""The classical (training-free) pan-sharpening methods, batched on the
device (counterpart of `lgteun_tpu/models/classical.py`; the reference
runs them in numpy, one image at a time: models/GSA.py:49-119,
models/SFIM.py:21-58, models/Wavelet.py:21-58, timed at 22-59 ms/img on
an RTX 3090 host in its Table 4).

Each function takes
    lrms [B, h, w, C]  normalised [0, 1] LrMS
    pan  [B, H, W, 1]  normalised [0, 1] PAN, H = ratio * h
and returns the fused HrMS [B, H, W, C] clipped to [0, 1], in the dtype
and on the device of its inputs. Their products and convolutions are
FP32 in float32: the caller keeps TF32 off (the Runner does).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops.filters import depthwise_conv2d
from lgteun_tpu_torch.ops.interp23 import interp23_upsample
from lgteun_tpu_torch.ops.resize import resize_bicubic
from lgteun_tpu_torch.ops.wavelet import haar_wavedec2, haar_waverec2

__all__ = ["sfim_fuse", "gsa_fuse", "wavelet_fuse", "lstsq_min_norm"]


def sfim_fuse(lrms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
    """Smoothing-Filter-based Intensity Modulation (IJRS'00): interp23
    upsample; the PAN histogram-matched to each band (mean, std with
    ddof 1); a box lowpass of odd size ratio + 1 with a wrap border;
    out = u_hs * pan_m / lowpass(pan_m)."""
    ratio = pan.shape[-3] // lrms.shape[-3]
    u_hs = interp23_upsample(lrms, ratio)
    k = ratio + 1 if ratio % 2 == 0 else ratio
    n_pix = pan.shape[-3] * pan.shape[-2]
    pan_mean = pan.mean(dim=(1, 2), keepdim=True)
    pan_var = ((pan - pan_mean) ** 2).sum(dim=(1, 2), keepdim=True) / (
        n_pix - 1)
    hs_mean = u_hs.mean(dim=(1, 2), keepdim=True)
    hs_var = ((u_hs - hs_mean) ** 2).sum(dim=(1, 2), keepdim=True) / (
        n_pix - 1)
    pan_m = (pan - pan_mean) * torch.sqrt(hs_var / pan_var) + hs_mean
    pad = k // 2
    pan_pad = F.pad(pan_m.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                    mode="circular")
    lrpan = depthwise_conv2d(pan_pad, np.full((k, k), 1.0 / (k * k)))
    out = u_hs * pan_m / (lrpan.permute(0, 2, 3, 1) + 1e-8)
    return out.clamp(0.0, 1.0)


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched minimum-norm least squares [B, M, N] x = [B, M, K] through
    the pseudo-inverse (SVD), singular values below eps * max(M, N) of
    the largest cut, as `jnp.linalg.lstsq`'s default rcond. A constant
    band makes GSA's design rank-deficient; torch.linalg.lstsq on CUDA
    solves only with `gels`, which assumes full rank."""
    m, n = a.shape[-2:]
    rtol = torch.finfo(a.dtype).eps * max(m, n)
    return torch.linalg.pinv(a, rtol=rtol) @ b


def gsa_fuse(lrms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt Adaptive (TGRS'07): interp23 upsample, means removed;
    the synthetic intensity's weights by least squares of the
    bicubic-downsampled PAN on the LrMS bands and a bias; injection gains
    cov(I0, band, ddof 1) / var(I0, ddof 0), as the reference mixes them;
    the PAN-minus-intensity detail injected, band means restored."""
    b, h, w, c = lrms.shape
    big_h, big_w = pan.shape[1], pan.shape[2]
    n_pix = big_h * big_w
    u_hs = interp23_upsample(lrms, big_h // h)
    means = u_hs.mean(dim=(1, 2), keepdim=True)
    image_lr = u_hs - means
    image_lr_lp = lrms - lrms.mean(dim=(1, 2), keepdim=True)
    image_hr = pan - pan.mean(dim=(1, 2, 3), keepdim=True)
    image_hr0 = resize_bicubic(image_hr.permute(0, 3, 1, 2), (h, w),
                               align_corners=False)
    ones = lambda n: torch.ones(b, n, 1, dtype=lrms.dtype,
                                device=lrms.device)
    design = torch.cat([image_lr_lp.reshape(b, h * w, c), ones(h * w)], -1)
    alpha = lstsq_min_norm(design, image_hr0.reshape(b, h * w, 1))
    design_hr = torch.cat([image_lr.reshape(b, n_pix, c), ones(n_pix)], -1)
    intensity = (design_hr @ alpha).reshape(b, n_pix)
    i0 = intensity - intensity.mean(dim=1, keepdim=True)
    i0_centered = i0 - i0.mean(dim=1, keepdim=True)
    bands = image_lr.reshape(b, n_pix, c)
    bands_centered = bands - bands.mean(dim=1, keepdim=True)
    cov = (i0_centered[:, None, :] @ bands_centered)[:, 0] / (n_pix - 1)
    var_i0 = (i0_centered * i0_centered).mean(dim=1, keepdim=True)
    g = cov / var_i0                                           # [B, C]
    delta = image_hr - i0.reshape(b, big_h, big_w, 1)
    fused = image_lr + g[:, None, None, :] * delta
    fused = fused - fused.mean(dim=(1, 2), keepdim=True) + means
    return fused.clamp(0.0, 1.0)


def wavelet_fuse(lrms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
    """Additive wavelet substitution (IGARSS'01): level-2 Haar
    decomposition of the PAN; each band keeps its own interp23
    approximation coefficients and takes the PAN's details."""
    u_hs = interp23_upsample(lrms, pan.shape[-3] // lrms.shape[-3])
    c = u_hs.shape[-1]
    pan_coeffs = haar_wavedec2(pan.permute(0, 3, 1, 2), level=2)
    hs_coeffs = haar_wavedec2(u_hs.permute(0, 3, 1, 2), level=2)
    details = [tuple(d.expand(-1, c, -1, -1) for d in det)
               for det in pan_coeffs[1:]]
    rec = haar_waverec2([hs_coeffs[0]] + details)
    return rec.permute(0, 2, 3, 1).clamp(0.0, 1.0)
