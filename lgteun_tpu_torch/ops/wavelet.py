"""Haar 2-D discrete wavelet transform, pywt-compatible (counterpart of
`lgteun_tpu/ops/wavelet.py`; the reference's Wavelet method calls
`pywt.wavedec2(..., 'haar', level=2)` and `waverec2`, reference
models/Wavelet.py:38-46).

The orthonormal Haar pair on non-overlapping pairs is a reshape and a
butterfly on [..., H, W] (even H and W). Coefficients follow pywt:
`haar_wavedec2` returns [cA_n, (cH_n, cV_n, cD_n), ..., (cH_1, cV_1,
cD_1)], cH holding the row-direction detail.
"""

from __future__ import annotations

import math

import torch

__all__ = ["haar_dwt2", "haar_idwt2", "haar_wavedec2", "haar_waverec2"]

_S = 1.0 / math.sqrt(2.0)


def haar_dwt2(x: torch.Tensor):
    """One Haar level on [..., H, W] -> (cA, (cH, cV, cD)), each
    [..., H/2, W/2]."""
    a, b = x[..., 0::2, :], x[..., 1::2, :]
    lo_r = (a + b) * _S
    hi_r = (a - b) * _S
    ll = (lo_r[..., 0::2] + lo_r[..., 1::2]) * _S
    lh = (lo_r[..., 0::2] - lo_r[..., 1::2]) * _S
    hl = (hi_r[..., 0::2] + hi_r[..., 1::2]) * _S
    hh = (hi_r[..., 0::2] - hi_r[..., 1::2]) * _S
    return ll, (lh, hl, hh)


def haar_idwt2(ca: torch.Tensor, details) -> torch.Tensor:
    """Inverse of `haar_dwt2`."""
    lh, hl, hh = details
    h2, w2 = ca.shape[-2], ca.shape[-1]
    lo_r = torch.stack([(ca + lh) * _S, (ca - lh) * _S], dim=-1).reshape(
        *ca.shape[:-1], w2 * 2)
    hi_r = torch.stack([(hl + hh) * _S, (hl - hh) * _S], dim=-1).reshape(
        *ca.shape[:-1], w2 * 2)
    out = torch.stack([(lo_r + hi_r) * _S, (lo_r - hi_r) * _S], dim=-2)
    return out.reshape(*ca.shape[:-2], h2 * 2, w2 * 2)


def haar_wavedec2(x: torch.Tensor, level: int = 2) -> list:
    """pywt.wavedec2-compatible coefficient list of [..., H, W]."""
    coeffs = []
    ca = x
    for _ in range(level):
        ca, det = haar_dwt2(ca)
        coeffs.append(det)
    return [ca] + coeffs[::-1]


def haar_waverec2(coeffs: list) -> torch.Tensor:
    """Inverse of `haar_wavedec2`."""
    ca = coeffs[0]
    for det in coeffs[1:]:
        ca = haar_idwt2(ca, det)
    return ca
