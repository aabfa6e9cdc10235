"""Bicubic and bilinear resizes on [B, C, H, W] (counterparts of
`lgteun_tpu/ops/resize.py::sample_scale_cm`, `resize_bicubic` and
`resize_bilinear`).

The JAX package builds torch-equivalent resize matrices because the TPU
has no bicubic op; here `F.interpolate` is the reference's own op. A
bfloat16 input (the blanket cast) is resized in float32 and rounded
once, as the JAX package applies its float32 matrices to the upcast
input (`lgteun_tpu/ops/resize.py::_apply_separable`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["sample_scale", "resize_bicubic", "resize_bilinear"]


def _interpolate(x: torch.Tensor, **kwargs) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return F.interpolate(x.float(), **kwargs).to(x.dtype)
    return F.interpolate(x, **kwargs)


def sample_scale(x: torch.Tensor, s_factor: float,
                 mode: str = "bicubic") -> torch.Tensor:
    """LGTEUN's `sampling_`: resize by `s_factor` with
    align_corners=False; output size floor(in * s_factor); no-op at 1."""
    if s_factor == 1:
        return x
    return _interpolate(x, scale_factor=s_factor, mode=mode,
                        align_corners=False)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize to `out_hw` (a = -0.75, clamped border taps)."""
    return _interpolate(x, size=tuple(out_hw), mode="bicubic",
                        align_corners=align_corners)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize to `out_hw` (no antialiasing)."""
    return _interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=align_corners)
