"""Scale-factor bicubic resize on [B, C, H, W] (counterpart of
`lgteun_tpu/ops/resize.py::sample_scale_cm`).

The JAX package builds torch-equivalent resize matrices because the TPU
has no bicubic op; here `F.interpolate` is the reference's own op."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["sample_scale"]


def sample_scale(x: torch.Tensor, s_factor: float,
                 mode: str = "bicubic") -> torch.Tensor:
    """LGTEUN's `sampling_`: resize by `s_factor` with
    align_corners=False; output size floor(in * s_factor); no-op at 1."""
    if s_factor == 1:
        return x
    return F.interpolate(x, scale_factor=s_factor, mode=mode,
                         align_corners=False)
