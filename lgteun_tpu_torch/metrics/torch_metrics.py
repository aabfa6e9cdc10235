"""Batched full-reference metrics on tensors (counterpart of
`lgteun_tpu/metrics/jax_metrics.py`; this slice ports PSNR only)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["psnr_batch"]

_EPS64 = float(np.finfo(np.float64).eps)


def psnr_batch(pred: torch.Tensor, gt: torch.Tensor,
               dynamic_range: float) -> torch.Tensor:
    """[B, H, W, C] -> [B] dB; zero mse clamps to 1e-10 (no inf)."""
    mse = ((pred - gt) ** 2).mean(dim=(1, 2, 3)).clamp_min(1e-10)
    return 20.0 * torch.log10(dynamic_range / (torch.sqrt(mse) + _EPS64))
