"""Overlapping patch extraction and its adjoint on [B, C, H, W]
(counterparts of `lgteun_tpu/ops/patches.py::extract_patches` /
`fold_patches`).

The JAX package rebuilds torch's `F.unfold` / `F.fold` for NHWC arrays
(and a blocked fold for XLA); here they are the reference's own ops, in
torch's layout: patches are [B, C*k*k, L] with the feature axis ordered
(c, kh, kw) and L row-major over the output positions. The fold sums
overlapping contributions, with no normalisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["extract_patches", "fold_patches"]


def extract_patches(x: torch.Tensor, kernel: int, stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*k*k, L] (zero padding)."""
    return F.unfold(x, kernel, padding=padding, stride=stride)


def fold_patches(patches: torch.Tensor, out_hw: tuple[int, int],
                 kernel: int, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """[B, C*k*k, L] -> [B, C, H, W]; overlaps are summed."""
    return F.fold(patches, tuple(out_hw), kernel, padding=padding,
                  stride=stride)
