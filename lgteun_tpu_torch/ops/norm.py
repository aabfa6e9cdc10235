"""LayerNorm over the channel axis of [B, C, H, W] (the reference's
nn.LayerNorm(C) on channel-last features), shared by the modules and the
kernels' plain versions."""

from __future__ import annotations

import torch

__all__ = ["channel_layer_norm"]


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * weight[None, :, None, None] + bias[None, :, None, None]
