"""LayerNorm over the channel axis of [B, C, H, W] (the reference's
nn.LayerNorm(C) on channel-last features), shared by the modules and the
kernels' plain versions. A bfloat16 input is upcast: the statistics and
the affine are float32, and the output is rounded once to bfloat16 (the
JAX package's `_ln_cm`)."""

from __future__ import annotations

import torch

__all__ = ["channel_layer_norm"]


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return channel_layer_norm(x.float(), weight, bias, eps).to(x.dtype)
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * weight[None, :, None, None] + bias[None, :, None, None]
