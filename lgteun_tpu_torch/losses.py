"""Training losses of the port (counterpart of `lgteun_tpu/losses.py:39-46,
192`): the mean L1/L2 reconstruction loss and the zero-weight skipping of
the reference's `get_loss_module` (reference losses.py:222-249). The
QNR, mutual-information and adversarial losses come with the methods
that use them."""

from __future__ import annotations

import torch

__all__ = ["reconstruction_loss", "build_loss_weights"]


def reconstruction_loss(out: torch.Tensor, gt: torch.Tensor,
                        loss_type: str = "l1") -> torch.Tensor:
    """mean |out - gt| ("l1") or mean (out - gt)^2 ("l2")."""
    if loss_type == "l1":
        return (out - gt).abs().mean()
    if loss_type == "l2":
        return ((out - gt) ** 2).mean()
    raise ValueError(f"unknown reconstruction loss {loss_type!r}")


def build_loss_weights(loss_cfg: dict) -> dict:
    """{name: cfg} for the losses with |w| > 1e-8; a cfg is a `LossCfg`
    or a dict."""
    weight = lambda cfg: cfg.get("w", 0.0) if isinstance(cfg, dict) \
        else getattr(cfg, "w", 0.0)
    return {name: cfg for name, cfg in (loss_cfg or {}).items()
            if abs(weight(cfg)) > 1e-8}
