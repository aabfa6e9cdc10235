"""Training losses of the port (counterpart of `lgteun_tpu/losses.py:39-135,
192`): the mean L1/L2 reconstruction loss, the zero-weight skipping of
the reference's `get_loss_module` (reference losses.py:222-249) and
MutInf's mutual-information regulariser (`MutualInfoReg`, reference
losses.py:162-219). The QNR and adversarial losses are not ported
(ROADMAP A.8)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["reconstruction_loss", "build_loss_weights", "MutualInfoReg"]


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


def _kl_normal(mu1, s1, mu2, s2) -> torch.Tensor:
    """KL(N(mu1, s1) || N(mu2, s2)) summed over the latent dimensions."""
    return (torch.log(s2 / s1) + (s1 ** 2 + (mu1 - mu2) ** 2)
            / (2 * s2 ** 2) - 0.5).sum(dim=-1)


def _bce_sum(p, q) -> torch.Tensor:
    p = p.clamp(1e-7, 1 - 1e-7)
    return -(q * torch.log(p) + (1 - q) * torch.log(1 - p)).sum()


class MutualInfoReg(nn.Module):
    """MutInf's `mi` module on [B, C_in, H, W] features (reference
    `Mutual_info_reg`, losses.py:162-219; JAX `lgteun_tpu/losses.py:
    60-135`).

    Each of the two feature maps goes through its own pair of k4/s2/p1
    convs (layer1 then layer3, layer2 then layer4) with LeakyReLU 0.01
    between them and is flattened in NCHW order, (c, h, w), as the
    reference's `view(-1, channel * 32 * 32)` does; four linear heads
    give tanh-squashed (mu, logvar) pairs. The value is

        BCE(sig(z_a), sig(z_b).detach()) + BCE(sig(z_b), sig(z_a).detach())
        - KL(a || b) - KL(b || a)

    with the sums of `_bce_sum` (p clipped to [1e-7, 1 - 1e-7]),
    z = mu + exp(logvar / 2) eps, and the reference's quirk that the KL's
    normals take scale = exp(logvar). `side` is the encoded side, the
    PAN side / 4 (32 in the reference, which hard-codes it); the heads
    are `channels * side**2` wide. The JAX module flattens (h, w, c)
    instead (ROADMAP C.34): `convert/from_jax.py::mi_from_flax` permutes
    its Dense rows, so that the two compute one function.

    The noise eps [B, latent] of each branch is drawn from `generator`
    (a on its own, then b), or given as `noise` = (eps_a, eps_b) for a
    parity test, as the JAX module's `noise=`."""

    def __init__(self, input_channels: int = 4, channels: int = 4,
                 latent_size: int = 4, side: int = 32):
        super().__init__()
        conv = lambda cin: nn.Conv2d(cin, channels, 4, stride=2, padding=1)
        self.layer1, self.layer2 = conv(input_channels), conv(input_channels)
        self.layer3, self.layer4 = conv(channels), conv(channels)
        width = channels * side * side
        self.fc1_rgb3, self.fc2_rgb3, self.fc1_depth3, self.fc2_depth3 = (
            nn.Linear(width, latent_size) for _ in range(4))

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """torch's default init of each conv and linear layer, U(+-1 /
        sqrt(fan_in)) for weight and bias, drawn from `generator`."""
        for layer in self.children():
            bound = layer.weight[0].numel() ** -0.5
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, feat_a: torch.Tensor, feat_b: torch.Tensor,
                generator: torch.Generator | None = None,
                noise=None) -> torch.Tensor:
        fa = self.layer3(F.leaky_relu(self.layer1(feat_a), 0.01)).flatten(1)
        fb = self.layer4(F.leaky_relu(self.layer2(feat_b), 0.01)).flatten(1)
        mu_a, logvar_a = (torch.tanh(self.fc1_rgb3(fa)),
                          torch.tanh(self.fc2_rgb3(fa)))
        mu_b, logvar_b = (torch.tanh(self.fc1_depth3(fb)),
                          torch.tanh(self.fc2_depth3(fb)))
        if noise is None:
            eps_a, eps_b = (torch.randn(mu.shape, generator=generator,
                                        device=mu.device)
                            for mu in (mu_a, mu_b))
        else:
            eps_a, eps_b = (torch.as_tensor(e, dtype=mu_a.dtype,
                                            device=mu_a.device)
                            for e in noise)
        z_a = mu_a + torch.exp(0.5 * logvar_a) * eps_a
        z_b = mu_b + torch.exp(0.5 * logvar_b) * eps_b
        sa, sb = torch.exp(logvar_a), torch.exp(logvar_b)
        bi_kld = (_kl_normal(mu_a, sa, mu_b, sb).mean()
                  + _kl_normal(mu_b, sb, mu_a, sa).mean())
        pa, pb = torch.sigmoid(z_a), torch.sigmoid(z_b)
        return (_bce_sum(pa, pb.detach()) + _bce_sum(pb, pa.detach())
                - bi_kld)
