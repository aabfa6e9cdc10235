"""Training losses of the port (counterpart of `lgteun_tpu/losses.py`):
the mean L1/L2 reconstruction loss, the zero-weight skipping of the
reference's `get_loss_module` (reference losses.py:222-249), the
no-reference QNR loss (`qnr_loss`, reference losses.py:141-153),
MutInf's mutual-information regulariser (`MutualInfoReg`, reference
losses.py:162-219) and the adversarial losses (`gan_d_loss`,
`gan_g_loss`): the reference steps its discriminator inside the loss
forward (reference losses.py:68-137); here, as in the JAX package, that
is two losses that the Runner's two-optimiser step takes in turn
(`runner.py::Runner._adversarial_step`). Under a data-parallel step's
generator (`parallel.mesh.ShardGenerator`) each loss is the global
batch's value (`parallel.mesh.batch_mean` / `batch_sum` / `batch_rows`)
and its draws are the rank's rows of the global draw."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.metrics.torch_metrics import (d_lambda_global,
                                                    d_s_global)
from lgteun_tpu_torch.ops.resize import resize_bicubic
from lgteun_tpu_torch.parallel import mesh

__all__ = ["reconstruction_loss", "build_loss_weights", "qnr_loss",
           "MutualInfoReg", "gan_d_loss", "gan_g_loss"]


def reconstruction_loss(out: torch.Tensor, gt: torch.Tensor,
                        loss_type: str = "l1") -> torch.Tensor:
    """mean |out - gt| ("l1") or mean (out - gt)^2 ("l2")."""
    if loss_type == "l1":
        return (out - gt).abs().mean()
    if loss_type == "l2":
        return ((out - gt) ** 2).mean()
    raise ValueError(f"unknown reconstruction loss {loss_type!r}")


def qnr_loss(pan: torch.Tensor, ms: torch.Tensor, out: torch.Tensor,
             pan_l: torch.Tensor | None = None,
             generator=None) -> torch.Tensor:
    """1 - (1 - D_lambda)(1 - D_s) of NHWC batches, differentiable
    (`lgteun_tpu/losses.py:48-57`). Without `pan_l`, PAN is resized
    bicubic x1/4 with align_corners=True, the reference's `down_sample`
    (reference losses.py:152), not the dataset's degraded PAN. D_lambda
    and D_s are |differences| of batch means of per-image Q, no sum over
    the images: under a data-parallel step's generator they are taken on
    the global batch's per-image values (`parallel.mesh.batch_rows`)."""
    if pan_l is None:
        h, w = pan.shape[1:3]
        pan_l = resize_bicubic(pan.permute(0, 3, 1, 2), (h // 4, w // 4),
                               align_corners=True).permute(0, 2, 3, 1)
    dl = d_lambda_global(ms, out, generator)
    ds = d_s_global(ms, pan, pan_l, out, generator)
    return 1.0 - (1.0 - dl) * (1.0 - ds)


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
    parity test, as the JAX module's `noise=`. Under a data-parallel
    step's generator (`parallel.mesh`) eps is the rank's rows of the
    global batch's draw, and the value is the global batch's: the BCE
    sums summed over the ranks, the KL means their global means."""

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
            eps_a, eps_b = (mesh.draw(torch.randn, mu.shape, generator,
                                      mu.device)
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
        bce = _bce_sum(pa, pb.detach()) + _bce_sum(pb, pa.detach())
        return (mesh.batch_sum(bce, generator)
                - mesh.batch_mean(bi_kld, generator))


# ---------------------------------------------------------------------------
# adversarial losses (the two-optimiser form of reference losses.py:43-138)
# ---------------------------------------------------------------------------

def _bce_flipped(logits: torch.Tensor, target: float,
                 generator=None) -> torch.Tensor:
    """mean BCE of sigmoid(logits), clipped to [1e-7, 1 - 1e-7], against
    a constant target (the global batch's mean under a data-parallel
    step's generator)."""
    p = torch.sigmoid(logits).clamp(1e-7, 1 - 1e-7)
    return mesh.batch_mean(-(target * torch.log(p) + (1 - target)
                             * torch.log(1 - p)).mean(), generator)


def gan_d_loss(d_apply, fake: torch.Tensor, real: torch.Tensor,
               gan_type: str = "GAN", eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               gp_w: float = 10.0) -> torch.Tensor:
    """The discriminator's loss on detached `fake` and `real`
    (`lgteun_tpu/losses.py:147-175`); `d_apply(x)` gives the logits of
    NCHW images. "GAN" keeps the reference's inverted labels (real scored
    against 0, fake against 1, the sum negated; reference
    losses.py:86-91). "WGAN-GP" adds gp_w x the mean of (|grad| - 1)^2 at
    eps x real + (1 - eps) x fake, eps [B, 1, 1, 1] uniform (drawn from
    `generator` unless given), the gradient made with create_graph so
    that the penalty trains the discriminator. Under a data-parallel
    step's generator (`parallel.mesh`) every mean is the global batch's
    and eps the rank's rows of the global draw."""
    fake, real = fake.detach(), real.detach()
    d_fake, d_real = d_apply(fake), d_apply(real)
    mean = lambda t: mesh.batch_mean(t.mean(), generator)
    if gan_type == "GAN":
        return -(_bce_flipped(d_real, 0.0, generator)
                 + _bce_flipped(d_fake, 1.0, generator))
    if gan_type == "LSGAN":
        return (mean((d_real - 1.0) ** 2) + mean(d_fake ** 2)) / 2.0
    if gan_type == "WGAN-GP":
        if eps is None:
            eps = mesh.draw(torch.rand, (real.shape[0], 1, 1, 1), generator,
                            real.device)
        hat = (fake * (1 - eps) + real * eps).requires_grad_()
        grads, = torch.autograd.grad(d_apply(hat).sum(), hat,
                                     create_graph=True)
        gnorm = torch.sqrt((grads.flatten(1) ** 2).sum(dim=1) + 1e-12)
        return mean(d_fake - d_real) + gp_w * mean((gnorm - 1.0) ** 2)
    raise ValueError(f"unknown gan type {gan_type!r}")


def gan_g_loss(d_apply, fake: torch.Tensor, gan_type: str = "GAN",
               generator: torch.Generator | None = None) -> torch.Tensor:
    """The generator's adversarial term (reference losses.py:129-137);
    `d_apply` must hold the discriminator's weights fixed (the caller
    gives detached ones), so that only the generator gets a gradient.
    `generator`: the step's, whose shard (`parallel.mesh`) makes the mean
    the global batch's."""
    d_fake = d_apply(fake)
    if gan_type == "GAN":
        return _bce_flipped(d_fake, 1.0, generator)
    if gan_type == "LSGAN":
        return mesh.batch_mean(((d_fake - 1.0) ** 2).mean(), generator)
    if gan_type == "WGAN-GP":
        return -mesh.batch_mean(d_fake.mean(), generator)
    raise ValueError(f"unknown gan type {gan_type!r}")
