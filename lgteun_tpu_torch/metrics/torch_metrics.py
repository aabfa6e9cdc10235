"""Batched IQA metrics on tensors (counterpart of
`lgteun_tpu/metrics/jax_metrics.py`): a whole eval batch is scored in a
few launches on the batch's device, and every function returns
per-image values [B] (means and stds are taken on the host).

Inputs keep the JAX functions' NHWC layout, [B, H, W, C], since the
Runner hands over NHWC predictions; only the windowed statistics run on
NCHW, as one grouped convolution over the five stacked maps (a, b, a*a,
b*b, a*b) with cv2.filter2D's reflect-101 border (`ops/filters.py`) and
the reference's valid crop. D_lambda stacks all C(C-1)/2 band pairs
into the channel axis; D_s degrades the PAN with the 41x41 MTF filter
(edge padding, nearest decimation) on the device.

The differentiable whole-image family (`qindex_global`,
`d_lambda_global`, `d_s_global`; reference metrics.py:336-397, eps 1e-8)
is plain autograd, for the QNR loss; a data-parallel step's generator
makes its batch means the global batch's (`parallel.mesh.batch_rows`).

Numerics: float32, as on the TPU. cuDNN runs float32 convolutions in
TF32 by default, which moves SSIM and Q by about 1e-3: a caller outside
the Runner (which turns TF32 off for the process) must turn it off
too. At DN scale the windowed variances E[a^2] - mu^2 cancel in
float32 (as in JAX); the float64 oracle is `numpy_ref.py`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from lgteun_tpu_torch.metrics.numpy_ref import (_SAT_GNYQ, DYNAMIC_RANGE,
                                                mtf_kernel)
from lgteun_tpu_torch.ops.filters import (depthwise_conv2d,
                                          filter2d_reflect101,
                                          gaussian_kernel_1d)
from lgteun_tpu_torch.parallel.mesh import batch_rows

__all__ = [
    "psnr_batch", "ssim_batch", "qindex_batch", "sam_batch", "ergas_batch",
    "d_lambda_batch", "d_s_batch",
    "ref_evaluate_batch", "no_ref_evaluate_batch",
    "qindex_global", "d_lambda_global", "d_s_global",
]

_EPS64 = float(np.finfo(np.float64).eps)


# ---------------------------------------------------------------------------
# full-reference, batched
# ---------------------------------------------------------------------------

def psnr_batch(pred: torch.Tensor, gt: torch.Tensor,
               dynamic_range: float = DYNAMIC_RANGE) -> torch.Tensor:
    """[B, H, W, C] -> [B] dB; zero mse clamps to 1e-10 (no inf)."""
    mse = ((pred - gt) ** 2).mean(dim=(1, 2, 3)).clamp_min(1e-10)
    return 20.0 * torch.log10(dynamic_range / (torch.sqrt(mse) + _EPS64))


def sam_batch(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean spectral angle (radians) -> [B]: the reference's
    arccos(clip(a.b / (|a| |b| + eps), 0, 1)) per pixel, computed as
    2 atan2(|u - v|, |u + v|) of the unit vectors u, v, clipped to pi/2
    (pi/2 where a pixel is zero). Both are the angle in exact arithmetic;
    in float32 the arccos of a cosine near 1 is not: at 5 mrad, a good
    fusion's angle, one ulp of the cosine moves the angle by 0.6 %, and
    another summation order (cuDNN, XLA) moves the mean SAM by ~1e-3."""
    na = torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
    nb = torch.linalg.vector_norm(gt, dim=-1, keepdim=True)
    nonzero = (na * nb > 0)[..., 0]
    u = pred / torch.where(na > 0, na, 1.0)
    v = gt / torch.where(nb > 0, nb, 1.0)
    angle = 2.0 * torch.atan2(torch.linalg.vector_norm(u - v, dim=-1),
                              torch.linalg.vector_norm(u + v, dim=-1))
    angle = torch.where(nonzero, angle.clamp_max(math.pi / 2), math.pi / 2)
    return angle.mean(dim=(1, 2))


def ergas_batch(pred: torch.Tensor, gt: torch.Tensor,
                scale: int = 4) -> torch.Tensor:
    means = gt.mean(dim=(1, 2))
    mses = ((pred - gt) ** 2).mean(dim=(1, 2))
    return 100.0 / scale * torch.sqrt((mses / (means ** 2 + _EPS64)).mean(
        dim=-1))


def _windowed_stats(a: torch.Tensor, b: torch.Tensor, window: np.ndarray,
                    c0: int, c1: int):
    """NHWC pairs -> (mu1, mu2, s1, s2, s12), each [B, C, h, w]: the
    reflect-101 correlation of a, b, a*a, b*b, a*b with `window`, cropped
    [c0:-c1] (the reference's valid crop), in one grouped conv."""
    stacked = torch.cat([a, b, a * a, b * b, a * b], dim=-1)
    filtered = filter2d_reflect101(stacked.permute(0, 3, 1, 2), window)
    mu1, mu2, e11, e22, e12 = filtered[:, :, c0:-c1, c0:-c1].chunk(5, dim=1)
    return (mu1, mu2, e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2)


def _uqi_map(mu1, mu2, s1, s2, s12) -> torch.Tensor:
    """Piecewise universal-quality-index map (reference metrics.py:101-112)."""
    mu12 = mu1 * mu2
    mu_sum = mu1 * mu1 + mu2 * mu2
    var_sum = s1 + s2
    qmap = torch.ones_like(s12)
    qmap = torch.where((var_sum < 1e-8) & (mu_sum > 1e-8),
                       2 * mu12 / mu_sum, qmap)
    qmap = torch.where((var_sum > 1e-8) & (mu_sum < 1e-8),
                       2 * s12 / var_sum, qmap)
    return torch.where((var_sum > 1e-8) & (mu_sum > 1e-8),
                       (4 * mu12 * s12) / (mu_sum * var_sum), qmap)


def qindex_pairs(a: torch.Tensor, b: torch.Tensor,
                 block_size: int = 8) -> torch.Tensor:
    """Per-channel Q-index of paired NHWC stacks -> [B, C]."""
    window = np.ones((block_size, block_size), np.float64) / block_size ** 2
    c0 = block_size // 2
    stats = _windowed_stats(a, b, window, c0, block_size - 1 - c0)
    return _uqi_map(*stats).mean(dim=(2, 3))


def qindex_batch(pred: torch.Tensor, gt: torch.Tensor,
                 block_size: int = 8) -> torch.Tensor:
    """[B, H, W, C] -> [B] (mean over bands; reference metrics.py:116-126)."""
    return qindex_pairs(pred, gt, block_size).mean(dim=-1)


@functools.lru_cache(maxsize=None)
def _ssim_window_np() -> np.ndarray:
    """11x11 Gaussian, sigma 1.5 (reference metrics.py:136-137)."""
    k = gaussian_kernel_1d(11, 1.5)
    return np.outer(k, k)


def ssim_batch(pred: torch.Tensor, gt: torch.Tensor,
               dynamic_range: float = DYNAMIC_RANGE) -> torch.Tensor:
    """[B, H, W, C] -> [B] Gaussian SSIM, valid crop [5:-5]
    (reference metrics.py:129-163)."""
    c1 = (0.01 * dynamic_range) ** 2
    c2 = (0.03 * dynamic_range) ** 2
    mu1, mu2, s1, s2, s12 = _windowed_stats(pred, gt, _ssim_window_np(), 5, 5)
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return (num / den).mean(dim=(1, 2, 3))


def ref_evaluate_batch(pred: torch.Tensor, gt: torch.Tensor,
                       dynamic_range: float = DYNAMIC_RANGE) -> dict:
    """Batched [PSNR, SSIM, Q, SAM, ERGAS] on the denormalised
    [0, dynamic_range] domain (reference base_model.py:311-334)."""
    return {
        "psnr": psnr_batch(pred, gt, dynamic_range),
        "ssim": ssim_batch(pred, gt, dynamic_range),
        "qindex": qindex_batch(pred, gt),
        "sam": sam_batch(pred, gt),
        "ergas": ergas_batch(pred, gt),
    }


# ---------------------------------------------------------------------------
# no-reference, batched
# ---------------------------------------------------------------------------

def _pair_indices(c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ii, jj = np.triu_indices(c, k=1)
    return (torch.from_numpy(ii).to(device), torch.from_numpy(jj).to(device))


def d_lambda_batch(pred: torch.Tensor, lrms: torch.Tensor,
                   block_size: int = 32, p: int = 1) -> torch.Tensor:
    """Spectral distortion [B] (reference metrics.py:271-295); all band
    pairs in one grouped conv per image size."""
    ii, jj = _pair_indices(pred.shape[-1], pred.device)
    q_f = qindex_pairs(pred[..., ii], pred[..., jj], block_size)
    q_l = qindex_pairs(lrms[..., ii], lrms[..., jj], block_size)
    return ((q_f - q_l).abs() ** p).mean(dim=-1) ** (1.0 / p)


def d_s_batch(pred: torch.Tensor, lrms: torch.Tensor, pan: torch.Tensor,
              satellite: str = "QuickBird", scale: int = 4,
              block_size: int = 32, q: int = 1) -> torch.Tensor:
    """Spatial distortion [B] (reference metrics.py:298-333); `pan` is
    [B, H, W, 1]. Its MTF lowpass (edge-replicate border == scipy's
    'nearest') and nearest decimation run on the device."""
    lowpass = mtf_kernel(_SAT_GNYQ[satellite][1], scale, 41)
    pan_nchw = pan.permute(0, 3, 1, 2)
    pan_lp = depthwise_conv2d(F.pad(pan_nchw, (20, 20, 20, 20),
                                    mode="replicate"), lowpass)
    pan_lr = pan_lp[:, :, ::scale, ::scale].permute(0, 2, 3, 1)
    c = pred.shape[-1]
    q_hr = qindex_pairs(pred, pan.expand(*pan.shape[:-1], c), block_size)
    q_lr = qindex_pairs(lrms, pan_lr.expand(*pan_lr.shape[:-1], c),
                        block_size)
    return ((q_hr - q_lr).abs() ** q).mean(dim=-1) ** (1.0 / q)


def no_ref_evaluate_batch(pred: torch.Tensor, lrms: torch.Tensor,
                          pan: torch.Tensor) -> dict:
    """Batched [D_lambda, D_s, QNR] (reference metrics.py:420-425)."""
    dl = d_lambda_batch(pred, lrms)
    ds = d_s_batch(pred, lrms, pan)
    return {"d_lambda": dl, "d_s": ds, "qnr": (1.0 - dl) * (1.0 - ds)}


# ---------------------------------------------------------------------------
# differentiable global-statistics variants (QNR loss support)
# ---------------------------------------------------------------------------

def qindex_global(a: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-8, generator=None) -> torch.Tensor:
    """Whole-image Q index of [B, H, W] pairs -> scalar (mean over the
    batch); `QIndex_torch` (reference metrics.py:336-355). Under a
    data-parallel step's generator (`parallel.mesh.batch_rows`) the mean
    is over the global batch's per-image values."""
    dims = (1, 2)
    ea, eb = a.mean(dim=dims), b.mean(dim=dims)
    ea2, eb2 = (a * a).mean(dim=dims), (b * b).mean(dim=dims)
    eab = (a * b).mean(dim=dims)
    var_a = ea2 - ea * ea
    var_b = eb2 - eb * eb
    cov = eab - ea * eb
    q = 4 * cov * ea * eb / ((var_a + var_b) * (ea ** 2 + eb ** 2) + eps)
    return batch_rows(q, generator).mean()


def d_lambda_global(lrms: torch.Tensor, pred: torch.Tensor,
                    generator=None) -> torch.Tensor:
    """Differentiable D_lambda over NHWC batches: `D_lambda_torch`'s
    double loop over ordered band pairs (reference metrics.py:358-376)."""
    c = pred.shape[-1]
    q = lambda a, b: qindex_global(a, b, generator=generator)
    total = 0.0
    for i in range(c):
        for j in range(c):
            if i != j:
                total = total + (q(pred[..., i], pred[..., j])
                                 - q(lrms[..., i], lrms[..., j])).abs()
    return total / c / (c - 1)


def d_s_global(lrms: torch.Tensor, pan: torch.Tensor, lpan: torch.Tensor,
               pred: torch.Tensor, generator=None) -> torch.Tensor:
    """Differentiable D_s, `D_s_torch` (reference metrics.py:379-397);
    NHWC inputs, `pan` and `lpan` with one channel."""
    c = pred.shape[-1]
    q = lambda a, b: qindex_global(a, b, generator=generator)
    total = 0.0
    for i in range(c):
        total = total + (q(pred[..., i], pan[..., 0])
                         - q(lrms[..., i], lpan[..., 0])).abs()
    return total / c
