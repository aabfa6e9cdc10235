"""Host-side float64 IQA oracle of the port: a copy of
`lgteun_tpu/metrics/numpy_ref.py` (numpy and scipy only), which
re-implements, formula-for-formula, the pan-sharpening quality metrics
of the reference suite (reference: models/base/metrics.py) without its
cv2/torch dependencies. These run on the CPU in float64 and are the ground
truth the port's batched torch metrics (torch_metrics.py) are tested
against, on the CPU and on the card.

Conventions shared with the reference:
- images are HWC (or HW) numpy arrays, float, normalised to [0, 1]
  before denormalisation, metric math done on the [0, 2047.5]-scaled
  data via ``dynamic_range`` = 2047.5 (11-bit; reference metrics.py:19)
- windowed statistics use cv2.filter2D semantics: correlation with
  BORDER_REFLECT_101 (== scipy 'mirror') and center anchor, with a
  "valid" crop afterwards
- D_s degrades PAN with a satellite MTF filter, hard-coded QuickBird
  (reference metrics.py:241-242,298)

Metric inventory and reference lines:
  psnr       metrics.py:39-48      ssim      metrics.py:129-163
  qindex     metrics.py:77-126     sam       metrics.py:22-35
  ergas      metrics.py:166-182    scc       metrics.py:58-74
  d_lambda   metrics.py:271-295    d_s       metrics.py:298-333
  qnr        metrics.py:400-406
  ref_evaluate    metrics.py:409-417
  no_ref_evaluate metrics.py:420-425
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage

DYNAMIC_RANGE = 2047.5  # 11-bit sensor data (reference metrics.py:19)

_EPS = np.finfo(np.float64).eps

__all__ = [
    "DYNAMIC_RANGE",
    "psnr", "ssim", "qindex", "sam", "ergas", "scc",
    "d_lambda", "d_s", "qnr",
    "ref_evaluate", "no_ref_evaluate",
    "mtf_kernel", "mtf_degrade_pan",
]


# ---------------------------------------------------------------------------
# full-reference metrics
# ---------------------------------------------------------------------------

def psnr(pred: np.ndarray, gt: np.ndarray, dynamic_range: float = DYNAMIC_RANGE) -> float:
    """Peak SNR over the full dynamic range (reference metrics.py:39-48)."""
    if pred.shape != gt.shape:
        raise ValueError("shape mismatch")
    diff = pred.astype(np.float64) - gt.astype(np.float64)
    mse = np.mean(diff * diff)
    if mse <= 1e-10:
        return float("inf")
    return float(20.0 * np.log10(dynamic_range / (np.sqrt(mse) + _EPS)))


def sam(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean spectral angle in radians (reference metrics.py:22-35)."""
    if pred.shape != gt.shape:
        raise ValueError("shape mismatch")
    a = pred.astype(np.float64)
    b = gt.astype(np.float64)
    dot = (a * b).sum(axis=2)
    na = np.sqrt((a * a).sum(axis=2))
    nb = np.sqrt((b * b).sum(axis=2))
    cos = np.clip(dot / (na * nb + _EPS), 0.0, 1.0)
    return float(np.mean(np.arccos(cos)))


def ergas(pred: np.ndarray, gt: np.ndarray, scale: int = 4) -> float:
    """Relative global dimensionless synthesis error
    (reference metrics.py:166-182)."""
    if pred.shape != gt.shape:
        raise ValueError("shape mismatch")
    a = pred.astype(np.float64)
    b = gt.astype(np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    means = b.reshape(-1, b.shape[2]).mean(axis=0)
    mses = ((a - b) ** 2).reshape(-1, a.shape[2]).mean(axis=0)
    return float(100.0 / scale * np.sqrt((mses / (means**2 + _EPS)).mean()))


def scc(pred: np.ndarray, gt: np.ndarray) -> float:
    """Per-band Pearson correlation, averaged (reference metrics.py:58-74;
    the reference's 2-D branch has a typo and always raises — we
    implement the intended behavior)."""
    a = pred.astype(np.float64)
    b = gt.astype(np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    ccs = [
        np.corrcoef(a[..., i].ravel(), b[..., i].ravel())[0, 1]
        for i in range(a.shape[2])
    ]
    return float(np.mean(ccs))


def _filter_valid(img: np.ndarray, window: np.ndarray,
                  crop_before: int, crop_after: int) -> np.ndarray:
    """cv2.filter2D (reflect-101 correlation) followed by the reference's
    asymmetric valid crop ``[c0:-c1, c0:-c1]``."""
    out = ndimage.correlate(img, window, mode="mirror")
    return out[crop_before:-crop_after, crop_before:-crop_after]


def _uqi_single(a: np.ndarray, b: np.ndarray, block_size: int) -> float:
    """Universal quality index of one band pair, box window
    (reference metrics.py:77-113 `_qindex`)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    window = np.ones((block_size, block_size)) / float(block_size**2)
    c0 = block_size // 2
    c1 = block_size - 1 - c0
    mu1 = _filter_valid(a, window, c0, c1)
    mu2 = _filter_valid(b, window, c0, c1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter_valid(a * a, window, c0, c1) - mu1_sq
    s2 = _filter_valid(b * b, window, c0, c1) - mu2_sq
    s12 = _filter_valid(a * b, window, c0, c1) - mu1_mu2

    qmap = np.ones_like(s12)
    var_sum = s1 + s2
    mu_sum = mu1_sq + mu2_sq
    m = (var_sum < 1e-8) & (mu_sum > 1e-8)
    qmap[m] = 2 * mu1_mu2[m] / mu_sum[m]
    m = (var_sum > 1e-8) & (mu_sum < 1e-8)
    qmap[m] = 2 * s12[m] / var_sum[m]
    m = (var_sum > 1e-8) & (mu_sum > 1e-8)
    qmap[m] = (4 * mu1_mu2[m] * s12[m]) / (mu_sum[m] * var_sum[m])
    return float(qmap.mean())


def qindex(pred: np.ndarray, gt: np.ndarray, block_size: int = 8) -> float:
    """Q-index, per band then averaged (reference metrics.py:116-126)."""
    if pred.shape != gt.shape:
        raise ValueError("shape mismatch")
    if pred.ndim == 2:
        return _uqi_single(pred, gt, block_size)
    return float(np.mean([
        _uqi_single(pred[..., i], gt[..., i], block_size)
        for i in range(pred.shape[2])
    ]))


@functools.lru_cache(maxsize=None)
def _ssim_window() -> np.ndarray:
    """11x11 Gaussian, sigma 1.5 (reference metrics.py:136-137)."""
    x = np.arange(11, dtype=np.float64) - 5.0
    k = np.exp(-(x * x) / (2.0 * 1.5 * 1.5))
    k /= k.sum()
    return np.outer(k, k)


def _ssim_single(a: np.ndarray, b: np.ndarray, dynamic_range: float) -> float:
    c1 = (0.01 * dynamic_range) ** 2
    c2 = (0.03 * dynamic_range) ** 2
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    w = _ssim_window()
    mu1 = _filter_valid(a, w, 5, 5)
    mu2 = _filter_valid(b, w, 5, 5)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter_valid(a * a, w, 5, 5) - mu1_sq
    s2 = _filter_valid(b * b, w, 5, 5) - mu2_sq
    s12 = _filter_valid(a * b, w, 5, 5) - mu1_mu2
    num = (2 * mu1_mu2 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return float((num / den).mean())


def ssim(pred: np.ndarray, gt: np.ndarray,
         dynamic_range: float = DYNAMIC_RANGE) -> float:
    """Valid-cropped Gaussian SSIM (reference metrics.py:129-163)."""
    if pred.shape != gt.shape:
        raise ValueError("shape mismatch")
    if pred.ndim == 2:
        return _ssim_single(pred, gt, dynamic_range)
    return float(np.mean([
        _ssim_single(pred[..., i], gt[..., i], dynamic_range)
        for i in range(pred.shape[2])
    ]))


# ---------------------------------------------------------------------------
# MTF machinery for the no-reference metrics
# ---------------------------------------------------------------------------

_SAT_GNYQ = {
    # reference metrics.py:241-246
    "QuickBird": ([0.34, 0.32, 0.30, 0.22], 0.15),
    "IKONOS": ([0.26, 0.28, 0.29, 0.28], 0.17),
}


@functools.lru_cache(maxsize=None)
def mtf_kernel(gnyq: float, scale: int = 4, n: int = 41) -> np.ndarray:
    """Windowed-FIR MTF lowpass for one Nyquist gain
    (reference metrics.py:190-235 gaussian2d/kaiser2d/fir_filter_wind/
    GNyq2win)."""
    fcut = 1.0 / scale
    alpha = np.sqrt(((n - 1) * (fcut / 2.0)) ** 2 / (-2.0 * np.log(gnyq)))
    return mtf_kernel_from_alpha(float(alpha), n)


@functools.lru_cache(maxsize=None)
def mtf_kernel_from_alpha(alpha: float, n: int = 41) -> np.ndarray:
    """The Gaussian-response + radial-Kaiser + window-method FIR design
    for a precomputed Gaussian std `alpha`. Split out of `mtf_kernel`
    because the Wald downgrade path (data/synthetic.py) must reproduce
    the reference's *float32* alpha arithmetic for the QB/IKONOS/
    GeoEye1 gain tables (reference model_based_utils.py:206)."""
    t = np.arange(-(n - 1) // 2, (n + 2) // 2, dtype=np.float64)
    t1, t2 = np.meshgrid(t, t)
    h = np.exp(-0.5 * (t1 / alpha) ** 2) * np.exp(-0.5 * (t2 / alpha) ** 2)
    hd = h / h.max()
    # radial Kaiser window, beta 0.5
    tk = t / float(n - 1)
    t1k, t2k = np.meshgrid(tk, tk)
    radius = np.sqrt(t1k * t1k + t2k * t2k)
    w1 = np.kaiser(n, 0.5)
    w = np.interp(radius, tk, w1)
    w[radius > tk[-1]] = 0
    w[radius < tk[0]] = 0
    # window-method FIR design
    hd_r = np.rot90(np.fft.fftshift(np.rot90(hd, 2)), 2)
    fir = np.rot90(np.fft.fftshift(np.fft.ifft2(hd_r)), 2)
    fir = fir * w
    fir = fir / fir.sum()
    return np.real(fir)


def mtf_degrade_pan(pan_hw: np.ndarray, satellite: str = "QuickBird",
                    scale: int = 4) -> np.ndarray:
    """MTF-lowpass + nearest decimation of a 2-D PAN image
    (reference metrics.py:238-263 `mtf_resize`, 2-D branch)."""
    _, gnyq_pan = _SAT_GNYQ[satellite]
    img = pan_hw.astype(np.float64)
    lowpass = mtf_kernel(gnyq_pan, scale, 41)
    img = ndimage.correlate(img, lowpass, mode="nearest")
    h, w = img.shape
    # cv2.resize INTER_NEAREST: out[i] = in[floor(i * in/out)]
    oh, ow = h // scale, w // scale
    ri = (np.arange(oh) * (h / oh)).astype(np.int64)
    ci = (np.arange(ow) * (w / ow)).astype(np.int64)
    return img[np.ix_(ri, ci)]


# ---------------------------------------------------------------------------
# no-reference metrics
# ---------------------------------------------------------------------------

def d_lambda(pred: np.ndarray, lrms: np.ndarray,
             block_size: int = 32, p: int = 1) -> float:
    """Spectral distortion: inter-band Q-index deltas
    (reference metrics.py:271-295)."""
    assert pred.ndim == lrms.ndim == 3
    c = pred.shape[2]
    deltas = []
    for i in range(c):
        for j in range(i + 1, c):
            qf = _uqi_single(pred[..., i], pred[..., j], block_size)
            ql = _uqi_single(lrms[..., i], lrms[..., j], block_size)
            deltas.append(abs(qf - ql) ** p)
    return float(np.mean(deltas) ** (1.0 / p))


def d_s(pred: np.ndarray, lrms: np.ndarray, pan: np.ndarray,
        satellite: str = "QuickBird", scale: int = 4,
        block_size: int = 32, q: int = 1) -> float:
    """Spatial distortion: per-band Q(band, PAN) at high and low res
    (reference metrics.py:298-333)."""
    assert pred.ndim == lrms.ndim == 3 and pan.ndim == 3 and pan.shape[2] == 1
    pan_lr = mtf_degrade_pan(pan[..., 0], satellite, scale)
    c = pred.shape[2]
    deltas = []
    for i in range(c):
        qh = _uqi_single(pred[..., i], pan[..., 0], block_size)
        ql = _uqi_single(lrms[..., i], pan_lr, block_size)
        deltas.append(abs(qh - ql) ** q)
    return float(np.mean(deltas) ** (1.0 / q))


def qnr(pred: np.ndarray, lrms: np.ndarray, pan: np.ndarray,
        satellite: str = "QuickBird", scale: int = 4, block_size: int = 32,
        p: int = 1, q: int = 1, alpha: float = 1.0, beta: float = 1.0) -> float:
    """(1 - D_lambda)^alpha (1 - D_s)^beta (reference metrics.py:400-406)."""
    dl = d_lambda(pred, lrms, block_size, p)
    ds = d_s(pred, lrms, pan, satellite, scale, block_size, q)
    return float((1.0 - dl) ** alpha * (1.0 - ds) ** beta)


# ---------------------------------------------------------------------------
# evaluation bundles (the runner's per-image entry points)
# ---------------------------------------------------------------------------

def ref_evaluate(pred: np.ndarray, gt: np.ndarray) -> list[float]:
    """[PSNR, SSIM, Q, SAM, ERGAS] (reference metrics.py:409-417)."""
    return [psnr(pred, gt), ssim(pred, gt), qindex(pred, gt),
            sam(pred, gt), ergas(pred, gt)]


def no_ref_evaluate(pred: np.ndarray, pan_hw: np.ndarray,
                    lrms: np.ndarray) -> list[float]:
    """[D_lambda, D_s, QNR] (reference metrics.py:420-425); ``pan_hw``
    is 2-D as in the reference call convention."""
    pan3 = pan_hw[..., None]
    return [d_lambda(pred, lrms), d_s(pred, lrms, pan3),
            qnr(pred, lrms, pan3)]
