"""Wald-protocol synthetic dataset generator (a copy of
`lgteun_tpu/data/synthetic.py`, numpy and scipy only, with the MTF
filter design of the port's `metrics/numpy_ref.py::
mtf_kernel_from_alpha`): a seed gives the same TIFF triples as the JAX
package's generator.

1. render a full-resolution multispectral scene HrMS [H, W, C] (smooth
   random fields plus band tints and shared detail, 11-bit)
2. PAN = band mean of HrMS plus mild detail
3. LrMS = sensor simulation, decimated x4 (reference
   model_based_utils.py:144-234 `downgrade_images`): `sensor=None` the
   default 9x9 Gaussian (wrap border, decimated from offset 0), a sensor
   name of SENSOR_GNYQ the per-band 41-tap MTF FIR (`nearest` border,
   decimated from ratio // 2), the recipe of the real training pairs
4. write `{id}_lr.tif`, `{id}_pan.tif`, `{id}_mul.tif` as uint16 TIFFs

`downgrade_images` is the whole of the JAX package's function, PAN
included; its sensor branch resizes PAN with Pillow's float-mode bicubic,
which `pil_resize_bicubic` reproduces in numpy (the port does not
depend on PIL). The scene generator degrades only the MS, as the JAX one keeps
only the LrMS.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage, signal

from lgteun_tpu_torch.data.tiff import write_tiff
from lgteun_tpu_torch.metrics.numpy_ref import mtf_kernel_from_alpha

__all__ = ["downgrade_images", "pil_resize_bicubic", "make_synthetic_scene",
           "make_synthetic_dataset", "SENSOR_GNYQ"]

# Per-sensor MTF gains at Nyquist (band array, PAN), reference
# model_based_utils.py:157-181; dtypes as the reference builds them.
SENSOR_GNYQ = {
    "QB": (np.asarray([0.34, 0.32, 0.30, 0.22], dtype="float32"), 0.15),
    "IKONOS": (np.asarray([0.26, 0.28, 0.29, 0.28], dtype="float32"), 0.17),
    "GeoEye1": (np.asarray([0.23, 0.23, 0.23, 0.23], dtype="float32"), 0.16),
    "WV2": (np.asarray([0.35] * 7 + [0.27]), 0.11),
    "WV3": (0.29 * np.ones(8), 0.15),
}


def _mtf_fir(gnyq, ratio: int, n: int = 41) -> np.ndarray:
    """41-tap MTF lowpass for one Nyquist gain, alpha computed with
    `downgrade_images`' own arithmetic (float64 fcut against the gain
    table's dtype, reference model_based_utils.py:153, 206)."""
    fcut = 1 / np.double(ratio)
    alpha = np.sqrt(((n - 1) * (fcut / 2)) ** 2 / (-2 * np.log(gnyq)))
    return mtf_kernel_from_alpha(float(alpha), n)


def _default_gaussian_kernel(ratio: int) -> np.ndarray:
    """9x9 separable Gaussian of the default branch (reference
    model_based_utils.py:184-186)."""
    sig = (1.0 / (2.0 * 2.772587 / ratio**2)) ** 0.5
    x = np.arange(9) - 4.0
    g = np.exp(-(x * x) / (2 * sig * sig))
    g /= g.sum()
    return np.outer(g, g)


def _degrade_ms(ms: np.ndarray, ratio: int, sensor: str | None):
    """LrMS [h, w, C] float64 of the reference's `downgrade_images`."""
    ms = np.double(ms)
    if sensor is None:
        kernel = _default_gaussian_kernel(ratio)
        return np.stack([
            signal.convolve2d(ms[..., b], kernel, mode="same",
                              boundary="wrap")[::ratio, ::ratio]
            for b in range(ms.shape[-1])], axis=-1)
    if sensor not in SENSOR_GNYQ:
        raise KeyError(f"unknown sensor {sensor!r}; known: "
                       f"{sorted(SENSOR_GNYQ)} (or None for the default "
                       f"Gaussian branch)")
    gnyq = SENSOR_GNYQ[sensor][0]
    if len(gnyq) < ms.shape[-1]:
        raise ValueError(f"sensor {sensor} has {len(gnyq)} bands; "
                         f"MS has {ms.shape[-1]}")
    start = ratio // 2
    ms_lp = np.stack([ndimage.correlate(ms[..., b], _mtf_fir(gnyq[b], ratio),
                                        mode="nearest")
                      for b in range(ms.shape[-1])], axis=-1)
    return ms_lp[start:-1:ratio, start:-1:ratio]


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5) on |x|, support 2."""
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_taps(in_size: int, out_size: int):
    """(first input index [out], normalised weights [out, k]) of Pillow's
    `precompute_coeffs` for one axis: output pixel i centred at
    (i + 0.5) * scale, the filter widened by scale when it shrinks,
    xmin / xmax rounded and clipped to the input, weights divided by
    their sum; the taps past xmax are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    k = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(k)
    w = _bicubic((taps[None] + xmin[:, None] - center[:, None] + 0.5)
                 / filterscale)
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    return xmin, w


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's float-mode resample along `axis` of a float32
    image: each output a float64 sum of its taps in order, stored as
    float32."""
    in_size = img.shape[axis]
    xmin, w = _resample_taps(in_size, out_size)
    src = np.moveaxis(img, axis, -1).astype(np.float64)
    acc = np.zeros(src.shape[:-1] + (out_size,))
    for t in range(w.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)   # weight 0 past xmax
        acc += src[..., idx] * w[:, t]
    return np.moveaxis(acc.astype(np.float32), -1, axis)


def pil_resize_bicubic(img: np.ndarray, scale: float) -> np.ndarray:
    """`scipy.misc.imresize(img, scale, "bicubic", mode="F")`, i.e.
    Pillow's `Image.fromarray(img.astype(float32), "F").resize((int(scale
    * w), int(scale * h)), BICUBIC)` (the JAX package's
    `_pil_imresize_bicubic`), in numpy: a horizontal pass, then a
    vertical one, each with Pillow's taps (`_resample_taps`) and a
    float32 result; float64 out."""
    h, w = img.shape
    oh, ow = int(h * scale), int(w * scale)
    out = np.asarray(img, np.float32)
    if ow != w:
        out = _resample_axis(out, ow, 1)
    if oh != h:
        out = _resample_axis(out, oh, 0)
    return out.astype(np.float64)


def downgrade_images(ms: np.ndarray, pan: np.ndarray, ratio: int = 4,
                     sensor: str | None = None, pan_mtf: bool = False):
    """Wald-protocol degradation of an (MS [H, W, C], PAN [H, W] or
    [H, W, 1]) pair (reference model_based_utils.py:144-234; the JAX
    package's `downgrade_images`): `sensor=None` the 9x9 Gaussian (wrap)
    on both, decimated from offset 0; a sensor of SENSOR_GNYQ the
    per-band MTF FIR on MS (`nearest`, decimated from ratio // 2 with the
    reference's `:-1` stop) and PAN symmetric-padded by 2 * ratio,
    bicubic-resized by 1 / ratio (`pil_resize_bicubic`) and cropped by 2,
    or with `pan_mtf` PAN's own MTF FIR as MS's. -> (ms_lr [h, w, C],
    pan_lr [h, w, 1]) float64."""
    ms_lr = _degrade_ms(ms, ratio, sensor)
    pan = np.double(np.squeeze(pan))
    if sensor is None:
        pan_lr = signal.convolve2d(pan, _default_gaussian_kernel(ratio),
                                   mode="same",
                                   boundary="wrap")[::ratio, ::ratio]
    elif pan_mtf:
        start = ratio // 2
        pan_lr = ndimage.correlate(pan, _mtf_fir(SENSOR_GNYQ[sensor][1],
                                                 ratio),
                                   mode="nearest")[start:-1:ratio,
                                                   start:-1:ratio]
    else:
        pan_pad = np.pad(pan, 2 * ratio, "symmetric")
        pan_lr = pil_resize_bicubic(pan_pad, 1.0 / ratio)[2:-2, 2:-2]
    return ms_lr, pan_lr[..., None]


def _smooth_field(rng: np.random.Generator, h: int, w: int,
                  sigma: float) -> np.ndarray:
    x = rng.standard_normal((h, w))
    x = ndimage.gaussian_filter(x, sigma, mode="wrap")
    x -= x.min()
    x /= max(x.max(), 1e-9)
    return x


def make_synthetic_scene(rng: np.random.Generator, size: int = 128,
                         bands: int = 4, ratio: int = 4,
                         sensor: str | None = None):
    """(lrms [s/r, s/r, C], pan [s, s], hrms [s, s, C]) uint16."""
    base = _smooth_field(rng, size, size, sigma=8.0)
    detail = _smooth_field(rng, size, size, sigma=1.5)
    hrms = np.zeros((size, size, bands))
    for b in range(bands):
        band_tint = _smooth_field(rng, size, size, sigma=16.0)
        hrms[..., b] = 0.55 * base + 0.3 * band_tint + 0.15 * detail
    hrms = np.clip(hrms, 0, 1) * 1800.0 + 100.0  # inside the 11-bit range
    pan = hrms.mean(axis=-1) * 0.9 + 0.1 * detail * 1800.0
    lr = _degrade_ms(hrms, ratio, sensor)
    to_u16 = lambda a: np.clip(np.round(a), 0, 2047).astype(np.uint16)
    return to_u16(lr), to_u16(pan), to_u16(hrms)


def make_synthetic_dataset(root: str, n_train: int = 8, n_test: int = 4,
                           bands: int = 4, size: int = 128,
                           seed: int = 19971118,
                           sensor: str | None = None) -> dict:
    """Write train/ and test/ splits of synthetic TIFF triples
    ({id}_lr/_pan/_mul.tif); returns {'train': dir, 'test': dir}."""
    rng = np.random.default_rng(seed)
    dirs = {}
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            lr, pan, hr = make_synthetic_scene(rng, size, bands,
                                               sensor=sensor)
            write_tiff(os.path.join(d, f"{split}{i:03d}_lr.tif"), lr)
            write_tiff(os.path.join(d, f"{split}{i:03d}_pan.tif"), pan)
            write_tiff(os.path.join(d, f"{split}{i:03d}_mul.tif"), hr)
        dirs[split] = d
    return dirs
