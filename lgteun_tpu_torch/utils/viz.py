"""PNG previews (reference dataset/utils.py:97-152; counterpart of
`lgteun_tpu/utils/viz.py`, without PIL, which the card's host lacks).

- `linear_stretch`: the reference's per-band cumulative-histogram stretch
  to [0, 255] (its numba kernel, dataset/utils.py:97-129): min_val the
  smallest intensity whose CDF over [0, 5000) reaches 20 %, max_val 98 %,
  then a clipped linear scale.
- `save_preview_png`: the reference's `save_pang` preview, bands (2, 1, 0)
  of a 4- or 8-band image as RGB (dataset/utils.py:132-152), written as
  an 8-bit PNG with `zlib` and `struct` (filter 0 on every row); the
  pixels are `np.asarray(img, np.uint8)` of the image, as the JAX
  module's `Image.fromarray` takes them.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["linear_stretch", "save_preview_png", "encode_png"]


def linear_stretch(data_chw: np.ndarray, lo_prob: float = 0.2,
                   hi_prob: float = 0.98,
                   max_value: int = 5000) -> np.ndarray:
    """Per-band cumulative-histogram stretch of [C, H, W] integer-valued
    data to [0, 255] floats (module docstring)."""
    data = np.asarray(data_chw)
    out = np.zeros(data.shape, np.float64)
    for b in range(data.shape[0]):
        band = data[b].astype(np.int64)
        hist = np.bincount(band.ravel(), minlength=max_value)[:max_value]
        cdf = np.cumsum(hist) / band.size
        min_val = int(np.searchsorted(cdf, lo_prob) + 1)
        max_val = int(np.searchsorted(cdf, hi_prob) + 1)
        scaled = (data[b] - min_val) / max(max_val - min_val, 1) * 255.0
        scaled = np.where(data[b] > max_val, 255.0, scaled)
        scaled = np.where(data[b] < min_val, 0.0, scaled)
        out[b] = scaled
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """An 8-bit PNG of uint8 [H, W] (gray) or [H, W, 3] (RGB) pixels."""
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError(f"PNG pixels are uint8 [H, W] or [H, W, 3], not "
                         f"{pixels.dtype} {list(pixels.shape)}")
    h, w = pixels.shape[:2]
    color = 2 if pixels.ndim == 3 else 0
    rows = np.ascontiguousarray(pixels).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_preview_png(img_chw: np.ndarray, path: str,
                     stretch: bool = False) -> str:
    """Write a PNG preview of [C, H, W] (or [H, W]) `img_chw` in the
    reference's band order: bands (2, 1, 0) of a 4- or 8-band image as
    RGB, one band as gray, three as they are (module docstring); with
    `stretch`, `linear_stretch` first. Returns `path`."""
    img = np.asarray(img_chw)
    if img.ndim == 2:
        img = img[None]
    if stretch:
        img = linear_stretch(img)
    if img.shape[0] in (4, 8):
        img = img[(2, 1, 0), :, :].transpose(1, 2, 0)
    elif img.shape[0] == 1:
        img = img[0]
    else:
        img = img.transpose(1, 2, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img, np.uint8)))
    return path
