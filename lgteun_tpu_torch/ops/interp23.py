"""23-tap CDF interpolation upsampling, the classical methods' resampler
(counterpart of `lgteun_tpu/ops/interp23.py`; reference
models/common/model_based_utils.py:36-68 `upsample_interp23`).

Per octave the samples are zero-interleaved (odd phase on the first
octave, even afterwards) and filtered by a separable symmetric 23-tap
half-band filter with a wrap (circular) border. Per axis that is one
dense [n * ratio, n] matrix, built in float64 with numpy (a copy of the
JAX package's construction), so the upsample is two matrix products, as in
the JAX package: FP32 products in float32, which the caller keeps off
TF32 (the Runner turns TF32 off for the process).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interp23_matrix", "interp23_upsample"]

# Half of the symmetric 23-tap filter (centre first), doubled: gain 2 per
# octave makes up for the zero-interleave.
_CDF23_HALF = 2.0 * np.array([
    0.5, 0.305334091185, 0.0, -0.072698593239, 0.0, 0.021809577942,
    0.0, -0.005192756653, 0.0, 0.000807762146, 0.0, -0.000060081482,
])


@functools.lru_cache(maxsize=None)
def _cdf23_kernel() -> np.ndarray:
    half = _CDF23_HALF
    return np.concatenate([half[:0:-1], half])  # 23 taps, symmetric


@functools.lru_cache(maxsize=None)
def interp23_matrix(n_in: int, ratio: int) -> np.ndarray:
    """[n_in * ratio, n_in] float64 matrix of the per-axis interp23
    upsample for a power-of-two `ratio`."""
    if ratio < 1 or ratio & (ratio - 1):
        raise ValueError(f"ratio {ratio} is not a power of two")
    kernel = _cdf23_kernel()
    k_half = len(kernel) // 2
    m_total = np.eye(n_in)
    n = n_in
    first = True
    while n < n_in * ratio:
        n2 = n * 2
        up = np.zeros((n2, n))
        up[(1 if first else 0)::2, :] = np.eye(n)
        first = False
        conv = np.zeros((n2, n2))
        for tap in range(len(kernel)):
            idx = (np.arange(n2) + tap - k_half) % n2
            conv[np.arange(n2), idx] += kernel[tap]
        m_total = conv @ up @ m_total
        n = n2
    return m_total


def interp23_upsample(x: torch.Tensor, ratio: int = 4,
                      rows: slice | None = None) -> torch.Tensor:
    """interp23 upsample of NHWC [..., h, w, C] by `ratio` (a power of
    two) -> [..., h * ratio, w * ratio, C], in the dtype of `x`; with
    `rows` only those output rows (the rows of the H matrix; a rank's
    strip of a height-sharded forward, `parallel/spatial.py`)."""
    h, w = x.shape[-3], x.shape[-2]
    mh, mw = (torch.as_tensor(interp23_matrix(n, ratio), dtype=x.dtype,
                              device=x.device) for n in (h, w))
    if rows is not None:
        mh = mh[rows]
    y = mh @ x.movedim(-1, -3) @ mw.T
    return y.movedim(-3, -1)
