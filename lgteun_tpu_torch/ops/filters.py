"""2-D filtering with OpenCV semantics on [B, C, H, W] tensors
(counterpart of `lgteun_tpu/ops/filters.py`).

- `gaussian_kernel_1d`: `cv2.getGaussianKernel(ksize, sigma)` (float64;
  the SSIM window, reference metrics.py:136);
- `depthwise_conv2d`: the same [kh, kw] kernel correlated with every
  channel (what cv2.filter2D computes per channel), `F.conv2d` with
  `groups=C`;
- `filter2d_reflect101`: cv2.filter2D with its default border
  (BORDER_REFLECT_101 == torch's "reflect", the edge not repeated) and
  its centre anchor, which pads an even kernel unevenly: the metrics'
  8x8 box pads (4, 3);
- `pyr_down`: `cv2.pyrDown`, the 5x5 [1, 4, 6, 4, 1] / 16 blur under
  BORDER_REFLECT_101, then the even rows and columns (reference
  ps_dataset.py:57);
- `box_filter`: a size x size mean under cv2.filter2D's border (the
  Q-index window, reference metrics.py:82);
- `get_lp` / `get_hp`: a k x k mean with zero padding that divides by
  k * k at the borders too (`F.avg_pool2d(k, 1, k // 2)`), and x less it
  (reference models/base/utils.py:70-95);
- `channel_pooling`: the mean or max over the channels, one channel out
  (reference models/base/utils.py:141-156);
- `calc_img_grad`: the mean of the absolute row and column forward
  differences, one row and column fewer (reference models/base/
  utils.py:159-168).

torch's reflect pad needs each pad to be smaller than its dimension (one
reflection, as numpy's "reflect" never needs more on these sizes): the
largest window here, D_lambda's 32x32 box on a 32x32 LrMS, pads (16, 15).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel_1d", "depthwise_conv2d", "filter2d_reflect101",
           "pyr_down", "box_filter", "get_lp", "get_hp", "channel_pooling",
           "calc_img_grad"]


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """`cv2.getGaussianKernel(ksize, sigma)` (float64); sigma <= 0 is
    cv2's 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def depthwise_conv2d(x: torch.Tensor, kernel, stride: int = 1
                     ) -> torch.Tensor:
    """Valid correlation of [B, C, H, W] `x` with one [kh, kw] kernel
    (numpy array or tensor) shared across channels."""
    c = x.shape[1]
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    weight = k.expand(c, 1, *k.shape).contiguous()
    return F.conv2d(x, weight, stride=stride, groups=c)


def filter2d_reflect101(x: torch.Tensor, kernel) -> torch.Tensor:
    """`cv2.filter2D(x, -1, kernel)` with the default border on
    [B, C, H, W]; output the size of `x`. The anchor is the kernel's
    centre (kh // 2, kw // 2), cv2's anchor (-1, -1)."""
    kh, kw = np.shape(kernel)
    pads = (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2)
    xp = F.pad(x, pads, mode="reflect")
    return depthwise_conv2d(xp, kernel)


_PYR = np.outer(*[np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0] * 2)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """`cv2.pyrDown` of [B, C, H, W]: [B, C, ceil(H / 2), ceil(W / 2)]."""
    y = depthwise_conv2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), _PYR)
    return y[..., ::2, ::2]


def box_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """A size x size mean with cv2.filter2D's border; the size of x."""
    return filter2d_reflect101(x, np.ones((size, size)) / (size * size))


def get_lp(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """The low-frequency part: a ksize x ksize mean over zero padding,
    divided by ksize^2 everywhere."""
    kernel = np.full((ksize, ksize), 1.0 / (ksize * ksize))
    p = ksize // 2
    return depthwise_conv2d(F.pad(x, (p, p, p, p)), kernel)


def get_hp(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """The high-frequency part, x - get_lp(x)."""
    return x - get_lp(x, ksize)


def channel_pooling(x: torch.Tensor, mode: str = "avg") -> torch.Tensor:
    """The channels' mean ("avg") or max ("max"): [B, 1, H, W]."""
    if mode == "avg":
        return x.mean(dim=1, keepdim=True)
    if mode == "max":
        return x.amax(dim=1, keepdim=True)
    raise ValueError(f"no such pooling mode {mode!r}")


def calc_img_grad(x: torch.Tensor) -> torch.Tensor:
    """(|row difference| + |column difference|) / 2 of [B, C, H, W]:
    [B, C, H - 1, W - 1]."""
    d_row = (x[..., :-1, :-1] - x[..., 1:, :-1]).abs()
    d_col = (x[..., :-1, :-1] - x[..., :-1, 1:]).abs()
    return (d_row + d_col) / 2.0
