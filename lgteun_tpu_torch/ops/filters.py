"""2-D filtering with OpenCV semantics on [B, C, H, W] tensors (the
counterparts of `lgteun_tpu/ops/filters.py::depthwise_conv2d` and
`filter2d_reflect101`, which the metrics and SFIM use).

- `depthwise_conv2d`: the same [kh, kw] kernel correlated with every
  channel (what cv2.filter2D computes per channel), `F.conv2d` with
  `groups=C`;
- `filter2d_reflect101`: cv2.filter2D with its default border
  (BORDER_REFLECT_101 == torch's "reflect", the edge not repeated) and
  its centre anchor, which pads an even kernel unevenly: the metrics'
  8x8 box pads (4, 3).

torch's reflect pad needs each pad to be smaller than its dimension (one
reflection, as numpy's "reflect" never needs more on these sizes): the
largest window here, D_lambda's 32x32 box on a 32x32 LrMS, pads (16, 15).

The rest of the JAX module (`pyr_down`, `box_filter`, `get_lp`/`get_hp`,
`channel_pooling`, `calc_img_grad`) has no caller in any JAX model and
is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["depthwise_conv2d", "filter2d_reflect101"]


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
