"""LGB block tail: mixer proj + residual, then LN + FFN + residual.

Counterpart of `lgteun_tpu/ops/ffn_kernel.py::fused_block_tail_cm`
(Pallas) and `block_tail_xla` (its plain version), on [B, C, H, W]:

    xm  = x + proj([x1; x2])
    out = xm + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(xm) + b1) + b2) + bdw) + b3

with exact-erf GELU and zero padding of the depthwise conv's input.

`block_tail` launches `csrc/block_tail.cu` for a CUDA tensor and runs
`block_tail_ref` for a CPU tensor. `ffn` holds the FeedForward's
weights in torch conv layout: ln_w/ln_b [C], w1 [4C, C], b1 [4C],
w2 [4C, 4C], b2 [4C], dw [4C, 3, 3], bdw [4C], w3 [C, 4C], b3 [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["block_tail", "block_tail_ref"]


def block_tail_ref(x, x1, x2, proj_w, proj_b, ffn: dict,
                   eps: float = 1e-5):
    """Plain version. proj_w [C, C] (out, in), proj_b [C]."""
    pw = lambda t, wt, bias: F.conv2d(t, wt[:, :, None, None], bias)
    xm = x + pw(torch.cat([x1, x2], dim=1), proj_w, proj_b)
    y = channel_layer_norm(xm, ffn["ln_w"], ffn["ln_b"], eps)
    h = F.gelu(pw(y, ffn["w1"], ffn["b1"]), approximate="none")
    h = pw(h, ffn["w2"], ffn["b2"])
    h = F.conv2d(h, ffn["dw"][:, None], ffn["bdw"], padding=1,
                 groups=h.shape[1])
    h = F.gelu(h, approximate="none")
    return xm + pw(h, ffn["w3"], ffn["b3"])


# [in, out] copies of the 1x1 weights, made once per weight version.
# Key: (data_ptr, shape, stride, device); value: (source, version, copy).
# The entry holds its source, so no other tensor can take that address
# while the entry lives; a changed `_version` (load_state_dict, an
# optimizer step) remakes the copy.
_IN_OUT: dict = {}
_IN_OUT_MAX = 64


def _in_out(wt: torch.Tensor) -> torch.Tensor:
    """`wt.t().contiguous()`, cached. The kernel reads weights as
    [in, out] so that a warp's output channels are one coalesced row."""
    key = (wt.data_ptr(), tuple(wt.shape), wt.stride(), wt.device)
    hit = _IN_OUT.get(key)
    if hit is None or hit[1] != wt._version:
        if hit is None and len(_IN_OUT) >= _IN_OUT_MAX:
            _IN_OUT.clear()
        hit = _IN_OUT[key] = (wt, wt._version, wt.t().contiguous())
    return hit[2]


def block_tail(x, x1, x2, proj_w, proj_b, ffn: dict, eps: float = 1e-5):
    """Block tail on [B, C, H, W] (x) and [B, C/2, H, W] (x1, x2)."""
    if x.device.type == "cpu":
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps)
    if x.device.type != "cuda":
        raise ValueError(f"block_tail: unsupported device {x.device}")
    b, c, h, w = x.shape
    c4 = ffn["w1"].shape[0]
    want = {"x1": (b, c // 2, h, w), "x2": (b, c // 2, h, w),
            "proj_w": (c, c), "proj_b": (c,), "ln_w": (c,), "ln_b": (c,),
            "w1": (c4, c), "b1": (c4,), "w2": (c4, c4), "b2": (c4,),
            "dw": (c4, 3, 3), "bdw": (c4,), "w3": (c, c4), "b3": (c,)}
    got = dict(ffn, x1=x1, x2=x2, proj_w=proj_w, proj_b=proj_b)
    bad = [k for k, shp in want.items() if tuple(got[k].shape) != shp]
    if bad or c % 4 or c4 != 4 * c or h % 8 or w % 8:
        raise ValueError(f"block_tail: need C % 4 == 0, 4C hidden and H, W "
                         f"divisible by 8 (x {tuple(x.shape)}); bad: {bad}")
    _cuda.check_cuda_f32("block_tail", x.device, x=x, **got)
    out = torch.empty_like(x)
    _cuda.launch("lgteun_block_tail", x.device, x, x1, x2, _in_out(proj_w),
                 proj_b, ffn["ln_w"], ffn["ln_b"], _in_out(ffn["w1"]),
                 ffn["b1"], _in_out(ffn["w2"]), ffn["b2"], ffn["dw"],
                 ffn["bdw"], _in_out(ffn["w3"]), ffn["b3"], out, b, c, c4, h,
                 w, eps)
    block_tail.launches += 1
    return out


block_tail.launches = 0
