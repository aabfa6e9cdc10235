"""LGB block tail (mixer proj + residual, then LN + FFN + residual) and
the LN + FFN + residual alone.

Counterparts of `lgteun_tpu/ops/ffn_kernel.py::fused_block_tail_cm` and
`fused_ln_ffn_cm` / `fused_ln_ffn` (Pallas), and of `block_tail_xla` and
`ln_ffn_xla` (their plain versions), on [B, C, H, W]:

    ln_ffn:      out = x + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(x) + b1) + b2)
                                     + bdw) + b3
    block_tail:  out = ln_ffn(x + proj([x1; x2]))

with exact-erf GELU, LN eps 1e-5 and zero padding of the depthwise conv's
input.

`block_tail` and `ln_ffn` launch `csrc/block_tail.cu` (one kernel, the
proj prologue a template flag) for a CUDA tensor and run `block_tail_ref`
/ `ln_ffn_ref` for a CPU tensor. `ffn` holds the FeedForward's weights in
torch conv layout: ln_w/ln_b [C], w1 [4C, C], b1 [4C], w2 [4C, 4C],
b2 [4C], dw [4C, 3, 3], bdw [4C], w3 [C, 4C], b3 [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["block_tail", "block_tail_ref", "ln_ffn", "ln_ffn_ref"]


def _pw(t, wt, bias):
    return F.conv2d(t, wt[:, :, None, None], bias)


def ln_ffn_ref(x, ffn: dict, eps: float = 1e-5):
    """Plain version of x + FFN(LN(x))."""
    y = channel_layer_norm(x, ffn["ln_w"], ffn["ln_b"], eps)
    h = F.gelu(_pw(y, ffn["w1"], ffn["b1"]), approximate="none")
    h = _pw(h, ffn["w2"], ffn["b2"])
    h = F.conv2d(h, ffn["dw"][:, None], ffn["bdw"], padding=1,
                 groups=h.shape[1])
    h = F.gelu(h, approximate="none")
    return x + _pw(h, ffn["w3"], ffn["b3"])


def block_tail_ref(x, x1, x2, proj_w, proj_b, ffn: dict,
                   eps: float = 1e-5):
    """Plain version. proj_w [C, C] (out, in), proj_b [C]."""
    return ln_ffn_ref(x + _pw(torch.cat([x1, x2], dim=1), proj_w, proj_b),
                      ffn, eps)


def _in_out(wt: torch.Tensor) -> torch.Tensor:
    """`wt.t().contiguous()`, made once per weight version. The kernel
    reads weights as [in, out] so that a warp's output channels are one
    coalesced row."""
    return _cuda.weight_layout("in_out", (wt,), lambda: wt.t().contiguous())


def _ffn_shapes(c: int, c4: int) -> dict:
    return {"ln_w": (c,), "ln_b": (c,), "w1": (c4, c), "b1": (c4,),
            "w2": (c4, c4), "b2": (c4,), "dw": (c4, 3, 3), "bdw": (c4,),
            "w3": (c, c4), "b3": (c,)}


def check_tail_args(name: str, x, got: dict, want: dict) -> None:
    """Raise unless x [B, C, H, W] and the tensors of `got` suit the tail
    kernel: shapes as in `want`, C % 4 == 0, a 4C hidden width, H and W
    divisible by 8, contiguous float32 on x's CUDA device."""
    b, c, h, w = x.shape
    c4 = got["w1"].shape[0]
    bad = [k for k, shp in want.items() if tuple(got[k].shape) != shp]
    if bad or c % 4 or c4 != 4 * c or h % 8 or w % 8:
        raise ValueError(f"{name}: need C % 4 == 0, 4C hidden and H, W "
                         f"divisible by 8 (x {tuple(x.shape)}); bad: {bad}")
    _cuda.check_cuda_f32(name, x.device, x=x, **got)


def tail_weights(ffn: dict) -> tuple:
    """The FFN's weights in the kernel's argument order and layout."""
    return (ffn["ln_w"], ffn["ln_b"], _in_out(ffn["w1"]), ffn["b1"],
            _in_out(ffn["w2"]), ffn["b2"], ffn["dw"], ffn["bdw"],
            _in_out(ffn["w3"]), ffn["b3"])


def block_tail(x, x1, x2, proj_w, proj_b, ffn: dict, eps: float = 1e-5):
    """Block tail on [B, C, H, W] (x) and [B, C/2, H, W] (x1, x2)."""
    if x.device.type == "cpu":
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps)
    if x.device.type != "cuda":
        raise ValueError(f"block_tail: unsupported device {x.device}")
    b, c, h, w = x.shape
    c4 = ffn["w1"].shape[0]
    want = dict(_ffn_shapes(c, c4), x1=(b, c // 2, h, w),
                x2=(b, c // 2, h, w), proj_w=(c, c), proj_b=(c,))
    check_tail_args("block_tail", x,
                    dict(ffn, x1=x1, x2=x2, proj_w=proj_w, proj_b=proj_b),
                    want)
    out = torch.empty_like(x)
    _cuda.launch("lgteun_block_tail", x.device, x, x1, x2, _in_out(proj_w),
                 proj_b, *tail_weights(ffn), out, b, c, c4, h, w, eps)
    block_tail.launches += 1
    return out


block_tail.launches = 0


def ln_ffn(x, ffn: dict, eps: float = 1e-5):
    """x + FFN(LN(x)) on [B, C, H, W] (same contract as `ln_ffn_ref`)."""
    if x.device.type == "cpu":
        return ln_ffn_ref(x, ffn, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_ffn: unsupported device {x.device}")
    b, c, h, w = x.shape
    c4 = ffn["w1"].shape[0]
    check_tail_args("ln_ffn", x, dict(ffn), _ffn_shapes(c, c4))
    out = torch.empty_like(x)
    _cuda.launch("lgteun_ln_ffn", x.device, x, *tail_weights(ffn), out, b, c,
                 c4, h, w, eps)
    ln_ffn.launches += 1
    return out


ln_ffn.launches = 0
