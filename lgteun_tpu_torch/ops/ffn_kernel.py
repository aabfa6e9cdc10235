"""LGB block tail (mixer proj + residual, then LN + FFN + residual) and
the LN + FFN + residual alone.

Counterparts of `lgteun_tpu/ops/ffn_kernel.py::fused_block_tail_cm`
(with and without its dropout `mask`) and `fused_ln_ffn_cm` /
`fused_ln_ffn` (Pallas), and of `block_tail_xla` and `ln_ffn_xla` (their
plain versions), on [B, C, H, W]:

    ln_ffn:             out = x + W3 . GELU(DW3x3(W2 . GELU(W1 . LN(x)
                                                  + b1) + b2) + bdw) + b3
    block_tail:         out = ln_ffn(x + proj([x1; x2]))
    block_tail_masked:  out = ln_ffn(x + mask * proj([x1; x2]))

with exact-erf GELU, LN eps 1e-5 and zero padding of the depthwise conv's
input; `mask` [B, C, H, W] holds 0 or 1/keep (the training dropout after
the mixer proj).

The three launch `csrc/block_tail.cu` (one kernel; the proj prologue and
the mask are template flags) for a CUDA tensor, differentiable there
(`ops.autograd.recompute`; the mask gets no gradient), and run
`block_tail_ref` / `ln_ffn_ref` for a CPU tensor. `ffn` holds the
FeedForward's weights in torch conv layout: ln_w/ln_b [C], w1 [4C, C],
b1 [4C], w2 [4C, 4C], b2 [4C], dw [4C, 3, 3], bdw [4C], w3 [C, 4C],
b3 [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["block_tail", "block_tail_ref", "block_tail_masked",
           "block_tail_masked_ref", "ln_ffn", "ln_ffn_ref", "FFN_KEYS"]

# the order in which `ffn`'s tensors pass through `recompute`
FFN_KEYS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "dw", "bdw", "w3", "b3")


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
                   eps: float = 1e-5, mask=None):
    """Plain version. proj_w [C, C] (out, in), proj_b [C]; mask
    [B, C, H, W] or None."""
    mixed = _pw(torch.cat([x1, x2], dim=1), proj_w, proj_b)
    if mask is not None:
        mixed = mixed * mask
    return ln_ffn_ref(x + mixed, ffn, eps)


def block_tail_masked_ref(x, x1, x2, mask, proj_w, proj_b, ffn: dict,
                          eps: float = 1e-5):
    """Plain version of `block_tail_masked`."""
    return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps, mask)


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


def _split(t):
    """`_tail`'s positional tensors -> ((x, x1, x2, proj_w, proj_b), ffn,
    mask or None)."""
    n = 5 + len(FFN_KEYS)
    return t[:5], dict(zip(FFN_KEYS, t[5:n])), (t[n] if len(t) > n else None)


def _tail(name, wrapper, tensors, eps):
    """The differentiable launch of the block tail; `tensors` are x, x1,
    x2, proj_w, proj_b, the FFN's weights in FFN_KEYS order and, for the
    masked variant, the mask (which gets no gradient)."""
    def kernel(*t):
        (x, x1, x2, proj_w, proj_b), ffn, mask = _split(t)
        b, c, h, w = x.shape
        c4 = ffn["w1"].shape[0]
        got = dict(ffn, x1=x1, x2=x2, proj_w=proj_w, proj_b=proj_b)
        want = dict(_ffn_shapes(c, c4), x1=(b, c // 2, h, w),
                    x2=(b, c // 2, h, w), proj_w=(c, c), proj_b=(c,))
        if mask is not None:
            got["mask"], want["mask"] = mask, (b, c, h, w)
        check_tail_args(name, x, got, want)
        out = torch.empty_like(x)
        _cuda.launch("lgteun_block_tail", x.device, x, x1, x2, mask,
                     _in_out(proj_w), proj_b, *tail_weights(ffn), out, b, c,
                     c4, h, w, eps)
        wrapper.launches += 1
        return out

    def plain(*t):
        (x, x1, x2, proj_w, proj_b), ffn, mask = _split(t)
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps, mask)

    return recompute(kernel, plain, *tensors)


def block_tail(x, x1, x2, proj_w, proj_b, ffn: dict, eps: float = 1e-5):
    """Block tail on [B, C, H, W] (x) and [B, C/2, H, W] (x1, x2)."""
    if _cuda.plain_on_cpu("block_tail", x):
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps)
    return _tail("block_tail", block_tail, (
        x, x1, x2, proj_w, proj_b, *(ffn[k] for k in FFN_KEYS)), eps)


block_tail.launches = 0


def block_tail_masked(x, x1, x2, mask, proj_w, proj_b, ffn: dict,
                      eps: float = 1e-5):
    """Block tail whose proj output is multiplied by `mask`
    [B, C, H, W] before the residual add (training dropout)."""
    if _cuda.plain_on_cpu("block_tail_masked", x):
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps, mask)
    return _tail("block_tail_masked", block_tail_masked, (
        x, x1, x2, proj_w, proj_b, *(ffn[k] for k in FFN_KEYS), mask), eps)


block_tail_masked.launches = 0


def ln_ffn(x, ffn: dict, eps: float = 1e-5):
    """x + FFN(LN(x)) on [B, C, H, W] (same contract as `ln_ffn_ref`)."""
    if _cuda.plain_on_cpu("ln_ffn", x):
        return ln_ffn_ref(x, ffn, eps)

    def kernel(x, *ffn_t):
        ffn = dict(zip(FFN_KEYS, ffn_t))
        b, c, h, w = x.shape
        c4 = ffn["w1"].shape[0]
        check_tail_args("ln_ffn", x, ffn, _ffn_shapes(c, c4))
        out = torch.empty_like(x)
        _cuda.launch("lgteun_ln_ffn", x.device, x, *tail_weights(ffn), out,
                     b, c, c4, h, w, eps)
        ln_ffn.launches += 1
        return out

    return recompute(kernel, lambda x, *t: ln_ffn_ref(
        x, dict(zip(FFN_KEYS, t)), eps), x, *(ffn[k] for k in FFN_KEYS))


ln_ffn.launches = 0
