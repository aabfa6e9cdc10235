"""8x8-window multi-head self-attention on [B, C, H, W].

Counterpart of `lgteun_tpu/ops/window_attention.py::
fused_window_attention_v3_packed` (Pallas) and `window_attention_xla`
(its plain version): per non-overlapping win x win window, a 1x1 qkv
projection with bias, per-head (q * hd^-0.5) . k^T + pos[head], a
max-subtracted softmax, attn . v, and the head merge.

`window_attention` launches `csrc/window_attention.cu` for a CUDA tensor
(one block per window, read and written in place in the image layout:
no partition copy, no window-pair packing) and runs
`window_attention_ref` for a CPU tensor.
"""

from __future__ import annotations

import torch

from lgteun_tpu_torch.ops import _cuda

__all__ = ["window_attention", "window_attention_ref"]


def window_attention_ref(y, wqkv, bqkv, pos, heads: int, win: int):
    """Plain version. y [B, C, H, W]; wqkv [3C, C] (out, in, the
    to_qkv conv weight); bqkv [3C]; pos [heads, win^2, win^2]."""
    b, c, h, w = y.shape
    s, hd = win * win, c // heads
    n = b * (h // win) * (w // win)
    xw = (y.reshape(b, c, h // win, win, w // win, win)
          .permute(0, 2, 4, 3, 5, 1).reshape(n, s, c))
    qkv = torch.einsum("nsc,dc->nsd", xw, wqkv) + bqkv
    q, k, v = (t.reshape(n, s, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    sim = torch.einsum("nhid,nhjd->nhij", q * hd ** -0.5, k) + pos[None]
    out = torch.einsum("nhij,nhjd->nhid", torch.softmax(sim, dim=-1), v)
    out = out.transpose(1, 2).reshape(b, h // win, w // win, win, win, c)
    return out.permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)


def window_attention(y, wqkv, bqkv, pos, heads: int, win: int):
    """Window MHSA on [B, C, H, W] -> [B, C, H, W] (same contract as
    `window_attention_ref`)."""
    if y.device.type == "cpu":
        return window_attention_ref(y, wqkv, bqkv, pos, heads, win)
    if y.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {y.device}")
    b, c, h, w = y.shape
    s = win * win
    if h % win or w % win or c % heads or s > 64:
        raise ValueError(f"window_attention: need H, W divisible by {win}, "
                         f"C by {heads} and win <= 8, got {tuple(y.shape)}")
    if (wqkv.shape != (3 * c, c) or bqkv.shape != (3 * c,)
            or pos.shape != (heads, s, s)):
        raise ValueError("window_attention: parameter shapes do not match")
    _cuda.check_cuda_f32("window_attention", y.device, y=y, wqkv=wqkv,
                         bqkv=bqkv, pos=pos)
    out = torch.empty_like(y)
    _cuda.launch("lgteun_window_attention", y.device, y, wqkv, bqkv, pos,
                 out, b, c, h, w, heads, win, (c // heads) ** -0.5)
    window_attention.launches += 1
    return out


window_attention.launches = 0
