"""Window multi-head self-attention, in three memory layouts.

Counterparts of `lgteun_tpu/ops/window_attention.py` (Pallas) and of
`window_attention_xla` (their plain version): per non-overlapping
win x win window of S = win^2 tokens, a 1x1 qkv projection with bias,
per-head (q * hd^-0.5) . k^T + pos[head], a max-subtracted softmax,
attn . v, and the head merge. The entries differ only in how the
windows lie in memory:

    window_attention          y [B, C, H, W] images    (B2, the packed v3)
    window_attention_windows  xt [N, C, S] windows     (B6, the v2 kernel)
    window_attention_rows     xw [N, S, C] ([N*S, C] rows; B7, the first
                              kernel, on no model path in either package)

Each launches `csrc/window_attention.cu` (one block per window, read and
written in place in its layout: no partition copy, no window-pair
packing) for a CUDA tensor and runs its `*_ref` for a CPU tensor.
`window_attention` and `window_attention_windows` are differentiable on
the card (`ops.autograd.recompute`: the kernel forward, the plain
version's backward). The weights keep torch's layout: wqkv [3C, C] (out,
in, the to_qkv conv weight), bqkv [3C], pos [heads, S, S].
"""

from __future__ import annotations

import torch

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.autograd import recompute

__all__ = ["window_attention", "window_attention_ref",
           "window_attention_windows", "window_attention_windows_ref",
           "window_attention_rows", "window_attention_rows_ref",
           "window_partition", "window_unpartition"]


def window_partition(y, win: int):
    """[B, C, H, W] -> [N, C, S] windows, N = B * (H/win) * (W/win) in
    (image, window row, window column) order."""
    b, c, h, w = y.shape
    return (y.reshape(b, c, h // win, win, w // win, win)
            .permute(0, 2, 4, 1, 3, 5).reshape(-1, c, win * win))


def window_unpartition(xt, win: int, h: int, w: int):
    """The inverse of `window_partition`: [N, C, S] -> [B, C, H, W]."""
    n, c, _ = xt.shape
    b = n // ((h // win) * (w // win))
    return (xt.reshape(b, h // win, w // win, c, win, win)
            .permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w))


def window_attention_rows_ref(xw, wqkv, bqkv, pos, heads: int):
    """Plain version on [N, S, C] windows -> [N, S, C]."""
    n, s, c = xw.shape
    hd = c // heads
    qkv = torch.einsum("nsc,dc->nsd", xw, wqkv) + bqkv
    q, k, v = (t.reshape(n, s, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    sim = torch.einsum("nhid,nhjd->nhij", q * hd ** -0.5, k) + pos[None]
    out = torch.einsum("nhij,nhjd->nhid", torch.softmax(sim, dim=-1), v)
    return out.transpose(1, 2).reshape(n, s, c)


def window_attention_windows_ref(xt, wqkv, bqkv, pos, heads: int):
    """Plain version on [N, C, S] windows -> [N, C, S]."""
    return window_attention_rows_ref(xt.transpose(1, 2), wqkv, bqkv, pos,
                                     heads).transpose(1, 2)


def window_attention_ref(y, wqkv, bqkv, pos, heads: int, win: int):
    """Plain version on [B, C, H, W] -> [B, C, H, W]."""
    h, w = y.shape[-2:]
    return window_unpartition(window_attention_windows_ref(
        window_partition(y, win), wqkv, bqkv, pos, heads), win, h, w)


def _check(name, x, c, heads, win, wqkv, bqkv, pos):
    s = win * win
    if c % heads or s > 64:
        raise ValueError(f"{name}: need C divisible by {heads} and win <= 8, "
                         f"got {tuple(x.shape)}")
    if (wqkv.shape != (3 * c, c) or bqkv.shape != (3 * c,)
            or pos.shape != (heads, s, s)):
        raise ValueError(f"{name}: parameter shapes do not match")
    _cuda.check_cuda_f32(name, x.device, x=x, wqkv=wqkv, bqkv=bqkv, pos=pos)


def window_attention(y, wqkv, bqkv, pos, heads: int, win: int):
    """Window MHSA on [B, C, H, W] -> [B, C, H, W] (same contract as
    `window_attention_ref`)."""
    if _cuda.plain_on_cpu("window_attention", y):
        return window_attention_ref(y, wqkv, bqkv, pos, heads, win)
    b, c, h, w = y.shape
    if h % win or w % win:
        raise ValueError(f"window_attention: need H, W divisible by {win}, "
                         f"got {tuple(y.shape)}")

    def kernel(y, wqkv, bqkv, pos):
        _check("window_attention", y, c, heads, win, wqkv, bqkv, pos)
        out = torch.empty_like(y)
        _cuda.launch("lgteun_window_attention", y.device, y, wqkv, bqkv, pos,
                     out, b, c, h, w, heads, win, (c // heads) ** -0.5)
        window_attention.launches += 1
        return out

    return recompute(kernel, lambda *t: window_attention_ref(*t, heads, win),
                     y, wqkv, bqkv, pos)


window_attention.launches = 0


def _launch_windows(entry, name, x, wqkv, bqkv, pos, heads, channel_dim):
    """Launch `entry` on the windows of x ([N, C, S] or [N, S, C])."""
    n, c, s = x.shape[0], x.shape[channel_dim], x.shape[3 - channel_dim]
    win = int(round(s ** 0.5))
    if win * win != s:
        raise ValueError(f"{name}: S must be a square, got {tuple(x.shape)}")
    _check(name, x, c, heads, win, wqkv, bqkv, pos)
    out = torch.empty_like(x)
    _cuda.launch(entry, x.device, x, wqkv, bqkv, pos, out, n, c, heads, win,
                 (c // heads) ** -0.5)
    return out


def window_attention_windows(xt, wqkv, bqkv, pos, heads: int):
    """Window MHSA on [N, C, S] windows -> [N, C, S] (S = win^2 <= 64)."""
    if _cuda.plain_on_cpu("window_attention_windows", xt):
        return window_attention_windows_ref(xt, wqkv, bqkv, pos, heads)

    def kernel(xt, wqkv, bqkv, pos):
        out = _launch_windows("lgteun_window_attention_windows",
                              "window_attention_windows", xt, wqkv, bqkv,
                              pos, heads, 1)
        window_attention_windows.launches += 1
        return out

    return recompute(kernel,
                     lambda *t: window_attention_windows_ref(*t, heads),
                     xt, wqkv, bqkv, pos)


window_attention_windows.launches = 0


def window_attention_rows(xw, wqkv, bqkv, pos, heads: int):
    """Window MHSA on [N, S, C] windows -> [N, S, C] (S = win^2 <= 64).
    On no model path: forward only, as its JAX counterpart."""
    if _cuda.plain_on_cpu("window_attention_rows", xw):
        return window_attention_rows_ref(xw, wqkv, bqkv, pos, heads)
    out = _launch_windows("lgteun_window_attention_rows",
                          "window_attention_rows", xw, wqkv, bqkv, pos,
                          heads, 2)
    window_attention_rows.launches += 1
    return out


window_attention_rows.launches = 0
