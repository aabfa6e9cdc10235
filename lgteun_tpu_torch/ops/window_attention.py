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

Each launches `csrc/window_attention.cu` for a CUDA tensor and runs its
`*_ref` for a CPU tensor. The kernel reads and writes each window in
place in its layout (no partition copy, no window-pair packing). Where
`attention_branch` gives "tc" (8x8 windows, a head of at most 32
channels, C <= 64, heads x padded head <= 64: every UnlgFormer block)
it runs the tensor-core body (one warpgroup a window and head, every
product as wgmma TF32 with the 3xTF32 split), which takes wqkv as
`attention_fragments` (made once per weight version, one
`lgteun_attention_fragments` launch on the card); other shapes run the
FP32-core body ("fp32", the `*_fp32` entries) on the rows of wqkv. Each
wrapper counts its launches in `launches` and by branch in `variants`.
`window_attention` and `window_attention_windows` are differentiable on
the card (`ops.autograd.recompute`: the kernel forward, the plain
version's backward). The weights keep torch's layout: wqkv [3C, C] (out,
in, the to_qkv conv weight), bqkv [3C], pos [heads, S, S].

Storage (`ops.storage_dtype`): `window_attention` and
`window_attention_windows` take x as float32 or bfloat16 and give out in
x's dtype; a bfloat16 x is upcast as loaded, all math (the products'
3xTF32 split included) is float32, and out is rounded once to nearest
even as stored. The plain versions spell that out (`out_dtype`: the
result's dtype, default x's). The bfloat16 entries are for eval (no
backward); `window_attention_rows` (on no path) takes float32 only.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.ffn_kernel import bf16_operands, tf32_split

__all__ = ["window_attention", "window_attention_ref", "window_attention_mixed",
           "window_attention_windows", "window_attention_windows_ref",
           "window_attention_rows", "window_attention_rows_ref",
           "window_partition", "window_unpartition", "attention_branch",
           "attention_fragments", "attention_pad"]


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


def window_attention_rows_ref(xw, wqkv, bqkv, pos, heads: int,
                              out_dtype=None):
    """Plain version on [N, S, C] windows -> [N, S, C] of `out_dtype`
    (default xw's; module docstring)."""
    n, s, c = xw.shape
    hd = c // heads
    out_dtype = out_dtype or xw.dtype
    qkv = torch.einsum("nsc,dc->nsd", upcast(xw), wqkv) + bqkv
    q, k, v = (t.reshape(n, s, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    sim = torch.einsum("nhid,nhjd->nhij", q * hd ** -0.5, k) + pos[None]
    out = torch.einsum("nhij,nhjd->nhid", torch.softmax(sim, dim=-1), v)
    return out.transpose(1, 2).reshape(n, s, c).to(out_dtype)


def window_attention_windows_ref(xt, wqkv, bqkv, pos, heads: int,
                                 out_dtype=None):
    """Plain version on [N, C, S] windows -> [N, C, S]."""
    return window_attention_rows_ref(xt.transpose(1, 2), wqkv, bqkv, pos,
                                     heads, out_dtype).transpose(1, 2)


def window_attention_ref(y, wqkv, bqkv, pos, heads: int, win: int,
                         out_dtype=None):
    """Plain version on [B, C, H, W] -> [B, C, H, W]."""
    h, w = y.shape[-2:]
    return window_unpartition(window_attention_windows_ref(
        window_partition(y, win), wqkv, bqkv, pos, heads, out_dtype), win,
        h, w)


def window_attention_mixed(y, wqkv, bqkv, pos, heads: int, win: int,
                           dtype=torch.bfloat16):
    """JAX's `window_attention_xla(..., dtype=bf16)` (`lgteun_tpu/ops/
    window_attention.py:33-60`) on [B, C, H, W] float32 -> [B, C, H, W]
    of `dtype`: UnlgFormer's selective `mixed_precision` training. The
    windows, wqkv and bqkv rounded to `dtype`; qkv the product rounded to
    `dtype` plus the rounded bias (rounded again); q scaled in `dtype`;
    the logits a float32 product of the `dtype` q and k, plus pos in
    float32; the softmax float32, rounded to `dtype`; attn . v a float32
    product, rounded to `dtype`. Each product is float32 on rounded
    operands (`ffn_kernel.bf16_operands`), which is what JAX's bf16
    einsum computes (float32 products with `preferred_element_type`, or
    one rounding of them without). Plain torch: no kernel of either
    package computes this function (JAX's kernels are float32 only and
    its mixed training runs this XLA composition, `lgteun_tpu/models/
    common/lgt.py:113-118`), so this is not a plain version standing in
    for `window_attention`."""
    r = bf16_operands
    h, w = y.shape[-2:]
    xw = window_partition(y, win).transpose(1, 2)      # [N, S, C]
    n, s, c = xw.shape
    hd = c // heads
    qkv = torch.einsum("nsc,dc->nsd", r(xw, dtype), r(wqkv, dtype)).to(
        dtype) + bqkv.to(dtype)
    q, k, v = (t.reshape(n, s, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    sim = torch.einsum("nhid,nhjd->nhij", (q * hd ** -0.5).float(),
                       k.float()) + pos[None]
    attn = torch.softmax(sim, dim=-1).to(dtype)
    out = torch.einsum("nhij,nhjd->nhid", attn.float(), v.float()).to(dtype)
    out = out.transpose(1, 2).reshape(n, s, c).transpose(1, 2)
    return window_unpartition(out, win, h, w)


def attention_pad(v: int) -> int:
    """The tensor-core body's padded width of v channels: the least power
    of two >= max(v, 8)."""
    return max(8, 1 << (v - 1).bit_length())


def attention_branch(c: int, heads: int, win: int) -> str:
    """The body that runs C channels in `heads` heads of win x win
    windows: "tc" (the tensor cores: win 8, a padded head <= 32, padded C
    <= 64, heads x padded head <= 64) or "fp32" (every other shape)."""
    if win != 8 or c % heads:
        return "fp32"
    hdp, cp = attention_pad(c // heads), attention_pad(c)
    return "tc" if hdp <= 32 and cp <= 64 and heads * hdp <= 64 else "fp32"


def attention_fragments(wqkv: torch.Tensor, heads: int) -> torch.Tensor:
    """wqkv [3C, C] (out, in) as the tensor-core body's weights: per head,
    its q, k and v rows (hd of each) zero-padded to [HDP, CP], split into
    TF32 hi/lo parts, each part wgmma's K-major B operand without swizzle:
    [heads][q, k, v][hi, lo][HDP / 8 n-groups][CP / 4 k-quads][8][4],
    element (d, c) at n-group d // 8, k-quad c // 4, [d % 8][c % 4] (core
    matrices of 8 rows x 16 bytes; the next k-quad 128 bytes on, the next
    n-group 32 CP bytes). Flat float32. `lgteun_attention_fragments` makes
    the same bits on the card."""
    c = wqkv.shape[1]
    hd = c // heads
    hdp, cp = attention_pad(hd), attention_pad(c)
    w = wqkv.float().reshape(3, heads, hd, c)
    w = F.pad(w, (0, cp - c, 0, hdp - hd)).transpose(0, 1)
    hi, lo = tf32_split(w.contiguous())
    t = torch.stack([hi, lo], dim=2).view(heads, 3, 2, hdp // 8, 8, cp // 4,
                                          4)
    return t.permute(0, 1, 2, 3, 5, 4, 6).contiguous().view(-1)


def _wqkv_fragments(wqkv: torch.Tensor, heads: int) -> torch.Tensor:
    """`attention_fragments` of wqkv, made once per weight version: by
    `lgteun_attention_fragments` for a CUDA tensor (one launch)."""
    def make():
        if wqkv.device.type != "cuda":
            return attention_fragments(wqkv, heads)
        c = wqkv.shape[1]
        _cuda.check_cuda_f32("attention_fragments", wqkv.device, wqkv=wqkv)
        hdp, cp = attention_pad(c // heads), attention_pad(c)
        out = torch.empty(heads * 6 * hdp * cp, device=wqkv.device)
        _cuda.launch("lgteun_attention_fragments", wqkv.device, wqkv, c,
                     heads, hdp, cp, out)
        _wqkv_fragments.launches += 1
        return out

    return _cuda.weight_layout(f"attn/{heads}", (wqkv,), make)


_wqkv_fragments.launches = 0


def _launch(entry: str, wrapper, x, wqkv, bqkv, pos, out, dims: tuple,
            c: int, heads: int, win: int) -> None:
    """Launch `entry` (the tensor-core body, on wqkv's fragments) or its
    FP32-core twin `entry`_fp32 (on wqkv), as `attention_branch` picks,
    with the trailing arguments `dims`; count the launch and its branch on
    `wrapper`."""
    branch = attention_branch(c, heads, win)
    if branch == "tc":
        wt = _wqkv_fragments(wqkv, heads)
    else:
        entry, wt = entry + "_fp32", wqkv
    _cuda.launch(entry, x.device, x, wt, bqkv, pos, out, *dims)
    wrapper.launches += 1
    wrapper.variants[branch] += 1


def _check(name, x, c, heads, win, wqkv, bqkv, pos,
           dtypes=_cuda.STORAGE):
    s = win * win
    if c % heads or s > 64:
        raise ValueError(f"{name}: need C divisible by {heads} and win <= 8, "
                         f"got {tuple(x.shape)}")
    if (wqkv.shape != (3 * c, c) or bqkv.shape != (3 * c,)
            or pos.shape != (heads, s, s)):
        raise ValueError(f"{name}: parameter shapes do not match")
    _cuda.check_cuda(name, x.device, dtypes, x=x)
    _cuda.check_cuda_f32(name, x.device, wqkv=wqkv, bqkv=bqkv, pos=pos)


def _storage_entry(entry: str, x) -> str:
    """`entry`, or its bf16 storage twin for a bfloat16 x."""
    return entry + "_bf16" if x.dtype == torch.bfloat16 else entry


def _eval_or_recompute(name, kernel, plain, x, *weights):
    """`kernel` on a bfloat16 x (eval only: no gradient may be recorded),
    else differentiable through `recompute`."""
    if x.dtype == torch.bfloat16:
        _cuda.check_eval_storage(name, x, *weights)
        return kernel(x, *weights)
    return recompute(kernel, plain, x, *weights)


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
        _launch(_storage_entry("lgteun_window_attention", y),
                window_attention, y, wqkv, bqkv, pos, out,
                (b, c, h, w, heads, win, (c // heads) ** -0.5), c, heads, win)
        return out

    return _eval_or_recompute(
        "window_attention", kernel,
        lambda *t: window_attention_ref(*t, heads, win), y, wqkv, bqkv, pos)


window_attention.launches = 0
window_attention.variants = collections.Counter()


def _launch_windows(entry, wrapper, x, wqkv, bqkv, pos, heads,
                    channel_dim, dtypes=_cuda.STORAGE):
    """Launch `entry` (or its FP32-core twin, or their bf16 storage twins
    for a bfloat16 x) on the windows of x ([N, C, S] or [N, S, C]) and
    count it on `wrapper`."""
    name = wrapper.__name__
    n, c, s = x.shape[0], x.shape[channel_dim], x.shape[3 - channel_dim]
    win = int(round(s ** 0.5))
    if win * win != s:
        raise ValueError(f"{name}: S must be a square, got {tuple(x.shape)}")
    _check(name, x, c, heads, win, wqkv, bqkv, pos, dtypes)
    out = torch.empty_like(x)
    _launch(_storage_entry(entry, x), wrapper, x, wqkv, bqkv, pos, out,
            (n, c, heads, win, (c // heads) ** -0.5), c, heads, win)
    return out


def window_attention_windows(xt, wqkv, bqkv, pos, heads: int):
    """Window MHSA on [N, C, S] windows -> [N, C, S] (S = win^2 <= 64)."""
    if _cuda.plain_on_cpu("window_attention_windows", xt):
        return window_attention_windows_ref(xt, wqkv, bqkv, pos, heads)

    def kernel(xt, wqkv, bqkv, pos):
        return _launch_windows("lgteun_window_attention_windows",
                               window_attention_windows, xt, wqkv, bqkv,
                               pos, heads, 1)

    return _eval_or_recompute(
        "window_attention_windows", kernel,
        lambda *t: window_attention_windows_ref(*t, heads), xt, wqkv, bqkv,
        pos)


window_attention_windows.launches = 0
window_attention_windows.variants = collections.Counter()


def window_attention_rows(xw, wqkv, bqkv, pos, heads: int):
    """Window MHSA on [N, S, C] windows -> [N, S, C] (S = win^2 <= 64).
    On no model path: forward only, as its JAX counterpart."""
    if _cuda.plain_on_cpu("window_attention_rows", xw):
        return window_attention_rows_ref(xw, wqkv, bqkv, pos, heads)
    return _launch_windows("lgteun_window_attention_rows",
                           window_attention_rows, xw, wqkv, bqkv, pos, heads,
                           2, (torch.float32,))


window_attention_rows.launches = 0
window_attention_rows.variants = collections.Counter()
