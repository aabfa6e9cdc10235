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
`block_tail_ref` / `ln_ffn_ref` for a CPU tensor. The kernel runs the
four 1x1 products on the tensor cores (wgmma) with the 3xTF32 split: its
matrices come split into hi/lo TF32 parts and in wgmma's core-matrix
order (`tail_fragments`), made once per weight version (one
`lgteun_tail_fragments` launch a matrix on the card). C is at most
`TAIL_MAX_WIDTH`: up to 64 channels on the kernel's shared-memory tile,
above that on its wide tile, whose h1 lives in a global scratch slot of
each block (`tail_variant`; each wrapper counts its launches of either in
`variants`). `ffn` holds the
FeedForward's weights in torch conv layout: ln_w/ln_b [C], w1 [4C, C],
b1 [4C], w2 [4C, 4C], b2 [4C], dw [4C, 3, 3], bdw [4C], w3 [C, 4C],
b3 [C].

Storage (`ops.storage_dtype`): `block_tail` takes x (and gives out) as
float32 or bfloat16 and x1, x2 as float32 or bfloat16, every
combination; `ln_ffn` takes and gives one dtype. A bfloat16 tensor is
upcast as loaded, all math is float32, and out is rounded once to
nearest even as stored; the plain versions spell that out (`out_dtype`:
the result's dtype, default x's). The bfloat16 entries are for eval (no
backward); `block_tail_masked` (training's) takes float32 only.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["block_tail", "block_tail_ref", "block_tail_masked",
           "block_tail_masked_ref", "ln_ffn", "ln_ffn_ref", "ln_ffn_mixed",
           "bf16_operands", "FFN_KEYS",
           "tf32_round", "tf32_split", "tail_fragments", "tail_width",
           "tail_variant", "TAIL_MAX_WIDTH"]

# the order in which `ffn`'s tensors pass through `recompute`
FFN_KEYS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "dw", "bdw", "w3", "b3")
# the kernel's padded channel widths: the shared-memory tile at 32 and
# 64, the wide tile (h1 [112][4C + 4] in global scratch) at 128
TAIL_MAX_WIDTH = 128
# floats of the wide tile's h1 scratch slot, one a block
_WIDE_SLOT = 112 * (4 * TAIL_MAX_WIDTH + 4)


def _pw(t, wt, bias):
    return F.conv2d(t, wt[:, :, None, None], bias)


def ln_ffn_ref(x, ffn: dict, eps: float = 1e-5, out_dtype=None):
    """Plain version of x + FFN(LN(x)), of `out_dtype` (default x's)."""
    out_dtype = out_dtype or x.dtype
    x = upcast(x)
    y = channel_layer_norm(x, ffn["ln_w"], ffn["ln_b"], eps)
    h = F.gelu(_pw(y, ffn["w1"], ffn["b1"]), approximate="none")
    h = _pw(h, ffn["w2"], ffn["b2"])
    h = F.conv2d(h, ffn["dw"][:, None], ffn["bdw"], padding=1,
                 groups=h.shape[1])
    h = F.gelu(h, approximate="none")
    return (x + _pw(h, ffn["w3"], ffn["b3"])).to(out_dtype)


def bf16_operands(t: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """t rounded to `dtype` and upcast to float32 again (exact): an
    operand of a float32 product of bf16 operands, JAX's `einsum(...,
    preferred_element_type=jnp.float32)` on `dtype` inputs, whose
    backward rounds the gradient to `dtype` as JAX's does."""
    return t.to(dtype).float()


def ln_ffn_mixed(x, ffn: dict, eps: float = 1e-5, dtype=torch.bfloat16):
    """x + FFN(LN(x)) as JAX's `ln_ffn_xla(..., dtype=bf16)` computes it
    (`lgteun_tpu/ops/ffn_kernel.py:47-86`), UnlgFormer's selective
    `mixed_precision` training: the LN, the GELUs, the bias adds and the
    residual float32; each 1x1 product a float32 product of `dtype`
    operands; the depthwise 3x3 wholly in `dtype` (one rounding of its
    output, as flax's `Conv(dtype=bf16)` gives), then upcast and its bias
    added in float32. x float32 [B, C, H, W]. Plain torch: no kernel of
    either package computes this function (JAX routes mixed training
    away from its float32 kernels, `lgteun_tpu/models/common/lgt.py:
    266-269`), so this is not a plain version standing in for `ln_ffn`."""
    r = lambda t: bf16_operands(t, dtype)
    mm = lambda t, w, b: F.conv2d(r(t), r(w)[:, :, None, None]) + b[
        None, :, None, None]
    y = channel_layer_norm(x, ffn["ln_w"], ffn["ln_b"], eps)
    h = F.gelu(mm(y, ffn["w1"], ffn["b1"]))
    h = mm(h, ffn["w2"], ffn["b2"])
    h = F.conv2d(r(h), r(ffn["dw"])[:, None], padding=1,
                 groups=h.shape[1]).to(dtype).float()
    h = F.gelu(h + ffn["bdw"][None, :, None, None])
    return x + mm(h, ffn["w3"], ffn["b3"])


def block_tail_ref(x, x1, x2, proj_w, proj_b, ffn: dict,
                   eps: float = 1e-5, mask=None, out_dtype=None):
    """Plain version. proj_w [C, C] (out, in), proj_b [C]; mask
    [B, C, H, W] or None; the result of `out_dtype` (default x's)."""
    mixed = _pw(torch.cat([upcast(x1), upcast(x2)], dim=1), proj_w, proj_b)
    if mask is not None:
        mixed = mixed * mask
    return ln_ffn_ref(upcast(x) + mixed, ffn, eps, out_dtype or x.dtype)


def block_tail_masked_ref(x, x1, x2, mask, proj_w, proj_b, ffn: dict,
                          eps: float = 1e-5):
    """Plain version of `block_tail_masked`."""
    return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps, mask)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to the nearest TF32 value, ties away from zero
    (PTX `cvt.rna.tf32.f32`): the low 13 mantissa bits become zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple:
    """(hi, lo) TF32 parts of float32 `t`: hi = tf32(t), lo = tf32(t -
    hi); |lo| <= 2^-11 |t| and |t - hi - lo| <= 2^-22 |t|."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def tail_width(c: int) -> int:
    """The kernel's padded channel width for C <= TAIL_MAX_WIDTH channels:
    32, 64 or 128."""
    return 32 if c <= 32 else 64 if c <= 64 else TAIL_MAX_WIDTH


def tail_variant(c: int) -> str:
    """The tile that runs a C-channel tail: "tile" (h1 in shared memory,
    C <= 64) or "wide" (h1 in a global scratch slot, 64 < C <= 128)."""
    return "tile" if c <= 64 else "wide"


def _wide_scratch(device: torch.device) -> tuple:
    """(scratch, slots) of the wide tile: one h1 slot an SM (the wide
    kernel's persistent blocks, one an SM)."""
    slots = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.empty(slots * _WIDE_SLOT, device=device), slots


def _launch_tail(entry: str, wrapper, x, args: tuple, dims: tuple) -> None:
    """Launch tail entry `entry` (`lgteun_block_tail` or `lgteun_ln_ffn`)
    or its wide twin, chosen by x's C, on `args` (up to `out`) and `dims`
    (B, C, C4, H, W, eps); count the launch and its variant."""
    variant = tail_variant(x.shape[1])
    if variant == "wide":
        bf16 = entry.endswith("_bf16")
        entry = entry.removesuffix("_bf16") + "_wide" + "_bf16" * bf16
        args += _wide_scratch(x.device)
    _cuda.launch(entry, x.device, *args, *dims)
    wrapper.launches += 1
    wrapper.variants[variant] += 1


def tail_fragments(w: torch.Tensor, n_pad: int, k_pad: int,
                   cp: int) -> torch.Tensor:
    """w [N, K] (out, in), zero-padded to [n_pad, k_pad] and split into
    TF32 hi/lo parts, as the kernel's slabs: [n_pad / cp chunks][k_pad /
    32 slabs][hi, lo][cp / 8 n-groups][8 k-quads][8][4], element (n, k)
    at n-group n // 8, k-quad k // 4, [n % 8][k % 4] within the slab. Each
    [8][4] is one core matrix of wgmma's K-major operand without swizzle
    (8 rows of 16 bytes, B[k][n] = w[n][k]): the next k-quad 128 bytes
    on, the next n-group 1024. Flat float32. `lgteun_tail_fragments`
    makes the same bits on the card."""
    n, k = w.shape
    hi, lo = tf32_split(F.pad(w.float(), (0, k_pad - k, 0, n_pad - n)))
    t = torch.stack([hi, lo]).view(2, n_pad // cp, cp // 8, 8, k_pad // 32,
                                   8, 4)
    # (hi/lo, chunk, n-group, n % 8, slab, k-quad, k % 4) -> slab order
    return t.permute(1, 4, 0, 2, 5, 3, 6).contiguous().view(-1)


def _fragments(w: torch.Tensor, c: int) -> torch.Tensor:
    """`tail_fragments` of a tail matrix of a C-channel block (each dim C
    or 4C, padded to the kernel's width), made once per weight version:
    by `lgteun_tail_fragments` for a CUDA tensor (one launch)."""
    cp = tail_width(c)
    n_pad, k_pad = w.shape[0] // c * cp, w.shape[1] // c * cp

    def make():
        if w.device.type != "cuda":
            return tail_fragments(w, n_pad, k_pad, cp)
        _cuda.check_cuda_f32("tail_fragments", w.device, w=w)
        out = torch.empty(2 * n_pad * k_pad, device=w.device)
        _cuda.launch("lgteun_tail_fragments", w.device, w, w.shape[0],
                     w.shape[1], n_pad, k_pad, cp, out)
        _fragments.launches += 1
        return out

    return _cuda.weight_layout(f"tf32x3/{c}", (w,), make)


_fragments.launches = 0


def _ffn_shapes(c: int, c4: int) -> dict:
    return {"ln_w": (c,), "ln_b": (c,), "w1": (c4, c), "b1": (c4,),
            "w2": (c4, c4), "b2": (c4,), "dw": (c4, 3, 3), "bdw": (c4,),
            "w3": (c, c4), "b3": (c,)}


def check_tail_args(name: str, x, got: dict, want: dict,
                    storage: tuple = ()) -> None:
    """Raise unless x [B, C, H, W] and the tensors of `got` suit the tail
    kernel: shapes as in `want`, C % 4 == 0 and C <= TAIL_MAX_WIDTH, a 4C
    hidden width, H and W divisible by 8, contiguous on x's CUDA device,
    the tensors named in `storage` ("x" or keys of `got`) float32 or
    bfloat16, the others float32."""
    b, c, h, w = x.shape
    c4 = got["w1"].shape[0]
    bad = [k for k, shp in want.items() if tuple(got[k].shape) != shp]
    if bad or c % 4 or c > TAIL_MAX_WIDTH or c4 != 4 * c or h % 8 or w % 8:
        raise ValueError(f"{name}: need C % 4 == 0, C <= {TAIL_MAX_WIDTH}, "
                         f"4C hidden and H, W divisible by 8 (x "
                         f"{tuple(x.shape)}); bad: {bad}")
    tensors = dict(got, x=x)
    _cuda.check_cuda(name, x.device, _cuda.STORAGE,
                     **{k: tensors[k] for k in storage})
    _cuda.check_cuda_f32(name, x.device, **{
        k: v for k, v in tensors.items() if k not in storage})


def tail_weights(ffn: dict) -> tuple:
    """The FFN's weights in the tensor-core kernel's argument order and
    layout."""
    c = ffn["ln_w"].shape[0]
    return (ffn["ln_w"], ffn["ln_b"], _fragments(ffn["w1"], c), ffn["b1"],
            _fragments(ffn["w2"], c), ffn["b2"], ffn["dw"], ffn["bdw"],
            _fragments(ffn["w3"], c), ffn["b3"])


def _split(t):
    """`_tail`'s positional tensors -> ((x, x1, x2, proj_w, proj_b), ffn,
    mask or None)."""
    n = 5 + len(FFN_KEYS)
    return t[:5], dict(zip(FFN_KEYS, t[5:n])), (t[n] if len(t) > n else None)


def _tail(name, wrapper, tensors, eps):
    """The launch of the block tail, differentiable in float32 storage;
    `tensors` are x, x1, x2, proj_w, proj_b, the FFN's weights in
    FFN_KEYS order and, for the masked variant, the mask (which gets no
    gradient). A bfloat16 x, x1 or x2 takes the bf16 entry (no mask, no
    gradient)."""
    bf16 = any(t.dtype == torch.bfloat16 for t in tensors[:3])

    def kernel(*t):
        (x, x1, x2, proj_w, proj_b), ffn, mask = _split(t)
        b, c, h, w = x.shape
        c4 = ffn["w1"].shape[0]
        got = dict(ffn, x1=x1, x2=x2, proj_w=proj_w, proj_b=proj_b)
        want = dict(_ffn_shapes(c, c4), x1=(b, c // 2, h, w),
                    x2=(b, c // 2, h, w), proj_w=(c, c), proj_b=(c,))
        if mask is not None:
            got["mask"], want["mask"] = mask, (b, c, h, w)
        if x1.dtype != x2.dtype:
            raise ValueError(f"{name}: x1 and x2 must share a dtype, got "
                             f"{x1.dtype} and {x2.dtype}")
        check_tail_args(name, x, got, want,
                        ("x", "x1", "x2") if mask is None else ())
        out = torch.empty_like(x)
        weights = (_fragments(proj_w, c), proj_b, *tail_weights(ffn))
        if bf16:
            _launch_tail("lgteun_block_tail_bf16", wrapper, x, (
                x, x1, x2, *weights, out), (b, c, c4, h, w,
                                            _cuda.storage_flag(x),
                                            _cuda.storage_flag(x1), eps))
        else:
            _launch_tail("lgteun_block_tail", wrapper, x, (
                x, x1, x2, mask, *weights, out), (b, c, c4, h, w, eps))
        return out

    def plain(*t):
        (x, x1, x2, proj_w, proj_b), ffn, mask = _split(t)
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps, mask)

    if bf16:
        _cuda.check_eval_storage(name, *tensors)
        return kernel(*tensors)
    return recompute(kernel, plain, *tensors)


def block_tail(x, x1, x2, proj_w, proj_b, ffn: dict, eps: float = 1e-5):
    """Block tail on [B, C, H, W] (x) and [B, C/2, H, W] (x1, x2)."""
    if _cuda.plain_on_cpu("block_tail", x):
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps)
    return _tail("block_tail", block_tail, (
        x, x1, x2, proj_w, proj_b, *(ffn[k] for k in FFN_KEYS)), eps)


block_tail.launches = 0
block_tail.variants = collections.Counter()


def block_tail_masked(x, x1, x2, mask, proj_w, proj_b, ffn: dict,
                      eps: float = 1e-5):
    """Block tail whose proj output is multiplied by `mask`
    [B, C, H, W] before the residual add (training dropout)."""
    if _cuda.plain_on_cpu("block_tail_masked", x):
        return block_tail_ref(x, x1, x2, proj_w, proj_b, ffn, eps, mask)
    return _tail("block_tail_masked", block_tail_masked, (
        x, x1, x2, proj_w, proj_b, *(ffn[k] for k in FFN_KEYS), mask), eps)


block_tail_masked.launches = 0
block_tail_masked.variants = collections.Counter()


def ln_ffn(x, ffn: dict, eps: float = 1e-5):
    """x + FFN(LN(x)) on [B, C, H, W] (same contract as `ln_ffn_ref`)."""
    if _cuda.plain_on_cpu("ln_ffn", x):
        return ln_ffn_ref(x, ffn, eps)

    ffn_t = tuple(ffn[k] for k in FFN_KEYS)
    bf16 = x.dtype == torch.bfloat16

    def kernel(x, *ffn_t):
        ffn = dict(zip(FFN_KEYS, ffn_t))
        b, c, h, w = x.shape
        c4 = ffn["w1"].shape[0]
        check_tail_args("ln_ffn", x, ffn, _ffn_shapes(c, c4), ("x",))
        out = torch.empty_like(x)
        _launch_tail("lgteun_ln_ffn_bf16" if bf16 else "lgteun_ln_ffn",
                     ln_ffn, x, (x, *tail_weights(ffn), out),
                     (b, c, c4, h, w, eps))
        return out

    if bf16:
        _cuda.check_eval_storage("ln_ffn", x, *ffn_t)
        return kernel(x, *ffn_t)
    return recompute(kernel, lambda x, *t: ln_ffn_ref(
        x, dict(zip(FFN_KEYS, t)), eps), x, *ffn_t)


ln_ffn.launches = 0
ln_ffn.variants = collections.Counter()
