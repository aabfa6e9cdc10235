"""One whole LGB block in one launch.

Counterpart of `lgteun_tpu/ops/lgb_block_kernel.py::fused_lgb_block_cm`
(Pallas) and `lgb_block_xla_cm` (its plain version), on [B, C, H, W]:

    y1, x2 = ln_mixer_head(x)                LN, split, FFT global mixer
    x1     = window_attention(y1)            8x8-window MHSA
    out    = block_tail(x, x1, x2)           proj + residual, LN + FFN

`lgb_block` launches `csrc/lgb_block.cu` for a CUDA tensor, and runs
`lgb_block_ref`, the plain composition, for a CPU tensor. The kernel is
persistent and cooperative: its blocks take items from one work list in
order (LN items, mixer planes, window items, tail items, each image by
image) and wait on per-image dependency counters, not on grid barriers.
`lgb_schedule` computes the list's numbers, which the wrapper passes to
the kernel, and `lgb_work_list` / `lgb_item_needs` spell the list and its
waits out (the CPU tests simulate it). The window items run B2's
tensor-core body where `lgb_attention_branch` gives "tc" (wqkv then
passes as `attention_fragments`), else B2's FP32-core body; the tail
items B3's tile (at C <= 32 on each pair of a block's warpgroups, which
take tiles on their own), or the wide tile above 64 channels (with one h1
slot an SM in the scratch). `lgb_block.variants` counts the launches by
attention branch and by tail variant.

B8 holds each mixer plane's half spectrum in one block's shared memory
(the FFT mixer's one-block body), so it takes the planes B1 takes on
that route (up to 240 x 240; even sides whose prime factors are at most
512: B8's own kernel is not widened to the rest). For a larger plane, or
one B8 does not take (an odd side or a prime factor above 512 that one
block holds), `lgb_block` runs the block as level 2's chain instead,
chosen by shape before any launch (`lgb_route`): `ln_mixer_head` (on the
mixer's cluster or global route), then
`window_attention`, then `block_tail`, each counted under its own name.
That chain computes B8's function (the same LN, mixer, attention and
tail, the branches rounded to `branch_dtype` where level 2 stores them),
as the JAX package's level 3 keeps the 3-kernel path where its
megakernel does not take a shape.

`blk` holds the block's weights: ln_w/ln_b [C] (the mixer's LN),
amp_w/amp_b/pha_w/pha_b [C/2], wqkv [3C/2, C/2] (out, in), bqkv [3C/2],
pos [heads, win^2, win^2], proj_w [C, C] (out, in), proj_b [C], and
`ffn`, the FeedForward's dict of `ops/ffn_kernel.py`.

Storage (`ops.storage_dtype`): x (and out) float32 or bfloat16, upcast as
loaded, math float32, out rounded once as stored. `branch_dtype`
bfloat16 rounds y1, x2 and x1 to bfloat16 where level 2 stores them in
that dtype (the kernel keeps them in float32 scratch, rounded), so that
the block computes level 2's function in either storage mode; the JAX
package's block kernel skips that rounding (ROADMAP C.8). The kernel
takes x float32 with no branch rounding (float32 storage) or either
dtype with it; the plain version takes any combination.
"""

from __future__ import annotations

import collections

import torch

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.ffn_kernel import (_WIDE_SLOT, _ffn_shapes,
                                             _fragments, block_tail,
                                             block_tail_ref,
                                             check_tail_args, tail_variant,
                                             tail_weights, tail_width)
from lgteun_tpu_torch.ops.spectral_kernel import (FFT_MAX_PRIME,
                                                  _check_plane,
                                                  fft_mixer_plan, fft_tables,
                                                  ln_mixer_head,
                                                  ln_mixer_head_ref,
                                                  mixer_route)
from lgteun_tpu_torch.ops.window_attention import (_wqkv_fragments,
                                                   attention_branch,
                                                   window_attention,
                                                   window_attention_ref)

__all__ = ["lgb_block", "lgb_block_ref", "lgb_attention_branch",
           "lgb_route", "lgb_schedule", "lgb_work_list", "lgb_item_needs",
           "KINDS"]

_MIXER = ("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b")


def lgb_block_ref(x, blk: dict, heads: int = 2, win: int = 8,
                  eps: float = 1e-5, branch_dtype=None, out_dtype=None):
    """Plain version: the three plain stages in turn, y1, x2 and x1 of
    `branch_dtype` (default: unrounded, the dtype of x's math), the result
    of `out_dtype` (default x's dtype)."""
    branch = branch_dtype or upcast(x).dtype
    y1, x2 = ln_mixer_head_ref(x, *(blk[k] for k in _MIXER), eps, branch)
    x1 = window_attention_ref(y1, blk["wqkv"], blk["bqkv"], blk["pos"],
                              heads, win, branch)
    return block_tail_ref(x, x1, x2, blk["proj_w"], blk["proj_b"],
                          blk["ffn"], eps, out_dtype=out_dtype or x.dtype)


def lgb_route(h: int, w: int) -> str:
    """How `lgb_block` runs a block on H x W planes: "block" (B8, one
    launch) where the mixer's half spectrum fits one block's shared
    memory and B8's mixer takes the plane (even sides, prime factors at
    most FFT_MAX_PRIME: B8 is not widened to odd sides or the line
    buffer), else "chain" (B1 on its route by shape, B2, B3: level 2's
    chain); None where the mixer takes no route."""
    route = mixer_route(h, w)
    if route is None:
        return None
    block = (route["route"] == "smem" and h % 2 == 0 and w % 2 == 0
             and fft_mixer_plan(h, w)["gbuf"] == 0)
    return "block" if block else "chain"


def lgb_attention_branch(c2: int, heads: int, win: int) -> str:
    """The window attention body of the kernel's window items for C/2 =
    c2 channels: "tc" where B2's tensor-core body takes the shape and 4 is
    a multiple of the heads (a window item's pairs alternate over its two
    warpgroups, so each keeps the position bias of one head, or of two at
    4 heads), else "fp32"."""
    tc = attention_branch(c2, heads, win) == "tc" and 4 % heads == 0
    return "tc" if tc else "fp32"


# the kinds of work item, in the order the list holds them
KINDS = ("ln", "planes", "windows", "tails")
# pixels an LN item: 512 (one a thread of the 512) up to 2048 (four a
# thread, normalised at once), so that there are about LN_ITEMS LN items
# (about one an SM: the planes wait for them)
LN_ITEMS = 128


def ln_pixels(pixels: int) -> int:
    """Pixels an LN item for `pixels` pixels in all (B H W)."""
    return 512 * max(1, min(4, pixels // (512 * LN_ITEMS)))
# (window, head) pairs a tensor-core window item: about PAIR_CHANNELS /
# (C/2), so that an item is about the same work at any width (8 at C/2 =
# 16, 4 at 32), even (the item's two warpgroups take every other pair and
# so keep one head each at 2 heads), within 2-16
PAIR_CHANNELS = 128


def pairs_per_item(c2: int) -> int:
    """(window, head) pairs a tensor-core window item at C/2 = c2."""
    return 2 * max(1, min(8, PAIR_CHANNELS // c2 // 2))


def lgb_schedule(b: int, c: int, h: int, w: int, heads: int = 2,
                 win: int = 8) -> dict:
    """The numbers of the kernel's work list for x [b, c, h, w]: items of
    each kind an image (`per_image`: LN items of `ln_px` pixels, C/2
    mixer planes, window items of `per_item` (window, head) pairs on the
    "tc" branch (`pairs_per_item`) or of one window on "fp32", and tail
    items of one 8x8 tile,
    which at C <= 32 each pair of a block's warpgroups takes on its own:
    `tail_workers` 2 a block, else 1), and `pairs` (the image's (window,
    head) pairs, or windows on "fp32")."""
    branch = lgb_attention_branch(c // 2, heads, win)
    nwin = (h // win) * (w // win)
    pairs = nwin * heads if branch == "tc" else nwin
    per_item = pairs_per_item(c // 2) if branch == "tc" else 1
    ln_px = ln_pixels(b * h * w)
    per = {"ln": -(-h * w // ln_px), "planes": c // 2,
           "windows": -(-pairs // per_item), "tails": (h // 8) * (w // 8)}
    return {"images": b, "per_image": per, "ln_px": ln_px,
            "pairs": pairs, "per_item": per_item, "branch": branch,
            "tail_workers": 2 if tail_width(c) == 32 else 1}


def _schedule_ints(s: dict) -> list:
    """The 7 numbers lgteun_lgb_block takes (its LgbSchedule)."""
    return [s["per_image"][k] for k in KINDS] + [s["ln_px"], s["pairs"],
                                                 s["per_item"]]


def lgb_work_list(s: dict) -> list:
    """(kind, image, index within the image) of every item, in the order
    the kernel hands them out: by kind (KINDS), then image by image."""
    return [(k, b, j) for k in KINDS for b in range(s["images"])
            for j in range(s["per_image"][k])]


def lgb_item_needs(s: dict, kind: str, image: int) -> dict:
    """{(kind, image): count}: the done-counters an item of `kind` and
    `image` waits for, and the counts they must reach (an item counts
    itself done in the (kind, image) counter when it ends). A plane or a
    window item needs its image's LN items; a tail item all of its
    image's planes (the mixer is global over a plane) and window items."""
    per = s["per_image"]
    if kind in ("planes", "windows"):
        return {("ln", image): per["ln"]}
    if kind == "tails":
        return {("planes", image): per["planes"],
                ("windows", image): per["windows"]}
    return {}


def lgb_block(x, blk: dict, heads: int = 2, win: int = 8,
              eps: float = 1e-5, branch_dtype=None):
    """One LGB block on [B, C, H, W] -> [B, C, H, W] of x's dtype (same
    contract as `lgb_block_ref`; no gradient): B8, or level 2's chain
    where B8 does not take the planes (`lgb_route`)."""
    if x.device.type == "cpu":
        return lgb_block_ref(x, blk, heads, win, eps, branch_dtype)
    if lgb_route(*x.shape[-2:]) == "chain":
        _check_branch(x, branch_dtype)
        y1, x2 = ln_mixer_head(x, *(blk[k] for k in _MIXER), eps=eps,
                               out_dtype=branch_dtype)
        x1 = window_attention(y1, blk["wqkv"], blk["bqkv"], blk["pos"],
                              heads, win)
        return block_tail(x, x1, x2, blk["proj_w"], blk["proj_b"],
                          blk["ffn"], eps)
    out = _launch(x, blk, heads, win, eps, 0, branch_dtype)
    branch = lgb_attention_branch(x.shape[1] // 2, heads, win)
    lgb_block.launches += 1
    lgb_block.variants[branch] += 1
    lgb_block.variants[tail_variant(x.shape[1])] += 1
    return out


def _check_branch(x, branch_dtype) -> None:
    if branch_dtype not in (None, torch.bfloat16) or (
            branch_dtype is None and x.dtype == torch.bfloat16):
        raise ValueError(
            "lgb_block: takes (x, branch_dtype) as (float32, None), "
            f"(float32, bfloat16) or (bfloat16, bfloat16), got ({x.dtype}, "
            f"{branch_dtype})")


def _launch(x, blk: dict, heads: int, win: int, eps: float, blocks: int,
            branch_dtype=None):
    """Check the arguments and launch the kernel on a grid of `blocks`
    blocks (0: one an SM, as `lgb_block` runs it; fewer only to exercise
    the work list: its output is the same bit for bit); return out."""
    if x.device.type != "cuda":
        raise ValueError(f"lgb_block: unsupported device {x.device}")
    _check_branch(x, branch_dtype)
    b, c, h, w = x.shape
    c2, c4, s = c // 2, blk["ffn"]["w1"].shape[0], win * win
    if h % win or w % win or c2 % heads or s > 64:
        raise ValueError(f"lgb_block: need H, W divisible by {win}, C/2 by "
                         f"{heads} and win <= 8, got {tuple(x.shape)}")
    _check_plane("lgb_block", x)
    if lgb_route(h, w) != "block":
        raise ValueError(f"lgb_block: B8 holds a plane's half spectrum in "
                         f"shared memory (up to 240 x 240; even sides, "
                         f"prime factors at most {FFT_MAX_PRIME}; other "
                         f"planes run level 2's chain, lgb_route), got "
                         f"{tuple(x.shape)}")
    mixer = dict(ln_w=(c,), ln_b=(c,), amp_w=(c2,), amp_b=(c2,),
                 pha_w=(c2,), pha_b=(c2,), wqkv=(3 * c2, c2),
                 bqkv=(3 * c2,), pos=(heads, s, s))
    bad = [k for k, shp in mixer.items() if tuple(blk[k].shape) != shp]
    if bad:
        raise ValueError(f"lgb_block: parameter shapes do not match C: "
                         f"{bad}")
    _cuda.check_cuda_f32("lgb_block", x.device,
                         **{k: blk[k] for k in mixer})
    check_tail_args("lgb_block", x, dict(blk["ffn"], proj_w=blk["proj_w"],
                                         proj_b=blk["proj_b"]),
                    dict(_ffn_shapes(c, c4), proj_w=(c, c), proj_b=(c,)),
                    ("x",))
    branch = lgb_attention_branch(c2, heads, win)
    wqkv = (_wqkv_fragments(blk["wqkv"], heads) if branch == "tc"
            else blk["wqkv"])
    # the wide tile's h1 slots (one an SM) after the three planes
    slots = (torch.cuda.get_device_properties(x.device).multi_processor_count
             if tail_variant(c) == "wide" else 0)
    scratch = torch.empty(3 * b * c2 * h * w + slots * _WIDE_SLOT,
                          device=x.device, dtype=torch.float32)
    # the list's head and each image's LN, plane and window counts, one
    # 128-byte line each: zero before the launch (nothing in the kernel
    # zeroes them)
    counters = torch.zeros((1 + 3 * b) * 32, device=x.device,
                           dtype=torch.int32)
    sched = torch.tensor(_schedule_ints(lgb_schedule(b, c, h, w, heads,
                                                     win)),
                         dtype=torch.int32)   # host memory, read at launch
    out = torch.empty_like(x)
    rounded = branch_dtype is not None
    _cuda.launch("lgteun_lgb_block_bf16" if rounded else "lgteun_lgb_block",
                 x.device, x, *(blk[k] for k in _MIXER),
                 fft_tables(h, w, x.device), wqkv, blk["bqkv"], blk["pos"],
                 _fragments(blk["proj_w"], c), blk["proj_b"],
                 *tail_weights(blk["ffn"]), scratch, counters, out, b, c, c4,
                 h, w, heads, win, sched, blocks,
                 *((_cuda.storage_flag(x),) if rounded else ()),
                 (c2 // heads) ** -0.5, eps)
    return out


lgb_block.launches = 0
lgb_block.variants = collections.Counter()
