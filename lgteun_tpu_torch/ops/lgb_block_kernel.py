"""One whole LGB block in one launch.

Counterpart of `lgteun_tpu/ops/lgb_block_kernel.py::fused_lgb_block_cm`
(Pallas) and `lgb_block_xla_cm` (its plain version), on [B, C, H, W]:

    y1, x2 = ln_mixer_head(x)                LN, split, FFT global mixer
    x1     = window_attention(y1)            8x8-window MHSA
    out    = block_tail(x, x1, x2)           proj + residual, LN + FFN

`lgb_block` launches `csrc/lgb_block.cu` (a persistent cooperative kernel
that runs the three stages as phases separated by grid syncs, with the
intermediates in a scratch buffer it allocates) for a CUDA tensor, and
runs `lgb_block_ref`, the plain composition, for a CPU tensor. Its
phase B runs B2's tensor-core body where `lgb_attention_branch` gives
"tc" (wqkv then passes as `attention_fragments`), else B2's FP32-core
body; its phase C runs B3's tile, or the wide tile above 64 channels
(with one h1 slot an SM in the scratch). `lgb_block.variants` counts the
launches by attention branch and by tail variant.

`blk` holds the block's weights: ln_w/ln_b [C] (the mixer's LN),
amp_w/amp_b/pha_w/pha_b [C/2], wqkv [3C/2, C/2] (out, in), bqkv [3C/2],
pos [heads, win^2, win^2], proj_w [C, C] (out, in), proj_b [C], and
`ffn`, the FeedForward's dict of `ops/ffn_kernel.py`.
"""

from __future__ import annotations

import collections

import torch

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.ffn_kernel import (_WIDE_SLOT, _ffn_shapes,
                                             _fragments, block_tail_ref,
                                             check_tail_args, tail_variant,
                                             tail_weights)
from lgteun_tpu_torch.ops.spectral_kernel import (_check_plane, fft_tables,
                                                  ln_mixer_head_ref)
from lgteun_tpu_torch.ops.window_attention import (_wqkv_fragments,
                                                   attention_branch,
                                                   window_attention_ref)

__all__ = ["lgb_block", "lgb_block_ref", "lgb_attention_branch"]

_MIXER = ("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b")


def lgb_block_ref(x, blk: dict, heads: int = 2, win: int = 8,
                  eps: float = 1e-5):
    """Plain version: the three plain stages in turn."""
    y1, x2 = ln_mixer_head_ref(x, *(blk[k] for k in _MIXER), eps)
    x1 = window_attention_ref(y1, blk["wqkv"], blk["bqkv"], blk["pos"],
                              heads, win)
    return block_tail_ref(x, x1, x2, blk["proj_w"], blk["proj_b"],
                          blk["ffn"], eps)


def lgb_attention_branch(c2: int, heads: int, win: int) -> str:
    """The window attention body of the kernel's phase B for C/2 = c2
    channels: "tc" where B2's tensor-core body takes the shape and 4 is a
    multiple of the heads (a work item is 4 (window, head) pairs, one for
    each of the block's warpgroups, whose heads must stay fixed), else
    "fp32"."""
    tc = attention_branch(c2, heads, win) == "tc" and 4 % heads == 0
    return "tc" if tc else "fp32"


def lgb_block(x, blk: dict, heads: int = 2, win: int = 8,
              eps: float = 1e-5):
    """One LGB block on [B, C, H, W] -> [B, C, H, W] (same contract as
    `lgb_block_ref`)."""
    if x.device.type == "cpu":
        return lgb_block_ref(x, blk, heads, win, eps)
    if x.device.type != "cuda":
        raise ValueError(f"lgb_block: unsupported device {x.device}")
    b, c, h, w = x.shape
    c2, c4, s = c // 2, blk["ffn"]["w1"].shape[0], win * win
    if h % win or w % win or c2 % heads or s > 64:
        raise ValueError(f"lgb_block: need H, W divisible by {win}, C/2 by "
                         f"{heads} and win <= 8, got {tuple(x.shape)}")
    _check_plane("lgb_block", x)
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
                    dict(_ffn_shapes(c, c4), proj_w=(c, c), proj_b=(c,)))
    branch = lgb_attention_branch(c2, heads, win)
    wqkv = (_wqkv_fragments(blk["wqkv"], heads) if branch == "tc"
            else blk["wqkv"])
    # the wide tile's h1 slots (one an SM) after the three planes
    slots = (torch.cuda.get_device_properties(x.device).multi_processor_count
             if tail_variant(c) == "wide" else 0)
    scratch = torch.empty(3 * b * c2 * h * w + slots * _WIDE_SLOT,
                          device=x.device, dtype=x.dtype)
    counter = torch.empty(1, device=x.device, dtype=torch.int32)
    out = torch.empty_like(x)
    _cuda.launch("lgteun_lgb_block", x.device, x,
                 *(blk[k] for k in _MIXER), fft_tables(h, w, x.device), wqkv,
                 blk["bqkv"], blk["pos"], _fragments(blk["proj_w"], c),
                 blk["proj_b"],
                 *tail_weights(blk["ffn"]), scratch, counter, out, b,
                 c, c4, h, w, heads, win, (c2 // heads) ** -0.5, eps)
    lgb_block.launches += 1
    lgb_block.variants[branch] += 1
    lgb_block.variants[tail_variant(c)] += 1
    return out


lgb_block.launches = 0
lgb_block.variants = collections.Counter()
