"""One whole LGB block in one launch.

Counterpart of `lgteun_tpu/ops/lgb_block_kernel.py::fused_lgb_block_cm`
(Pallas) and `lgb_block_xla_cm` (its plain version), on [B, C, H, W]:

    y1, x2 = ln_mixer_head(x)                LN, split, FFT global mixer
    x1     = window_attention(y1)            8x8-window MHSA
    out    = block_tail(x, x1, x2)           proj + residual, LN + FFN

`lgb_block` launches `csrc/lgb_block.cu` (a persistent cooperative kernel
that runs the three stages as phases separated by grid syncs, with the
intermediates in a scratch buffer it allocates) for a CUDA tensor, and
runs `lgb_block_ref`, the plain composition, for a CPU tensor.

`blk` holds the block's weights: ln_w/ln_b [C] (the mixer's LN),
amp_w/amp_b/pha_w/pha_b [C/2], wqkv [3C/2, C/2] (out, in), bqkv [3C/2],
pos [heads, win^2, win^2], proj_w [C, C] (out, in), proj_b [C], and
`ffn`, the FeedForward's dict of `ops/ffn_kernel.py`.
"""

from __future__ import annotations

import torch

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.ffn_kernel import (_ffn_shapes, _fragments,
                                             block_tail_ref, check_tail_args,
                                             tail_weights)
from lgteun_tpu_torch.ops.spectral_kernel import (_check_plane,
                                                  ln_mixer_head_ref)
from lgteun_tpu_torch.ops.window_attention import window_attention_ref

__all__ = ["lgb_block", "lgb_block_ref"]

_MIXER = ("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b")


def lgb_block_ref(x, blk: dict, heads: int = 2, win: int = 8,
                  eps: float = 1e-5):
    """Plain version: the three plain stages in turn."""
    y1, x2 = ln_mixer_head_ref(x, *(blk[k] for k in _MIXER), eps)
    x1 = window_attention_ref(y1, blk["wqkv"], blk["bqkv"], blk["pos"],
                              heads, win)
    return block_tail_ref(x, x1, x2, blk["proj_w"], blk["proj_b"],
                          blk["ffn"], eps)


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
    scratch = torch.empty(3 * b * c2 * h * w, device=x.device,
                          dtype=x.dtype)
    counter = torch.empty(1, device=x.device, dtype=torch.int32)
    out = torch.empty_like(x)
    _cuda.launch("lgteun_lgb_block", x.device, x,
                 *(blk[k] for k in _MIXER), blk["wqkv"], blk["bqkv"],
                 blk["pos"], _fragments(blk["proj_w"], c), blk["proj_b"],
                 *tail_weights(blk["ffn"]), scratch, counter, out, b,
                 c, c4, h, w, heads, win, (c2 // heads) ** -0.5, eps)
    lgb_block.launches += 1
    return out


lgb_block.launches = 0
