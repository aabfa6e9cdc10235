"""Local-Global Transformer (LGT), LGTEUN's prior, on [B, C, H, W].

Counterpart of `lgteun_tpu/models/common/lgt.py` with the semantics of
`lgteun_tpu/models/lgteun_fast.py::_lgb_cm` / `_lgt_cm`:

  patch_embed -> [LGB, down x2ch]* -> bottleneck LGB
              -> [up /2ch, skip-fuse, LGB]* -> tail + residual

The module tree keeps the reference's attribute names, so `state_dict()`
carries the reference's keys (e.g. `encoder_layers.0.0.blocks.0.0.fn.fn.
local_mixer.to_qkv.weight`) and `lgteun_tpu.convert.convert_state_dict`
maps it onto the flax tree. `_Residual` / `_PreNorm` / `LGMixer` /
`GlobalMixer` / `FeedForward` hold parameters under those names. How each
LGB block runs is chosen by `LGTEUN_FUSE_LEVEL` when the method is built
(`ops.fuse_level`, the JAX package's switch) and passed down as `level`
(`LGB.forward`):

    level 2 (default)  y1, x2 = ln_mixer_head(x)     LN, split, FFT mixer
                       x1 = window_attention(y1)     the local mixer
                       x = block_tail(x, x1, x2)     proj + residual, LN +
                                                     FFN + residual
    level 1            y = LN(x); x1 = window_attention(y[:, :C/2]);
                       x2 = global_mixer(y[:, C/2:]);
                       x = ln_ffn(x + proj([x1; x2]))
    level 3            x = lgb_block(x)              the block in one kernel

Storage (`LGTEUN_EVAL_DTYPE`, `ops.storage_dtype`, read when the method
is built and passed down as `storage`): an eval forward keeps the tensors
between the kernels in bfloat16, as `lgteun_tpu/models/lgteun_fast.py::
_lgt_cm` / `_lgb_cm` do; every kernel upcasts as it loads, computes in
float32 and rounds once as it stores. "bf16res": the mixer branches y1,
x1, x2 are bfloat16, the residual stream x and the rest of the trunk
float32. "bf16": the trunk after the patch embed is bfloat16 too (the
inter-scale resamples and 1x1 convs round once, `layers.PointConv`).
Each level computes what the same JAX level computes in that mode:

    level 2  ln_mixer_head gives y1, x2 in bfloat16 (the mixer fed the
             float32 LN); window_attention(y1) gives x1 in bfloat16;
             block_tail writes x's dtype
    level 1  y = LN(x) in float32 (a bfloat16 x upcast); y1 rounded to
             bfloat16 for the local mixer, as the head stores it; the
             global mixer fed the float32 second half, its output x2
             rounded once to bfloat16 (`global_mixer(..., out_dtype=)`);
             the proj in float32 on the upcast [x1; x2], x + proj rounded
             to x's dtype (JAX promotes the "bf16" stream to float32
             there, ROADMAP C.36; the port keeps it bfloat16), ln_ffn in
             x's dtype. Under bf16res that is level 2's function, as
             JAX's B1 -> B2 -> B3 chain computes it (JAX's level-1 mirror
             off the TPU rounds the mixer's input instead; the port does
             not copy that, ROADMAP C.35)
    level 3  lgb_block in x's dtype, y1, x2, x1 rounded to bfloat16 where
             level 2 stores them: level 2's function (ROADMAP C.8)

The patch embed, the tail (on the upcast stream) and the residual add are
float32, and so is the output. A training forward (`module.training`)
runs float32 storage, as JAX's does; a bf16 eval forward that records a
gradient raises (the bf16 entries have no backward).

With `LGTEUN_FUSED_ATTENTION=v2` (`ops.windows_layout_attention`, read
when the method is built) levels 1 and 2 run the local mixer as the JAX
module path's `LocalMixer` does with that flag (`lgteun_tpu/models/
common/lgt.py:112-138`): partition into [N, C, S] windows,
`window_attention_windows`, unpartition. Level 3 ignores the flag.

Training (`module.train()` and a `generator`): the reference's
Dropout(drop_rate) after the mixer proj draws one mask per block from
the generator, on x's device, as `lgteun_tpu/models/lgteun_fast.py::
_lgb_cm` draws one per block from its rng (a different random stream:
torch's, not JAX's). At level 2 the mask goes into `block_tail_masked`;
at level 1 it multiplies the proj output in plain torch before
`ln_ffn`. Without a generator no mask is drawn (as the JAX path's
rng=None). The whole-block kernel has no backward and no mask, so level
3 runs level 2's chain whenever a gradient is recorded or a mask is
drawn. Every other wrapper is differentiable on the card (its kernel
forward with the plain version's backward, `ops.autograd`).

Selective `mixed_precision` training (`mixed`, bfloat16 when the config
sets `mixed_precision`; UnlgFormer's `handles_mixed`): a training forward
runs each block as the JAX flax module with `dtype=bf16` does
(`lgteun_tpu/models/common/lgt.py:113-118, 205-212, 266-269`), whatever
the level: the float32 LN; the local half as JAX's bf16-operand
composition (`window_attention_mixed`); the global half float32 through
`global_mixer`, B4's training entry (its function is the float32
mixer's, so a card runs the kernel, not a plain version); the proj on
bf16 operands (`layers.point_conv_mixed`); the dropout in bfloat16 (x /
keep where kept, as flax's `Dropout`); the float32 residual; then the
LN-FFN on bf16 operands (`ln_ffn_mixed`). No kernel computes the local
half, the proj or the LN-FFN in that form in either package (JAX routes
mixed training away from its float32 kernels), so those three are plain
torch by design. The patch embed, the resamples, the inter-scale convs
and the tail stay float32. The eval forward is the float32 one.

The JAX fast path also tests shapes for the TPU's lanes (H*W % 128,
W % 128, window-pair parity: `lgteun_tpu/models/lgteun_fast.py:251,
273, 315, 347-355`), leaves the mixer to XLA at level 1 and has a level
0 without kernels; here every kernel takes every shape of the path and
levels below 1 read as 2, so no plain version runs on a card (on a CPU
tensor every wrapper runs its plain version). The LN and the 1x1 proj
of level 1 are plain torch, as `_ln_cm` / `_pointconv_cm` are plain XLA
in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.common.layers import (
    ChannelLayerNorm,
    Conv,
    DepConv,
    PointConv,
    Resample,
    point_conv_mixed,
    trunc_normal_,
)
from lgteun_tpu_torch.ops import upcast
from lgteun_tpu_torch.ops.ffn_kernel import (block_tail, block_tail_masked,
                                             ln_ffn, ln_ffn_mixed)
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block
from lgteun_tpu_torch.ops.norm import channel_layer_norm
from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                  ln_mixer_head)
from lgteun_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_mixed,
                                                   window_attention_windows,
                                                   window_partition,
                                                   window_unpartition)

__all__ = ["LocalMixer", "GlobalMixer", "LGMixer", "FeedForward", "LGB",
           "LGT"]


class LocalMixer(nn.Module):
    """8x8-window MHSA with a learned [1, heads, S, S] position bias
    (reference LGT.py:112-146)."""

    def __init__(self, ch: int, win: int = 8, heads: int = 2):
        super().__init__()
        self.win, self.heads = win, heads
        s = win * win
        self.pos_emb = nn.Parameter(torch.empty(1, heads, s, s))
        self.to_qkv = PointConv(ch, 3 * ch)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pos_emb, std=1.0, a=-2.0, b=2.0,
                      generator=generator)


class GlobalMixer(nn.Module):
    """Per-channel affine on FFT amplitude and phase: the reference's
    1x1 depthwise conv_amp / conv_pha (reference LGT.py:149-180). Its
    computation runs inside `ln_mixer_head`, `global_mixer` or
    `lgb_block`."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv_amp = nn.Sequential(Conv(ch, ch, 1, groups=ch))
        self.conv_pha = nn.Sequential(Conv(ch, ch, 1, groups=ch))

    def affine(self):
        """(amp_w, amp_b, pha_w, pha_b), each [C]."""
        a, p = self.conv_amp[0], self.conv_pha[0]
        return a.weight.view(-1), a.bias, p.weight.view(-1), p.bias


class LGMixer(nn.Module):
    """Half-channel local/global split and the 1x1 proj (reference
    LGT.py:183-219)."""

    def __init__(self, ch: int, win: int = 8, heads: int = 2):
        super().__init__()
        self.local_mixer = LocalMixer(ch // 2, win, heads)
        self.global_mixer = GlobalMixer(ch // 2)
        self.proj = PointConv(ch, ch)


class _DepthwiseConv(nn.Module):
    """point conv then depthwise 3x3 (reference `depthwise_conv`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.point_conv = PointConv(in_ch, out_ch)
        self.depth_conv = DepConv(out_ch, 3)


class FeedForward(nn.Module):
    """point(4x) -> GELU -> point+depthwise -> GELU -> point
    (reference LGT.py:91-109). Its computation runs inside `block_tail`,
    `ln_ffn` or `lgb_block`."""

    def __init__(self, ch: int, ratio: int = 4):
        super().__init__()
        self.net = nn.Sequential(PointConv(ch, ch * ratio), nn.GELU(),
                                 _DepthwiseConv(ch * ratio, ch * ratio),
                                 nn.GELU(), PointConv(ch * ratio, ch))


class _PreNorm(nn.Module):
    def __init__(self, ch: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(ch)
        self.fn = fn


class _Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class _Views(dict):
    """Block index -> `LGB._block_params(i)`. A copy or a pickle of the
    module starts empty: its views would be of the old parameters."""

    def __reduce__(self):
        return type(self), ()


class LGB(nn.Module):
    """num_blocks x [x += mixer(LN(x)); x += ffn(LN(x))]
    (reference LGT.py:222-248), each block as `level` says (module
    docstring)."""

    def __init__(self, ch: int, num_blocks: int, win: int = 8,
                 heads: int = 2, level: int = 2, drop_rate: float = 0.1,
                 windows: bool = False, mixed: torch.dtype | None = None):
        super().__init__()
        self.win, self.heads, self.level = win, heads, level
        self.drop_rate, self.windows, self.mixed = drop_rate, windows, mixed
        self.blocks = nn.ModuleList(
            nn.ModuleList([
                _Residual(_PreNorm(ch, LGMixer(ch, win, heads))),
                _Residual(_PreNorm(ch, FeedForward(ch))),
            ]) for _ in range(num_blocks))
        self._views = _Views()

    def _apply(self, fn, *args, **kwargs):
        self._views.clear()     # .to(), .double() replace the weights' data
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._views.clear()     # load_state_dict(assign=True) replaces them
        super()._load_from_state_dict(*args, **kwargs)

    def _params(self, i: int) -> dict:
        """`_block_params(i)`, made once while gradients are off (views
        made then carry no autograd history); in-place weight updates
        (load_state_dict, init) show through the views."""
        if torch.is_grad_enabled():
            return self._block_params(i)
        blk = self._views.get(i)
        if blk is None:
            blk = self._views[i] = self._block_params(i)
        return blk

    def _block_params(self, i: int) -> dict:
        """Block i's weights as the kernels take them (`lgb_block`'s
        `blk`): views of the parameters, no copies."""
        mix_res, ffn_res = self.blocks[i]
        norm, mixer = mix_res.fn.norm, mix_res.fn.fn
        ffn_norm, net = ffn_res.fn.norm, ffn_res.fn.fn.net
        c, c4 = norm.weight.shape[0], net[0].weight.shape[0]
        c2 = c // 2
        local = mixer.local_mixer
        amp_w, amp_b, pha_w, pha_b = mixer.global_mixer.affine()
        return {"ln_w": norm.weight, "ln_b": norm.bias, "amp_w": amp_w,
                "amp_b": amp_b, "pha_w": pha_w, "pha_b": pha_b,
                "wqkv": local.to_qkv.weight.view(3 * c2, c2),
                "bqkv": local.to_qkv.bias, "pos": local.pos_emb[0],
                "proj_w": mixer.proj.weight.view(c, c),
                "proj_b": mixer.proj.bias,
                "ffn": {"ln_w": ffn_norm.weight, "ln_b": ffn_norm.bias,
                        "w1": net[0].weight.view(c4, c), "b1": net[0].bias,
                        "w2": net[2].point_conv.weight.view(c4, c4),
                        "b2": net[2].point_conv.bias,
                        "dw": net[2].depth_conv.weight.view(c4, 3, 3),
                        "bdw": net[2].depth_conv.bias,
                        "w3": net[4].weight.view(c, c4),
                        "b3": net[4].bias}}

    def _local_mixer(self, y1: torch.Tensor, blk: dict) -> torch.Tensor:
        attn = (blk["wqkv"], blk["bqkv"], blk["pos"], self.heads)
        if not self.windows:
            return window_attention(y1, *attn, self.win)
        h, w = y1.shape[-2:]
        out = window_attention_windows(window_partition(y1, self.win), *attn)
        return window_unpartition(out, self.win, h, w)

    def _drop_mask(self, x: torch.Tensor, generator):
        """The block's dropout mask [B, C, H, W] (0 or 1/keep), or None
        outside training, at rate 0 or without a generator."""
        if not (self.training and self.drop_rate > 0
                and generator is not None):
            return None
        keep = 1.0 - self.drop_rate
        draw = torch.rand(x.shape, generator=generator, device=x.device)
        return (draw < keep).to(x.dtype) * (1.0 / keep)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                storage: torch.dtype | None = None) -> torch.Tensor:
        """x in the stream's dtype (float32, or bfloat16 in the "bf16"
        mode); `storage`: the mixer branches' dtype (bfloat16 in either
        bf16 mode, else None: x's)."""
        heads, win = self.heads, self.win
        for i, (mix_res, _) in enumerate(self.blocks):
            eps = mix_res.fn.norm.eps
            blk = self._params(i)
            mixer = [blk[k] for k in ("amp_w", "amp_b", "pha_w", "pha_b")]
            mask = self._drop_mask(x, generator)
            if self.mixed is not None and self.training:
                x = self._mixed_block(x, blk, mask, eps)
            elif (self.level >= 3 and mask is None
                    and not torch.is_grad_enabled()):
                x = lgb_block(x, blk, heads, win, eps, storage)
            elif self.level == 1:
                y = channel_layer_norm(upcast(x), blk["ln_w"], blk["ln_b"],
                                       eps)
                c2 = x.shape[1] // 2
                y1 = y[:, :c2] if storage is None else y[:, :c2].to(storage)
                x1 = self._local_mixer(y1.contiguous(), blk)
                x2 = global_mixer(y[:, c2:].contiguous(), *mixer,
                                  out_dtype=storage)
                mixed = F.conv2d(upcast(torch.cat([x1, x2], dim=1)),
                                 blk["proj_w"][:, :, None, None],
                                 blk["proj_b"])
                x = (upcast(x) + (mixed if mask is None else mixed * mask)
                     ).to(x.dtype)
                x = ln_ffn(x, blk["ffn"], eps=eps)
            else:
                y1, x2 = ln_mixer_head(x, blk["ln_w"], blk["ln_b"], *mixer,
                                       eps=eps, out_dtype=storage)
                x1 = self._local_mixer(y1, blk)
                tail = (blk["proj_w"], blk["proj_b"], blk["ffn"])
                x = (block_tail(x, x1, x2, *tail, eps=eps) if mask is None
                     else block_tail_masked(x, x1, x2, mask, *tail, eps=eps))
        return x

    def _mixed_block(self, x: torch.Tensor, blk: dict, mask, eps: float):
        """One block of selective `mixed_precision` training on the
        float32 stream x (module docstring): the local half, the proj
        and the LN-FFN run JAX's bf16-operand compositions, which no
        kernel computes; the global half runs B4."""
        dt, c2 = self.mixed, x.shape[1] // 2
        y = channel_layer_norm(x, blk["ln_w"], blk["ln_b"], eps)
        x1 = window_attention_mixed(y[:, :c2], blk["wqkv"], blk["bqkv"],
                                    blk["pos"], self.heads, self.win, dt)
        x2 = global_mixer(y[:, c2:].contiguous(), blk["amp_w"],
                          blk["amp_b"], blk["pha_w"], blk["pha_b"])
        mixed = point_conv_mixed(torch.cat([x1.float(), x2], dim=1),
                                 blk["proj_w"][:, :, None, None],
                                 blk["proj_b"], dt)
        if mask is not None:
            mixed = torch.where(mask != 0, mixed / (1.0 - self.drop_rate),
                                torch.zeros_like(mixed))
        return ln_ffn_mixed(x + mixed.float(), blk["ffn"], eps, dt)


class _PatchEmbed(nn.Module):
    """depthwise 1x1 + point conv + channel LN (reference LGT.py:64-88,
    patch_size 1)."""

    def __init__(self, in_ch: int, embed: int):
        super().__init__()
        self.proj = nn.Sequential(Conv(in_ch, in_ch, 1, groups=in_ch),
                                  PointConv(in_ch, embed))
        self.norm = ChannelLayerNorm(embed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class LGT(nn.Module):
    """U-shaped local-global transformer (reference LGT.py:251-344):
    [B, in_ch, H, W] -> [B, in_ch, H, W] with a residual add."""

    def __init__(self, in_ch: int, embed: int, win: int = 8,
                 num_block: Sequence[int] = (2, 1), heads: int = 2,
                 level: int = 2, drop_rate: float = 0.1,
                 windows: bool = False, storage: tuple = (None, False),
                 mixed: torch.dtype | None = None):
        super().__init__()
        self.storage = storage   # (sdtype, res_f32): ops.storage_dtype
        self.patch_embed = _PatchEmbed(in_ch, embed)
        scales = len(num_block)
        lgb = lambda c, n: LGB(c, n, win, heads, level, drop_rate, windows,
                               mixed)
        ch = embed
        enc = []
        for i in range(scales - 1):
            enc.append(nn.ModuleList([
                lgb(ch, num_block[i]),
                nn.Sequential(Resample(0.5), PointConv(ch, ch * 2))]))
            ch *= 2
        self.encoder_layers = nn.ModuleList(enc)
        self.bottleneck = lgb(ch, num_block[-1])
        dec = []
        for i in range(scales - 1):
            dec.append(nn.ModuleList([
                nn.Sequential(Resample(2), PointConv(ch, ch // 2)),
                PointConv(ch, ch // 2),
                lgb(ch // 2, num_block[scales - 2 - i])]))
            ch //= 2
        self.decoder_layers = nn.ModuleList(dec)
        self.tail = nn.Sequential(Resample(1), PointConv(embed, in_ch))

    def forward(self, z: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        sdtype, res_f32 = (None, False) if self.training else self.storage
        if sdtype is not None and torch.is_grad_enabled() and (
                z.requires_grad
                or any(p.requires_grad for p in self.parameters())):
            raise RuntimeError(
                "LGT: bf16 storage (LGTEUN_EVAL_DTYPE) is an eval mode "
                "without a backward: run the eval forward with gradients "
                "off (torch.no_grad / inference_mode); training runs "
                "float32 storage")
        fea = self.patch_embed(z)
        if sdtype is not None and not res_f32:
            fea = fea.to(sdtype)
        skips = []
        for lgb, down in self.encoder_layers:
            fea = lgb(fea, generator, sdtype)
            skips.append(fea)
            fea = down(fea)
        fea = self.bottleneck(fea, generator, sdtype)
        for up, fuse, lgb in self.decoder_layers:
            fea = fuse(torch.cat([up(fea), skips.pop()], dim=1))
            fea = lgb(fea, generator, sdtype)
        return self.tail(upcast(fea)) + z
