"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from `lgteun_tpu_torch/csrc` with nvcc,
holds each kernel against its plain PyTorch version at the main paths'
shapes (and the scene engine's three LGB kernels at 144^2 / 72^2; the
window attention also in its [N, C, S] and [N*S, C] layouts, the block
tail also with a seeded dropout mask), holds the differentiable wrappers'
forward and gradients (kernel forward, recompute backward) against plain
autograd on the card, then drives each ported eval path through
`Runner.test` at its config's eval batch size, with random weights from
a seed:

- UnlgFormer (LGTEUN, WV-3, 8 bands, K=2): three kernels per LGB block
  (LGTEUN_FUSE_LEVEL 2, the default), then again at level 1 (window
  attention, the global mixer and LN + FFN per block), at level 3 (the
  whole block in one kernel) and with LGTEUN_FUSED_ATTENTION=v2 (the
  window attention on [N, C, S] windows);
- lightnet (WV-3, 8 bands): the SpanConv stack kernel;
- MDCUN (WV-3, 8 bands, T=4): the neighbourhood-attention kernel;
- INNT (WV-3, 8 bands, n_feat 8): the texture-match kernel, and in a
  second pass with LGTEUN_FUSED_TM=0 the patch-match kernel.

Then the whole-scene engine (`parallel.scene.fuse_scene`, UnlgFormer at
level 2, batch 32) on a seeded synthetic WV-3 scene (PAN 1024x1024,
LrMS 256x256x8, 11-bit DN) at tile 128 / halo 16 and tile 144 / halo 8:
tiles, kernel launches per tile forward, MP/s, and the card against the
CPU plain path on a 256^2 and a 272^2 crop at batch 32; and the CLI
(`python -m lgteun_tpu_torch.fuse`) once on that scene's TIFFs, written
under `build/`, against a direct `fuse_scene` call.

Then the training path: a seeded synthetic WV-3 Wald dataset written
under `build/chip_smoke/` with the port's `make_synthetic_dataset` and
read back with `PSDataset`, and `Runner.init().set_optim().train()` on
the shipped UnlgFormer config (Adam lr 1.5e-3, StepLR, l1, batch 4,
dropout 0.1) for TRAIN_ITERS iterations: the logged l1 loss (finite,
lower at the end), kernel launches per training forward (the masked
block tail in place of the plain one; never the whole-block kernel),
step time and images/s at batch 4 and 16, a checkpoint saved and resumed
against the uninterrupted run, one drop-0 step's loss and every
gradient on the card against the CPU plain path (with a split line),
and a few training steps at level 1, level 3 and with
LGTEUN_FUSED_ATTENTION=v2.

For each path it checks that every forward went through its kernels
(and launched no other), that the output agrees with a CPU run of the
plain path, and times batch-1 latency and batch-16 throughput. It also
prints where the card-vs-CPU difference of each path comes from: the
card with the kernels, the card on the kernels' plain versions and the
CPU plain path, each against a float64 run of the CPU plain path.

The two INNT searches pick, per query, the first maximum of a
similarity; a query whose best value lies within 1e-5 of the next lower
one (a near tie, found in float64 on the card) may pick another
sub-patch in another summation order. Their transferred values are held
only outside the near ties' footprint, which must stay under 1 % of the
output; the count is printed.

For each kernel the JSON line gives its time, its plain version's time,
its bound (the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s,
the H100 SXM's published HBM and FP32 rates at 700 W) and the time of
one PyTorch call that computes the same function, where there is one.

`--profile` adds a torch.profiler (CUPTI) pass over a few forwards of
each path at batch 1 and at the eval batch, and over a few training
steps at batch 4 and 16: device kernels per call, device busy time,
idle share and each device kernel's share of the busy time.

Any failed phase raises (non-zero exit). With no CUDA device the script
exits non-zero before printing any result. The last line of stdout is
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit, and the one before that the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import importlib
import json
import logging
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "lgteun_tpu", "configs")
SEED = 19971118
KERNEL_BATCH = 4            # kernel checks at the main path's shapes
# (C, H=W) of the prior's LGB blocks: 4 full-res blocks, 1 bottleneck
BLOCK_SHAPES = ((32, 128), (64, 64))
KERNEL_REL_TOL = 1e-4       # max|kernel - plain| / max|plain|
NEAR_TIE = 1e-5             # float64 gap below a query's best similarity
NEAR_TIE_MAX_SHARE = 0.01   # of the transferred values a near tie may mask
PSNR_TOL_DB = 0.01          # INNT card vs CPU, only when a near tie flipped
N_IMAGES = 64
SCENE = 1024                # PAN side of the synthetic scene
SCENE_BATCH = 32
# (tile, halo, side of the crop compared with the CPU plain path)
SCENE_TILINGS = ((128, 16, 256), (144, 8, 272))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published, at 700 W
FP32_FLOPS_PER_S = 67e12    # H100 SXM FP32 outside the tensor cores
DROP_RATE = 0.1             # the kernel cases' dropout mask
# a differentiable wrapper vs plain autograd on the card: the backward is
# the same plain graph on the same saved inputs and the loss is linear in
# the outputs, so only the backward's own run-to-run order may differ
GRAD_REL_TOL = 1e-5         # max|grad - plain grad| / max|plain grad|
AUTOGRAD_SHAPES = ("4x32x128x128", "4x64x64x64", "4x16x128x128",
                   "4x32x64x64", "1024x16x64", "256x32x64")
TRAIN_IMAGES = 16           # synthetic WV-3 training pairs (and 4 test)
TRAIN_ITERS = 50
TRAIN_LOG = 10
TRAIN_TIMED = 20            # timed steps at each of TRAIN_BATCHES
TRAIN_BATCHES = (4, 16)
RESUME_STEPS = 5
# resumed vs uninterrupted: the first resumed step's loss must be equal
# (same weights, batch and dropout mask); after it the bicubic backward's
# unordered atomic adds change the last bits of the gradients, which
# Adam's normalised step can turn into O(lr) moves of parameters whose
# gradients are near zero: an H100 read 2.4e-4 here, and two resumed
# runs differ by as much (printed); a wrong restore of the moments moves
# the loss by far more.
RESUME_LOSS_REL = 1e-3
# card vs CPU plain, one drop-0 step on 2 images (run_grad_split): each
# gradient relative to its tensor's largest where that is at least
# GRAD_LEVEL of the largest of all; every tensor allclose with an atol of
# GRAD_ATOL times the largest of all (rounding-level tensors). float32
# itself reaches only about 1.4e-3 of float64 on the worst tensor (the
# first block's LN bias: a sum over every pixel with cancellation; an
# H100 read 1.2e-3 card vs CPU, 2.2e-3 card vs float64), so the bound
# leaves room for another summation order; a wrong gradient is off by
# O(1)
TRAIN_GRAD_TOL = 1e-2
GRAD_LEVEL = 1e-3
GRAD_ATOL = 1e-5
# the training forward at level 2 (and at level 3, which trains through
# level 2's chain): launches per forward
TRAIN_ROUTE = {"ln_mixer_head": 5, "window_attention": 5,
               "block_tail_masked": 5}

# name -> (module under lgteun_tpu_torch/ops holding the wrapper and its
# plain version, the model module that calls it, CUDA source, the TPU
# kernel it replaces, the shape whose times the JSON line reports, why
# no single PyTorch call computes the same function)
KERNELS = {
    "ln_mixer_head": ("spectral_kernel", "lgteun_tpu_torch.models.common.lgt",
                      "lgteun_tpu_torch/csrc/spectral_head.cu",
                      "lgteun_tpu/ops/spectral_kernel.py:281", "4x32x128x128",
                      "channel LN + split + FFT amp/phase mixer + irfft2 is "
                      "no single call"),
    "window_attention": ("window_attention",
                         "lgteun_tpu_torch.models.common.lgt",
                         "lgteun_tpu_torch/csrc/window_attention.cu",
                         "lgteun_tpu/ops/window_attention.py:274",
                         "4x32x128x128",
                         "qkv 1x1 conv + windowing + biased attention is no "
                         "single call"),
    "block_tail": ("ffn_kernel", "lgteun_tpu_torch.models.common.lgt",
                   "lgteun_tpu_torch/csrc/block_tail.cu",
                   "lgteun_tpu/ops/ffn_kernel.py:458", "4x32x128x128",
                   "proj + LN + 1x1/depthwise FFN with GELU is no single "
                   "call"),
    "block_tail_masked": ("ffn_kernel", "lgteun_tpu_torch.models.common.lgt",
                          "lgteun_tpu_torch/csrc/block_tail.cu",
                          "lgteun_tpu/ops/ffn_kernel.py:566", "4x32x128x128",
                          "proj + mask + LN + 1x1/depthwise FFN with GELU "
                          "is no single call"),
    "window_attention_windows": (
        "window_attention", "lgteun_tpu_torch.models.common.lgt",
        "lgteun_tpu_torch/csrc/window_attention.cu",
        "lgteun_tpu/ops/window_attention.py:172", "1024x16x64",
        "qkv 1x1 + biased attention is no single call"),
    "window_attention_rows": (
        "window_attention", "lgteun_tpu_torch.models.common.lgt",
        "lgteun_tpu_torch/csrc/window_attention.cu",
        "lgteun_tpu/ops/window_attention.py:425", "1024x64x16",
        "qkv 1x1 + biased attention is no single call"),
    "global_mixer": ("spectral_kernel", "lgteun_tpu_torch.models.common.lgt",
                     "lgteun_tpu_torch/csrc/spectral_head.cu",
                     "lgteun_tpu/ops/spectral_kernel.py:221",
                     "4x16x128x128",
                     "FFT + amp/phase affine + inverse FFT is no single "
                     "call"),
    "ln_ffn": ("ffn_kernel", "lgteun_tpu_torch.models.common.lgt",
               "lgteun_tpu_torch/csrc/block_tail.cu",
               "lgteun_tpu/ops/ffn_kernel.py:617", "4x32x128x128",
               "LN + a chain of 1x1/depthwise convs with GELU is no single "
               "call"),
    "lgb_block": ("lgb_block_kernel", "lgteun_tpu_torch.models.common.lgt",
                  "lgteun_tpu_torch/csrc/lgb_block.cu",
                  "lgteun_tpu/ops/lgb_block_kernel.py:286", "4x32x128x128",
                  "LN + FFT mixer + window attention + proj + the FFN's "
                  "convs is no single call"),
    "lightnet_stack": ("lightnet_kernel", "lgteun_tpu_torch.models.lightnet",
                       "lgteun_tpu_torch/csrc/lightnet.cu",
                       "lgteun_tpu/ops/lightnet_kernel.py:163", "4x9x128x128",
                       "a stack of 40 convs is no single call"),
    "neighborhood_attention": (
        "nonlocal_kernel", "lgteun_tpu_torch.models.mdcun",
        "lgteun_tpu_torch/csrc/neighborhood_attention.cu",
        "lgteun_tpu/ops/nonlocal_kernel.py:120", "4x8x128x128",
        "PyTorch has no neighbourhood attention call"),
    "texture_match": (
        "texture_match_kernel", "lgteun_tpu_torch.models.innt",
        "lgteun_tpu_torch/csrc/texture_match.cu",
        "lgteun_tpu/ops/texture_match_kernel.py:158", "1024x4x576",
        "unfold + norm + similarity argmax + gather + fold is no single "
        "call"),
    "patch_match": (
        "patch_match_kernel", "lgteun_tpu_torch.models.innt",
        "lgteun_tpu_torch/csrc/texture_match.cu",
        "lgteun_tpu/ops/patch_match_kernel.py:81", "1024x576x36",
        "similarity argmax + gather is no single call"),
}

# (config file, {kernel: launches per forward; every other kernel: 0},
#  card-vs-CPU max-abs bound, images of the CPU comparison, environment
#  of the method's build, images of the Runner.test run). The bounds:
# UnlgFormer the port's 5e-4 (ROADMAP.md); lightnet 1e-4, MDCUN 1e-3 and
# INNT 5e-4, those tests/test_torch_parity.py holds the JAX package to
# against the reference.
SLICES = (
    ("unlg_former.py", {"ln_mixer_head": 5, "window_attention": 5,
                        "block_tail": 5}, 5e-4, 2, {}, N_IMAGES),
    ("unlg_former.py", {"window_attention": 5, "global_mixer": 5,
                        "ln_ffn": 5}, 5e-4, 2, {"LGTEUN_FUSE_LEVEL": "1"},
     N_IMAGES),
    ("unlg_former.py", {"lgb_block": 5}, 5e-4, 2,
     {"LGTEUN_FUSE_LEVEL": "3"}, N_IMAGES),
    ("unlg_former.py", {"ln_mixer_head": 5, "window_attention_windows": 5,
                        "block_tail": 5}, 5e-4, 2,
     {"LGTEUN_FUSED_ATTENTION": "v2"}, N_IMAGES),
    ("lightnet.py", {"lightnet_stack": 3}, 1e-4, 2, {}, N_IMAGES),
    ("MDCUN.py", {"neighborhood_attention": 4}, 1e-3, 1, {}, N_IMAGES),
    ("INNT.py", {"texture_match": 1}, 5e-4, 1, {}, N_IMAGES),
    ("INNT.py", {"patch_match": 1}, 5e-4, 1, {"LGTEUN_FUSED_TM": "0"}, 16),
)


def kernel_fns(name: str):
    """(wrapper, plain version) of kernel `name`."""
    mod = importlib.import_module(f"lgteun_tpu_torch.ops.{KERNELS[name][0]}")
    return getattr(mod, name), getattr(mod, f"{name}_ref")


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got, want) -> tuple[float, float]:
    """(max|got - want| / max|want|, max|got - want|) over tensors."""
    rel, ab = 0.0, 0.0
    for g, w in zip(got, want):
        torch.cuda.synchronize()
        d = (g - w).abs().max().item()
        rel = max(rel, d / max(w.abs().max().item(), 1e-30))
        ab = max(ab, d)
    return rel, ab


def kernel_cases(gen: torch.Generator):
    """(name, wrapper, plain, args) per kernel and main-path shape."""
    from lgteun_tpu_torch.ops.ffn_kernel import (block_tail,
                                                 block_tail_masked,
                                                 block_tail_masked_ref,
                                                 block_tail_ref, ln_ffn,
                                                 ln_ffn_ref)
    from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block, lgb_block_ref
    from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                      global_mixer_ref,
                                                      ln_mixer_head,
                                                      ln_mixer_head_ref)
    from lgteun_tpu_torch.ops.window_attention import (
        window_attention, window_attention_ref, window_attention_rows,
        window_attention_rows_ref, window_attention_windows,
        window_attention_windows_ref, window_partition)

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    b = KERNEL_BATCH

    def lgb_args(c, hw):
        """The args of ln_mixer_head, window_attention, block_tail and
        the FFN weights for an LGB block of C channels at hw^2."""
        c2, c4 = c // 2, 4 * c
        head = (n(b, c, hw, hw), 1 + 0.1 * n(c), 0.1 * n(c), n(c2),
                0.1 * n(c2), n(c2), 0.1 * n(c2))
        attn = (n(b, c2, hw, hw), n(3 * c2, c2, scale=c2 ** -0.5),
                0.1 * n(3 * c2), n(2, 64, 64), 2, 8)
        ffn = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
               "w1": n(c4, c, scale=c ** -0.5), "b1": 0.1 * n(c4),
               "w2": n(c4, c4, scale=c4 ** -0.5), "b2": 0.1 * n(c4),
               "dw": n(c4, 3, 3, scale=1 / 3), "bdw": 0.1 * n(c4),
               "w3": n(c, c4, scale=c4 ** -0.5), "b3": 0.1 * n(c)}
        tail = (n(b, c, hw, hw), n(b, c2, hw, hw), n(b, c2, hw, hw),
                n(c, c, scale=c ** -0.5), 0.1 * n(c), ffn)
        return head, attn, ffn, tail

    for c, hw in BLOCK_SHAPES:
        shape = f"{b}x{c}x{hw}x{hw}"
        head, attn, ffn, tail = lgb_args(c, hw)
        yield "ln_mixer_head", shape, ln_mixer_head, ln_mixer_head_ref, head
        yield ("window_attention", shape, window_attention,
               window_attention_ref, attn)
        yield "block_tail", shape, block_tail, block_tail_ref, tail
        yield "ln_ffn", shape, ln_ffn, ln_ffn_ref, (tail[0], ffn)
        blk = dict(zip(("ln_w", "ln_b", "amp_w", "amp_b", "pha_w",
                        "pha_b"), head[1:]), wqkv=attn[1], bqkv=attn[2],
                   pos=attn[3], proj_w=tail[3], proj_b=tail[4], ffn=ffn)
        yield "lgb_block", shape, lgb_block, lgb_block_ref, (head[0], blk)
        yield ("global_mixer", f"{b}x{c // 2}x{hw}x{hw}", global_mixer,
               global_mixer_ref, (attn[0],) + head[3:])
        # the training tail with a seeded rate-0.1 dropout mask
        yield "block_tail_masked", shape, block_tail_masked, \
            block_tail_masked_ref, tail[:3] + (dropout_mask(tail[0]),) + \
            tail[3:]
        # the same windows as [N, C, S] (B6) and [N, S, C] (B7)
        xt = window_partition(attn[0], 8)
        xw = xt.transpose(1, 2).contiguous()
        yield ("window_attention_windows", "x".join(map(str, xt.shape)),
               window_attention_windows, window_attention_windows_ref,
               (xt,) + attn[1:5])
        yield ("window_attention_rows", "x".join(map(str, xw.shape)),
               window_attention_rows, window_attention_rows_ref,
               (xw,) + attn[1:5])
    # the scene engine's LGB sizes at tile 144: 144^2 (C 32), 72^2 (C 64),
    # each through the three kernels of its path (level 2)
    for c, hw in ((32, 144), (64, 72)):
        shape = f"{b}x{c}x{hw}x{hw}"
        head, attn, _ffn, tail = lgb_args(c, hw)
        yield "ln_mixer_head", shape, ln_mixer_head, ln_mixer_head_ref, head
        yield ("window_attention", shape, window_attention,
               window_attention_ref, attn)
        yield "block_tail", shape, block_tail, block_tail_ref, tail
    # and any even size: the shared-memory limit (168^2) and odd parts 5, 7
    for shape in ((b, 16, 72, 72), (1, 4, 168, 168), (2, 8, 40, 56)):
        c = shape[1]
        yield ("global_mixer", "x".join(map(str, shape)), global_mixer,
               global_mixer_ref, (n(*shape), n(c), 0.1 * n(c), n(c),
                                  0.1 * n(c)))
    # x = 0 and LN bias = 0: every frequency bin is exactly zero, which
    # takes the mixer's zero-bin path (amp = pha = 0) everywhere
    c, hw = BLOCK_SHAPES[0]
    zero = (torch.zeros(1, c, hw, hw).cuda(), 1 + 0.1 * n(c),
            torch.zeros(c).cuda(), n(c // 2), 0.1 * n(c // 2), n(c // 2),
            0.1 * n(c // 2))
    yield ("ln_mixer_head", f"1x{c}x{hw}x{hw}-zero", ln_mixer_head,
           ln_mixer_head_ref, zero)

    # LightNet's stack at 8 bands: x = pan + lms (9 channels), kaiming
    # weights, biases U(+-0.1) so that the border zeroing matters
    from lgteun_tpu_torch.ops.lightnet_kernel import (lightnet_layers,
                                                      lightnet_stack,
                                                      lightnet_stack_ref)
    bands, hw = 8, 128
    layers = []
    for _n, cin, cout, _r in lightnet_layers(bands):
        span = []
        for _branch in range(2):
            span += [n(cout, cin, 1, 1, scale=(2 / cout) ** 0.5),
                     0.1 * n(cout), n(cout, 1, 3, 3, scale=(2 / 9 / cout)
                                      ** 0.5), 0.1 * n(cout)]
        layers.append(tuple(span))
    lms = n(b, bands, hw, hw)
    x = torch.cat([n(b, 1, hw, hw), lms], dim=1)
    yield ("lightnet_stack", f"{b}x{bands + 1}x{hw}x{hw}", lightnet_stack,
           lightnet_stack_ref, (x, lms, layers))
    # MDCUN's blockNL at 8 bands, and one ragged shape for the borders
    from lgteun_tpu_torch.ops.nonlocal_kernel import (
        neighborhood_attention, neighborhood_attention_ref)
    for shape in ((b, bands, hw, hw), (1, bands, 72, 100)):
        na = (n(*shape),) + tuple(n(bands, bands, scale=bands ** -0.5)
                                  for _ in range(4)) + (15,)
        yield ("neighborhood_attention", "x".join(map(str, shape)),
               neighborhood_attention, neighborhood_attention_ref, na)

    # INNT's searches at batch 4 (N = 256 patch-images an image, C =
    # n_feat / 2 = 4, side 24); a quarter of the images get the zero rims
    # of PatchFusion's padded patches (zero sub-patches: exact ties)
    from lgteun_tpu_torch.ops.patch_match_kernel import (patch_match,
                                                         patch_match_ref)
    from lgteun_tpu_torch.ops.texture_match_kernel import (
        row_normalize, texture_match, texture_match_ref)

    def patch_images(nimg, c, side):
        x = n(nimg, c, side, side)
        x[: nimg // 4, :, :8] = 0
        x[: nimg // 4, :, :, :8] = 0
        return x.reshape(nimg, c, side * side)

    nimg, c, side = 256 * b, 4, 24
    yield ("texture_match", f"{nimg}x{c}x{side * side}", texture_match,
           texture_match_ref, (patch_images(nimg, c, side),
                               patch_images(nimg, c, side)))
    yield ("texture_match", "64x8x64", texture_match, texture_match_ref,
           (n(64, 8, 64), n(64, 8, 64)))
    yield ("texture_match", "64x4x576-tie", texture_match, texture_match_ref,
           (n(64, 4, 576), torch.full((64, 4, 576), 0.37).cuda()))
    unf = lambda v: F.unfold(v.view(nimg, c, side, side), 3, padding=1)
    lr_u, ref_u = unf(patch_images(nimg, c, side)), unf(patch_images(
        nimg, c, side))
    pm = (row_normalize(lr_u, 1).transpose(1, 2).contiguous(),
          row_normalize(ref_u, 1).transpose(1, 2).contiguous(), ref_u)
    yield ("patch_match", f"{nimg}x{side * side}x{9 * c}", patch_match,
           patch_match_ref, pm)
    # every ref row equal: T must be ref_u's first column everywhere
    tie = (pm[0][:64], pm[1][:64, :1].expand(-1, side * side, -1)
           .contiguous(), pm[2][:64])
    yield ("patch_match", "64x576x36-tie", patch_match, patch_match_ref, tie)


def near_ties(lr_n, ref_n) -> torch.Tensor:
    """[N, L] bool: queries whose best float64 similarity lies within
    NEAR_TIE of the best value below it (rows of lr_n / ref_n [N, L, K]
    are sub-patch vectors). Refs tied exactly at the best value are one
    value: identical sub-patches give bit-equal similarities in every
    implementation, and the first of them is taken."""
    out = []
    for i in range(0, lr_n.shape[0], 256):
        r = torch.bmm(ref_n[i:i + 256].double(),
                      lr_n[i:i + 256].double().transpose(1, 2))
        best = r.max(dim=1, keepdim=True).values
        below = r.masked_fill(r == best, -torch.inf).max(dim=1).values
        out.append(best[:, 0] - below <= NEAR_TIE)
    return torch.cat(out)


def search_inputs(name: str, args):
    """(lr_n, ref_n) [N, L, K] in float64 of a search kernel's args."""
    from lgteun_tpu_torch.ops.texture_match_kernel import row_normalize
    if name == "patch_match":
        return args[0].double(), args[1].double()
    lr, ref = args
    n, c, q = lr.shape
    side = int(round(q ** 0.5))
    unf = lambda v: row_normalize(F.unfold(v.double().view(n, c, side, side),
                                           3, padding=1), 1).transpose(1, 2)
    return unf(lr), unf(ref)


def near_tie_mask(name: str, args, out) -> tuple[torch.Tensor, int]:
    """(mask of the transferred values a near tie may change, the number
    of near-tie queries): for texture_match the 3x3 fold footprint of
    each near tie, for patch_match its column."""
    near = near_ties(*search_inputs(name, args))
    if name == "texture_match":
        n, c, q = out.shape
        side = int(round(q ** 0.5))
        foot = F.max_pool2d(
            near.view(n, 1, side, side).float(), 3, stride=1, padding=1) > 0
        mask = foot.view(n, 1, q).expand(n, c, q)
    else:
        mask = near[:, None, :].expand_as(out)
    return mask, int(near.sum())


def check_search(name: str, shape: str, got, want, args) -> tuple[float,
                                                                  float]:
    """Hold a search kernel's (t, s) against its plain version: s within
    KERNEL_REL_TOL relative everywhere, t outside the near ties'
    footprint, which must stay under NEAR_TIE_MAX_SHARE; on the tie
    cases t exactly (the same picks). Returns (rel err, max-abs err)."""
    mask, n_near = near_tie_mask(name, args, want[0])
    keep = ~mask
    t_err = ((got[0] - want[0]).abs() * keep).max().item()
    t_rel = t_err / max(want[0].abs().max().item(), 1e-30)
    s_rel, s_err = rel_err(got[1:], want[1:])
    masked = int(mask.sum())
    print(f"kernel {name:17s} {shape:14s} near-tie queries {n_near}, masked "
          f"transferred values {masked} of {want[0].numel()}")
    if masked > NEAR_TIE_MAX_SHARE * want[0].numel():
        raise AssertionError(f"{name} {shape}: {masked} masked values, over "
                             f"{NEAR_TIE_MAX_SHARE:.0%} of the output")
    if shape.endswith("-tie"):
        if name == "texture_match":
            # bit-equal to the CPU plain version, whose fold sums in the
            # kernel's (ky, kx) order (F.fold on the card sums in
            # another, 1 ulp apart); another pick would move a value by
            # a multiple of 0.37 / 9
            exact = kernel_fns(name)[1](*(a.cpu() for a in args))[0].cuda()
        else:   # every ref row equal: the first ref everywhere
            exact = args[2][:, :, :1].expand_as(got[0])
        if not torch.equal(got[0] * keep, exact * keep):
            raise AssertionError(f"{name} {shape}: exact-tie case differs")
    return max(t_rel, s_rel), max(t_err, s_err)


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) tuple, list or dict."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(o) for o in obj)
    return 0


def kernel_flops(name: str, args) -> float:
    """Floating-point operations (a multiply-add counts 2) of one call,
    from its shapes: what the algorithm needs, not what the kernel
    recomputes."""
    x = args[0]
    if name in ("ln_mixer_head", "global_mixer"):
        b, c, h, w = x.shape
        planes, n = (b * c // 2, h * w) if name == "ln_mixer_head" else (
            b * c, h * w)
        # LN ~8 an element (head only); rfft2 + irfft2 5 N log2 N a
        # plane; the amp/phase mixer ~20 a frequency bin
        return (8 * x.numel() if name == "ln_mixer_head" else 0) + planes * (
            5 * n * np.log2(n) + 20 * h * (w // 2 + 1))
    if name.startswith("window_attention"):
        if name == "window_attention":
            b, c2, h, w = x.shape
            tokens, heads, s = b * h * w, args[4], args[5] ** 2
        else:   # [N, C, S] or [N, S, C] windows
            n, c2, s = (x.shape if name.endswith("windows")
                        else (x.shape[0], x.shape[2], x.shape[1]))
            tokens, heads = n * s, args[4]
        # qkv 1x1; q.k and att.v over the window; bias, max, exp, sum, div
        return tokens * (6 * c2 * c2 + 4 * s * c2 + 5 * s * heads)
    if name in ("block_tail", "block_tail_masked", "ln_ffn"):
        b, c, h, w = x.shape
        c4 = 4 * c
        # (proj (and mask),) LN, w1, w2, depthwise 3x3, erf GELU (~10),
        # w3, residuals
        proj = {"block_tail": 2 * c * c + c, "block_tail_masked":
                2 * c * c + 2 * c, "ln_ffn": 0}[name]
        return b * h * w * (proj + 8 * c + 2 * c * c4 + 2 * c4 * c4
                            + 18 * c4 + 10 * c4 + 2 * c4 * c + c)
    if name == "lgb_block":
        b, c, h, w = x.shape
        c2 = c // 2
        # the three stages of the block on their own tensors
        return (kernel_flops("ln_mixer_head", (x,))
                + kernel_flops("window_attention",
                               (x[:, :c2], None, None, None, 2, 8))
                + kernel_flops("block_tail", (x,)))
    if name == "lightnet_stack":
        from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_layers
        b, _, h, w = x.shape
        per_px = sum(2 * (2 * cin * cout + 18 * cout + 2 * cout) + 2 * cout
                     for _n, cin, cout, _r in lightnet_layers(
                         args[1].shape[1]))
        return b * h * w * (per_px + args[1].shape[1])
    if name == "neighborhood_attention":
        b, c, h, w = x.shape
        fs2 = args[5] ** 2
        # four 1x1 projections; per offset a dot, an exp, a scaled add
        return b * h * w * (8 * c * c + fs2 * (4 * c + 4))
    if name == "texture_match":
        nimg, c, q = x.shape
        k = 9 * c
        # unfold norms, R, the max over the ref axis, the fold
        return nimg * (2 * 3 * k * q + 2 * q * q * k + q * q + 10 * c * q)
    if name == "patch_match":
        nimg, ll, k = x.shape
        return nimg * (2 * ll * ll * k + ll * ll)
    raise KeyError(name)


def bound(name: str, args, outs) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): each
    input read once and each output written once at the HBM rate, or
    the operations at the FP32 rate, whichever is longer."""
    by_bytes = (tensor_bytes(args) + tensor_bytes(outs)) / HBM_BYTES_PER_S
    by_ops = kernel_flops(name, args) / FP32_FLOPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


@contextlib.contextmanager
def swapped_kernels(names, replace):
    """In the models that call kernels `names`, call `replace(name, fn)`
    in place of each kernel's wrapper `fn` for the block."""
    saved = []
    try:
        for name in names:
            user = importlib.import_module(KERNELS[name][1])
            saved.append((user, name, getattr(user, name)))
            setattr(user, name, replace(name, getattr(user, name)))
        yield
    finally:
        for user, name, fn in saved:
            setattr(user, name, fn)


def float64_forward(method, batch: dict) -> torch.Tensor:
    """The CPU plain path in float64 on a copy of `method`'s weights."""
    module = copy.deepcopy(method.module).double()
    nchw = lambda a: torch.from_numpy(np.asarray(a, np.float64)).permute(
        0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        return module(nchw(batch["input_lr"]),
                      nchw(batch["input_pan"])).permute(0, 2, 3, 1)


def device_profile(call, n: int = 5) -> dict:
    """torch.profiler over `n` synchronised calls of `call` (a forward,
    or a whole scene): device kernels and copies per call, device busy
    ms per call (union of the device intervals), idle share (1 - busy /
    host wall of the loop, profiler on) and the top device kernels'
    shares of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
    total = sum(by_name.values())
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    return {"kernels_per_call": (len(dev) - copies) / n,
            "copies_per_call": copies / n,
            "busy_ms_per_call": busy / n / 1e3,
            "wall_ms_per_call": wall_us / n / 1e3,
            "idle_share": 1 - busy / wall_us,
            "top": [(name[:100], t / total)
                    for name, t in by_name.most_common(10)]}


class SceneDataset:
    """Seeded WV-3-shaped items in 11-bit DN: a smooth 8-band target
    [128,128,8], its 4x4 block mean as input_lr [32,32,8] and its band
    mean as input_pan [128,128,1]."""

    def __init__(self, n: int, bands: int, seed: int):
        rng = np.random.default_rng(seed)
        coarse = rng.uniform(200, 1800, (n, 16, 16, bands))
        fine = rng.normal(0, 40, (n, 128, 128, bands))
        target = np.clip(np.repeat(np.repeat(coarse, 8, 1), 8, 2) + fine,
                         0, 2047).astype(np.float32)
        lr = target.reshape(n, 32, 4, 32, 4, bands).mean(axis=(2, 4))
        pan = target.mean(axis=-1, keepdims=True)
        self.items = [{"input_lr": lr[i].astype(np.float32),
                       "input_pan": pan[i].astype(np.float32),
                       "target": target[i]} for i in range(n)]
        self.pairs = [(f"scene{i:03d}",) for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass of each path at batch 1 "
                         "and the eval batch")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lgteun_tpu_torch.ops import _cuda

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s")
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(sh(_cuda.find_nvcc(), "--version").splitlines()[-1])
    print(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _cuda.build_library()
    _cuda.kernels()
    print(f"build: {lib_path.name} ({' '.join(_cuda.NVCC_FLAGS)}) "
          f"in {time.perf_counter() - t0:.1f} s")

    # 2. each kernel vs its plain version (TF32 off for the plain convs
    #    and matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    record = {}
    for name, shape, kernel, plain, args in kernel_cases(gen):
        got, want = kernel(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if name in ("texture_match", "patch_match"):
            rel, ab = check_search(name, shape, got, want, args)
        else:
            rel, ab = rel_err(got, want)
        ms, plain_ms = in_turns(lambda: plain(*args), lambda: kernel(*args))
        bound_ms, bound_by = bound(name, args, want)
        print(f"kernel {name:17s} {shape:14s} rel err {rel:.3e} "
              f"(max-abs {ab:.3e})  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}; "
              f"roofline share {bound_ms / ms:.3f})")
        if not rel <= KERNEL_REL_TOL:
            raise AssertionError(f"{name} {shape}: rel err {rel:.3e} > "
                                 f"{KERNEL_REL_TOL}")
        rec = record.setdefault(name, {"max_abs_err": 0.0, "by_shape": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        rec["by_shape"][shape] = {"rel_err": rel, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by}

    # 3. the differentiable wrappers against plain autograd
    run_autograd(torch.Generator().manual_seed(SEED + 2))

    # 4. each slice: shipped config, seeded weights, Runner.test
    #    (a kernel's launches are those of the first path that runs it)
    launches = {}
    for config, per_forward, abs_tol, n_cmp, env, n_images in SLICES:
        counted = run_slice(os.path.join(CONFIGS, config), per_forward,
                            abs_tol, n_cmp, env, n_images, card,
                            opts.profile)
        for k in per_forward:
            launches.setdefault(k, counted[k])

    # 5. the scene engine, then the CLI on the same scene
    method = run_scene(card, opts.profile)
    run_cli(method, card)

    # 6. training: Runner.train on a synthetic dataset, resume, card vs
    #    CPU gradients, the other routes' training steps
    train_ds, counted = run_training(card, opts.profile)
    launches["block_tail_masked"] = counted["block_tail_masked"]
    launches.setdefault("window_attention_rows", 0)   # on no model path
    run_grad_split(train_ds, card)
    run_train_variants(train_ds, card)

    kernels = []
    for name, (_op, _user, src, replaces, main_shape, no_library) in \
            KERNELS.items():
        rec = record[name]
        full = rec["by_shape"][main_shape]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": full["ms"], "plain_ms": full["plain_ms"],
                        "bound_ms": full["bound_ms"],
                        "bound_by": full["bound_by"], "library_ms": None,
                        "library": f"none: {no_library}",
                        "by_shape": rec["by_shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dropout_mask(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """A seeded rate-DROP_RATE dropout mask of x's shape (0 or 1/keep)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = 1.0 - DROP_RATE
    return (torch.rand(x.shape, generator=gen, device=x.device) < keep).to(
        x.dtype) * (1.0 / keep)


def synthetic_scene(side: int, bands: int, seed: int):
    """A seeded WV-3-shaped scene in 11-bit DN: a smooth 8-band target
    (a 32-pixel grid of band levels plus N(0, 40) texture), its 4x4
    block mean as LrMS [side/4, side/4, bands] and its band mean as PAN
    [side, side]; float32."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(200, 1800, (side // 32, side // 32, bands))
    target = np.repeat(np.repeat(coarse, 32, 0), 32, 1) + rng.normal(
        0, 40, (side, side, bands))
    target = np.clip(target, 0, 2047).astype(np.float32)
    lr = target.reshape(side // 4, 4, side // 4, 4, bands).mean(axis=(1, 3))
    return lr.astype(np.float32), target.mean(axis=-1).astype(np.float32)


def unlgformer(device: str):
    """UnlgFormer of the shipped WV-3 config at fuse level 2."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.registry import build_model
    cfg = load_config(os.path.join(CONFIGS, "unlg_former.py"))
    with mock.patch.dict(os.environ, {"LGTEUN_FUSE_LEVEL": "2"}):
        return cfg, build_model(cfg.model_type, cfg, device=device)


def print_profile(tag: str, prof: dict, card: str) -> None:
    top = "; ".join(f"{share:.3f} {name}" for name, share in prof.pop("top"))
    print(f"profile {tag}: " + "  ".join(f"{k} {v:.4g}" for k, v in
                                         prof.items()) + f"  [{card}]")
    print(f"profile {tag} top device kernels: {top}")


def run_scene(card: str, profile: bool):
    """The whole-scene engine on the card at each of SCENE_TILINGS (and
    a profiler pass of each with `profile`); returns the card's method
    (seeded weights)."""
    from lgteun_tpu_torch.parallel.scene import fuse_scene
    from lgteun_tpu_torch.runner import Runner

    cfg, method = unlgformer("cuda")
    Runner(cfg, method, "cuda").init(SEED)
    _, cpu = unlgformer("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    scale = 2.0 ** cfg.bit_depth - 0.5
    lr, pan = synthetic_scene(SCENE, cfg.ms_chans, SEED)
    lr, pan = lr / scale, pan / scale
    lr_d, pan_d = torch.from_numpy(lr).cuda(), torch.from_numpy(pan).cuda()
    path = ("ln_mixer_head", "window_attention", "block_tail")
    for tile, halo, crop in SCENE_TILINGS:
        tag = f"scene {SCENE}x{SCENE}x{cfg.ms_chans} tile {tile} halo {halo}"
        stride = tile - 2 * halo
        n_side = -(-(SCENE - tile) // stride) + 1
        forwards = -(-n_side ** 2 // SCENE_BATCH)
        run = lambda: fuse_scene(method, lr_d, pan_d, tile=tile, halo=halo,
                                 batch=SCENE_BATCH)
        out = run()   # warm-up
        torch.cuda.synchronize()
        wrappers = reset_launches()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counted = check_launches(tag, wrappers, dict.fromkeys(path, 5),
                                 3 * forwards)
        if tuple(out.shape) != (SCENE, SCENE, cfg.ms_chans) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"{tag}: output {tuple(out.shape)} is not "
                                 "a finite scene")
        best = min(times)
        print(f"{tag}: {n_side ** 2} tiles in {forwards} forwards of "
              f"{SCENE_BATCH}, launches per tile forward "
              f"{ {k: counted[k] // (3 * forwards) for k in path} }; "
              f"{statistics.median(times) * 1e3:.2f} ms median of 3 "
              f"(best {best * 1e3:.2f}) = "
              f"{SCENE * SCENE / statistics.median(times) / 1e6:.2f} MP/s "
              f"[{card}]")
        # the card against the CPU plain path on a crop, at the timed
        # run's batch (one forward of the crop's tiles and padding tiles)
        lc, pc = lr[:crop // 4, :crop // 4], pan[:crop, :crop]
        n_crop = (-(-(crop - tile) // stride) + 1) ** 2
        got = fuse_scene(method, lc, pc, tile=tile, halo=halo,
                         batch=SCENE_BATCH).cpu()
        want = fuse_scene(cpu, lc, pc, tile=tile, halo=halo,
                          batch=SCENE_BATCH)
        err = (got - want).abs().max().item()
        print(f"{tag}: {crop}x{crop} crop ({n_crop} tiles, batch "
              f"{SCENE_BATCH}) max|card - cpu plain| {err:.3e} (bound 5e-4; "
              f"max|cpu| {want.abs().max().item():.3f})")
        # where that difference comes from (printed, not checked)
        with swapped_kernels(path, lambda name, fn: kernel_fns(name)[1]):
            card_plain = fuse_scene(method, lc, pc, tile=tile, halo=halo,
                                    batch=SCENE_BATCH).cpu()
        print(f"{tag} split: max|card kernels - card plain| "
              f"{(got - card_plain).abs().max().item():.3e}  max|card plain "
              f"- cpu plain| {(card_plain - want).abs().max().item():.3e}")
        if not err <= 5e-4:
            raise AssertionError(f"{tag}: card vs CPU plain {err:.3e}")
        if profile:
            print_profile(tag, device_profile(run, n=2), card)
    return method


def run_cli(method, card: str) -> None:
    """`python -m lgteun_tpu_torch.fuse` once on the synthetic scene's
    TIFFs (seeded init, as the method of `run_scene`) against a direct
    fuse_scene call: within 1 DN of the uint16 rounding."""
    from lgteun_tpu_torch import fuse
    from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
    from lgteun_tpu_torch.parallel.scene import fuse_scene

    tile, halo, _ = SCENE_TILINGS[-1]
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    lr, pan = synthetic_scene(SCENE, 8, SEED + 1)
    paths = {k: os.path.join(out_dir, f"{k}.tif") for k in ("lr", "pan",
                                                            "fused")}
    write_tiff(paths["lr"], np.round(lr).astype(np.uint16))
    write_tiff(paths["pan"], np.round(pan).astype(np.uint16))
    fuse.cli(["--lr", paths["lr"], "--pan", paths["pan"], "-o",
              paths["fused"], "--tile", str(tile), "--halo", str(halo),
              "--batch", str(SCENE_BATCH), "--device", "cuda"])
    got = read_tiff(paths["fused"]).astype(np.float64)
    scale = 2.0 ** 11 - 0.5
    want = fuse_scene(method, np.round(lr) / scale, np.round(pan) / scale,
                      tile=tile, halo=halo, batch=SCENE_BATCH).cpu().numpy()
    want = np.clip(np.round(want * scale), 0, 2047)
    err = float(np.abs(got - want).max())
    print(f"cli: {paths['fused']} {got.shape} max|cli - fuse_scene| "
          f"{err:g} DN (bound 1) [{card}]")
    if got.shape != (SCENE, SCENE, 8) or not err <= 1.0:
        raise AssertionError(f"cli output {got.shape} differs by {err} DN")


def run_slice(config: str, per_forward: dict, abs_tol: float, n_cmp: int,
              env: dict, n_images: int, card: str, profile: bool) -> dict:
    """Drive one eval path through Runner.test on the card and check
    it; returns {kernel: launches in the Runner.test run}."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import (data_denormalize,
                                                eval_batches)
    from lgteun_tpu_torch.metrics.torch_metrics import psnr_batch
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner

    cfg = load_config(config)
    tag = f"slice {cfg.model_type}" + "".join(f" ({k}={v})"
                                              for k, v in env.items())
    print(f"config: {cfg.model_type} {cfg.datas} ms_chans={cfg.ms_chans} "
          f"model_cfg={cfg.model_cfg} eval_batch_size={cfg.eval_batch_size}"
          f" env={env}")
    with mock.patch.dict(os.environ, env):
        method = build_model(cfg.model_type, cfg, device="cuda")
        cpu = build_model(cfg.model_type, cfg, device="cpu")
    runner = Runner(cfg, method, "cuda").init(SEED)
    ds = SceneDataset(n_images, cfg.ms_chans, SEED)
    runner.predict(runner.to_device(next(eval_batches(
        ds, cfg.eval_batch_size))[0]))  # warm-up outside the counted run
    torch.cuda.synchronize()
    wrappers = reset_launches()
    results = runner.test(ds)
    forwards = -(-n_images // cfg.eval_batch_size)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"{tag}: psnr {results['psnr'][0]:.4f} dB (random weights), "
          f"{forwards} forwards, launches "
          f"{ {k: launches[k] for k in per_forward} }")
    check_launches(tag, wrappers, per_forward, forwards)

    first = {k: v[:n_cmp] for k, v in next(eval_batches(ds, n_cmp))[
        0].items() if k != "image_id"}
    searches = [k for k in per_forward if k in ("texture_match",
                                                "patch_match")]
    calls = []      # the searches' arguments in this forward

    def recorder(name, fn):
        def call(*args):
            calls.append((name, args))
            return fn(*args)
        return call

    with swapped_kernels(searches, recorder):
        got = runner.predict(runner.to_device(first)).cpu()
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    want = cpu.apply(first)
    err = (got - want).abs().max().item()
    n_near = sum(int(near_ties(*search_inputs(k, args)).sum())
                 for k, args in calls)
    near = f", float64 near-tie queries {n_near}" if searches else ""
    print(f"{tag}: output {tuple(got.shape)} finite="
          f"{bool(torch.isfinite(got).all())}  max|card - cpu plain| "
          f"{err:.3e} (max|cpu| {want.abs().max().item():.3f}, bound "
          f"{abs_tol:g}){near}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{tag} output is not finite")
    if not err <= abs_tol:
        if not n_near:
            raise AssertionError(f"{tag} output: max-abs {err:.3e} > "
                                 f"{abs_tol}")
        # a near tie flipped a search: hold the image's PSNR instead
        score = lambda pred: psnr_batch(
            data_denormalize(pred, cfg.bit_depth),
            data_denormalize(torch.from_numpy(first["target"]),
                             cfg.bit_depth),
            dynamic_range=2.0 ** cfg.bit_depth - 0.5)
        d_psnr = (score(got) - score(want)).abs().max().item()
        print(f"{tag}: max-abs {err:.3e} over the bound with {n_near} "
              f"near-tie queries; |psnr card - psnr cpu| {d_psnr:.5f} dB "
              f"(bound {PSNR_TOL_DB} dB)")
        if not d_psnr <= PSNR_TOL_DB:
            raise AssertionError(f"{tag} output: PSNR differs by "
                                 f"{d_psnr:.5f} dB")
    # where that difference comes from (printed, not checked)
    # (on the plain versions the wrappers count no launch)
    with swapped_kernels(per_forward, lambda name, fn: kernel_fns(name)[1]):
        card_plain = runner.predict(runner.to_device(first)).cpu()
    exact = float64_forward(cpu, first)
    d = lambda a, b: (a.double() - b.double()).abs().max().item()
    print(f"{tag} split: max|card kernels - card plain| "
          f"{d(got, card_plain):.3e}  max|card plain - cpu plain| "
          f"{d(card_plain, want):.3e}; vs float64 cpu plain: card kernels "
          f"{d(got, exact):.3e}, card plain {d(card_plain, exact):.3e}, "
          f"cpu plain {d(want, exact):.3e}")

    # latency and throughput of the predict path
    items = next(eval_batches(ds, cfg.eval_batch_size))[0]
    b1 = runner.to_device({k: v[:1] for k, v in items.items()
                           if k != "image_id"})
    b16 = runner.to_device(items)
    lat = []
    for _ in range(3):
        runner.predict(b1)
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.predict(b1)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    b16_ms = time_ms(lambda: runner.predict(b16), iters=10)
    ips = cfg.eval_batch_size / (b16_ms / 1e3)
    print(f"{tag}: batch-1 latency median "
          f"{statistics.median(lat) * 1e3:.3f} ms (min {min(lat) * 1e3:.3f})"
          f"; batch-{cfg.eval_batch_size} {b16_ms:.3f} ms = {ips:.1f} "
          f"images/s; Runner.test {runner.last_time_per_image * 1e3:.3f} "
          f"ms/img  [{card}]")

    if profile:
        for label, batch in (("batch-1", b1),
                             (f"batch-{cfg.eval_batch_size}", b16)):
            print_profile(f"{tag[6:]} {label}",
                          device_profile(lambda: runner.predict(batch)), card)
    return launches


def run_autograd(gen: torch.Generator) -> None:
    """Each differentiable wrapper (B1-B6) at the main path's shapes:
    its forward (KERNEL_REL_TOL) and the gradients of a loss linear in
    its outputs, with respect to every input and weight (the dropout
    mask excepted), against plain autograd through its plain version on
    the card (GRAD_REL_TOL)."""
    names = ("ln_mixer_head", "window_attention", "block_tail",
             "block_tail_masked", "global_mixer", "ln_ffn",
             "window_attention_windows")
    for name, shape, kernel, plain, args in kernel_cases(gen):
        if name not in names or shape not in AUTOGRAD_SHAPES:
            continue
        leaf = lambda t: t.detach().clone().requires_grad_()
        args = [({k: leaf(v) for k, v in a.items()} if isinstance(a, dict)
                 else leaf(a) if isinstance(a, torch.Tensor) and not (
                     name == "block_tail_masked" and i == 3) else a)
                for i, a in enumerate(args)]
        leaves = [t for a in args for t in (
            a.values() if isinstance(a, dict) else [a])
                  if isinstance(t, torch.Tensor) and t.requires_grad]
        weights = None
        results = []
        for fn in (kernel, plain):
            outs = fn(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if weights is None:
                weights = [torch.randn(o.shape, generator=gen).cuda()
                           for o in outs]
            loss = sum((o * w).sum() for o, w in zip(outs, weights))
            results.append(([o.detach() for o in outs],
                            torch.autograd.grad(loss, leaves)))
        (k_out, k_grads), (p_out, p_grads) = results
        fwd, _ = rel_err(k_out, p_out)
        grad = max(rel_err([g], [w])[0] for g, w in zip(k_grads, p_grads))
        print(f"autograd {name:24s} {shape:14s} forward rel err {fwd:.3e}  "
              f"grads of {len(leaves)} tensors rel err {grad:.3e} (bounds "
              f"{KERNEL_REL_TOL:g}, {GRAD_REL_TOL:g})")
        if not (fwd <= KERNEL_REL_TOL and grad <= GRAD_REL_TOL):
            raise AssertionError(f"autograd {name} {shape}: forward {fwd:.3e}"
                                 f", grads {grad:.3e}")


def train_method(cfg, env: dict | None = None):
    """The shipped UnlgFormer on the card, built under `env` (fuse level
    2 and the image-layout attention unless it says otherwise)."""
    from lgteun_tpu_torch.registry import build_model
    base = {"LGTEUN_FUSE_LEVEL": "2", "LGTEUN_FUSED_ATTENTION": "1"}
    with mock.patch.dict(os.environ, dict(base, **(env or {}))):
        return build_model(cfg.model_type, cfg, device="cuda")


def reset_launches() -> dict:
    wrappers = {k: kernel_fns(k)[0] for k in KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def check_launches(tag: str, wrappers: dict, per_forward: dict,
                   forwards: int) -> dict:
    counted = {k: fn.launches for k, fn in wrappers.items()}
    for k, n in counted.items():
        if n != per_forward.get(k, 0) * forwards:
            raise AssertionError(f"{tag}: {k} launched {n} times, want "
                                 f"{per_forward.get(k, 0)} per forward x "
                                 f"{forwards}")
    return counted


def run_training(card: str, profile: bool):
    """Runner.train on a seeded synthetic WV-3 dataset, the shipped
    config at batch 4 with dropout; then step times at TRAIN_BATCHES and
    a resume check. Returns (the training dataset, launches in the
    train() run)."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.dataset import PSDataset
    from lgteun_tpu_torch.data.pipeline import train_iterator
    from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
    from lgteun_tpu_torch.runner import Runner

    cfg = load_config(os.path.join(CONFIGS, "unlg_former.py"))
    root = os.path.join(REPO, "build", "chip_smoke", "train")
    t0 = time.perf_counter()
    dirs = make_synthetic_dataset(root, TRAIN_IMAGES, 4, bands=cfg.ms_chans,
                                  size=128, seed=SEED, sensor="WV3")
    train_ds = PSDataset([dirs["train"]], bit_depth=cfg.bit_depth)
    test_ds = PSDataset([dirs["test"]], bit_depth=cfg.bit_depth)
    print(f"train data: {len(train_ds)} + {len(test_ds)} synthetic WV-3 Wald "
          f"pairs (LrMS 32x32x{cfg.ms_chans}, PAN 128x128) in "
          f"{time.perf_counter() - t0:.1f} s under {root}")
    cfg.max_iter, cfg.log_freq, cfg.work_dir = TRAIN_ITERS, TRAIN_LOG, root
    cfg.save_freq = cfg.eval_freq = 0
    bs = cfg.train_set_cfg.batch_size
    drop = cfg.model_cfg["core_module"].get("drop_rate", 0.1)
    print(f"train config: {cfg.optim_cfg['core_module']} {cfg.sched_cfg} "
          f"{cfg.loss_cfg} batch {bs} drop_rate {drop} max_iter "
          f"{cfg.max_iter}")
    runner = Runner(cfg, train_method(cfg), "cuda", train_ds=train_ds,
                    test_ds=test_ds).init(SEED).set_optim()
    before = runner.test(test_ds)["psnr"][0]
    wrappers = reset_launches()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = check_launches("train", wrappers, TRAIN_ROUTE, TRAIN_ITERS)
    print(f"train: {TRAIN_ITERS} iterations in {wall:.2f} s "
          f"({wall / TRAIN_ITERS * 1e3:.2f} ms an iteration, data included)"
          f"; launches per training forward "
          f"{ {k: counted[k] // TRAIN_ITERS for k in TRAIN_ROUTE} }, "
          f"lgb_block {counted['lgb_block']}, block_tail "
          f"{counted['block_tail']}  [{card}]")
    curve = [(it, parts["rec_loss"]) for it, parts in runner.loss_log]
    for it, loss in curve:
        print(f"train: iter {it} l1 {loss:.6f}")
    if not all(np.isfinite([l for _, l in curve])) or not \
            curve[-1][1] < curve[0][1]:
        raise AssertionError(f"train: l1 curve {curve} is not finite and "
                             "falling")
    after = runner.test(test_ds)["psnr"][0]
    print(f"train: test psnr {before:.4f} -> {after:.4f} dB over "
          f"{TRAIN_ITERS} iterations (4 synthetic pairs)")

    # resume: a checkpoint at TRAIN_ITERS, loaded into a new Runner; both
    # run RESUME_STEPS more iterations
    path = runner.save(TRAIN_ITERS)
    cfg.max_iter, cfg.log_freq = TRAIN_ITERS + RESUME_STEPS, 1
    def resume():
        r = Runner(cfg, train_method(cfg), "cuda", train_ds=train_ds)
        return r.load_checkpoint(path).set_optim().train()

    n0 = len(runner.loss_log)
    runner.train()
    resumed, again = resume(), resume()
    losses = lambda r, n=0: [parts["full_loss"] for _, parts in
                             r.loss_log[n:]]

    def gap(r1, l1, r2, l2):
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(l1, l2))
        s1, s2 = r1.method.module.state_dict(), r2.method.module.state_dict()
        return loss_rel, max((s1[k] - s2[k]).abs().max().item() for k in s1)

    a, b = losses(runner, n0), losses(resumed)
    loss_rel, w_err = gap(runner, a, resumed, b)
    spread = gap(resumed, b, again, losses(again))
    lr = cfg.optim_cfg["core_module"].lr
    print(f"resume: {RESUME_STEPS} steps after iteration {TRAIN_ITERS}: "
          f"first step loss equal {a[0] == b[0]}, losses rel err "
          f"{loss_rel:.3e} (bound {RESUME_LOSS_REL:g}), weights max-abs "
          f"{w_err:.3e} (bound 2 lr x steps = {2 * lr * RESUME_STEPS:g}); "
          f"two resumed runs: losses {spread[0]:.3e}, weights "
          f"{spread[1]:.3e} (the bicubic backward's atomic adds are not "
          f"ordered on CUDA)")
    if len(a) != RESUME_STEPS or len(b) != RESUME_STEPS or a[0] != b[0] \
            or not (loss_rel <= RESUME_LOSS_REL
                    and w_err <= 2 * lr * RESUME_STEPS):
        raise AssertionError("resumed run departs from the uninterrupted one")

    # step time at each batch: the device step (forward, backward, Adam)
    for bsz in TRAIN_BATCHES:
        batch = runner.to_device(next(train_iterator(
            train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED)))
        times = []
        for i in range(3 + TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.train_step(batch, i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times[3:])
        print(f"train step batch {bsz}: median {med * 1e3:.3f} ms (min "
              f"{min(times[3:]) * 1e3:.3f}) of {TRAIN_TIMED} = "
              f"{bsz / med:.1f} images/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB  "
              f"[{card}]")
        if profile:
            print_profile(f"train step batch-{bsz}", device_profile(
                lambda: runner.train_step(batch, 0)), card)
    return train_ds, counted


def run_grad_split(train_ds, card: str) -> None:
    """One drop-0 step (train mode, no generator) from the same weights
    on 2 images: the loss and every parameter's gradient on the card
    against the CPU plain path, and where the difference comes from (card
    kernels vs card plain, card plain vs CPU plain, each path vs a float64
    run of the CPU plain path).

    A gradient is held relative to its tensor's largest (TRAIN_GRAD_TOL)
    where that is at least GRAD_LEVEL of the largest gradient of all;
    below that level (the position biases and amplitude biases at a
    seeded init, 1e-7 to 1e-5 of it) float32 rounding itself is of the
    gradient's size (the CPU float32 run against float64 shows it), and
    every tensor is held as allclose: |a - b| <= TRAIN_GRAD_TOL |b|max +
    GRAD_ATOL times the largest gradient of all."""
    from lgteun_tpu_torch.data.pipeline import train_iterator
    from lgteun_tpu_torch.runner import Runner

    cfg, method = unlgformer("cuda")
    Runner(cfg, method, "cuda").init(SEED + 3)
    _, cpu = unlgformer("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    batch = next(train_iterator(train_ds, 2, bit_depth=cfg.bit_depth,
                                seed=SEED + 3))

    def step(m):
        m.train()
        m.module.zero_grad(set_to_none=True)
        total, _ = m.losses(batch)
        total.backward()
        return total.item(), {k: p.grad.detach().cpu().double() for k, p in
                              m.module.named_parameters()
                              if p.grad is not None}

    def step64(m):
        module = copy.deepcopy(m.module).double().train()
        nchw = lambda k: torch.from_numpy(np.asarray(batch[k], np.float64)
                                          ).permute(0, 3, 1, 2)
        out = module(nchw("input_lr"), nchw("input_pan"))
        total = (out - nchw("target")).abs().mean()
        total.backward()
        return total.item(), {k: p.grad for k, p in module.named_parameters()
                              if p.grad is not None}

    card_k = step(method)
    with swapped_kernels(("ln_mixer_head", "window_attention", "block_tail"),
                         lambda name, fn: kernel_fns(name)[1]):
        card_p = step(method)
    want = step(cpu)
    exact = step64(cpu)
    scale = max(g.abs().max().item() for g in exact[1].values())
    level = {k for k, g in exact[1].items()
             if g.abs().max().item() >= GRAD_LEVEL * scale}

    def diff(a, b):
        """(|loss a - loss b|, the worst relative error among the tensors
        above GRAD_LEVEL and its tensor, allclose of every tensor)."""
        assert a[1].keys() == b[1].keys()
        rel = {k: (a[1][k] - b[1][k]).abs().max().item()
               / b[1][k].abs().max().item() for k in level}
        worst = max(rel, key=rel.get)
        close = all(((a[1][k] - b[1][k]).abs() <= TRAIN_GRAD_TOL
                     * b[1][k].abs().max() + GRAD_ATOL * scale).all()
                    for k in b[1])
        return abs(a[0] - b[0]), rel[worst], worst, close

    loss_err, grad_err, worst, close = diff(card_k, want)
    print(f"train grads: drop-0 step on 2 images, loss {want[0]:.6f}, "
          f"{len(want[1])} parameters with a gradient, {len(level)} of them "
          f"above {GRAD_LEVEL:g} of the largest ({scale:.4g}): |card - cpu "
          f"plain| loss {loss_err:.3e}, worst gradient rel err "
          f"{grad_err:.3e} ({worst}; bound {TRAIN_GRAD_TOL:g} of the "
          f"tensor's max), every tensor allclose (rtol {TRAIN_GRAD_TOL:g}, "
          f"atol {GRAD_ATOL:g} x {scale:.4g}): {close}  [{card}]")
    for tag, a, b in (("card kernels vs card plain", card_k, card_p),
                      ("card plain vs cpu plain", card_p, want),
                      ("card kernels vs float64", card_k, exact),
                      ("cpu plain vs float64", want, exact)):
        d = diff(a, b)
        below = max(((a[1][k] - b[1][k]).abs().max()
                     / b[1][k].abs().max()).item()
                    for k in b[1].keys() - level) if b[1].keys() - level \
            else 0.0
        print(f"train grads split, {tag}: loss {d[0]:.3e}, worst rel err "
              f"{d[1]:.3e} above the level, {below:.3e} below it")
    if not (loss_err <= 5e-4 * abs(want[0]) and grad_err <= TRAIN_GRAD_TOL
            and close):
        raise AssertionError(f"train grads: loss {loss_err:.3e}, gradients "
                             f"{grad_err:.3e}, allclose {close}")


def run_train_variants(train_ds, card: str, steps: int = 3) -> None:
    """A few training steps (dropout on) through the other routes: level
    1 (window attention, global mixer, LN + FFN; the mask in plain
    torch), level 3 (trains through level 2's chain, never the
    whole-block kernel) and LGTEUN_FUSED_ATTENTION=v2 ([N, C, S]
    windows)."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import train_iterator
    from lgteun_tpu_torch.runner import Runner

    cfg = load_config(os.path.join(CONFIGS, "unlg_former.py"))
    batch = next(train_iterator(train_ds, cfg.train_set_cfg.batch_size,
                                bit_depth=cfg.bit_depth, seed=SEED + 4))
    for env, route in (
            ({"LGTEUN_FUSE_LEVEL": "1"}, {"window_attention": 5,
                                          "global_mixer": 5, "ln_ffn": 5}),
            ({"LGTEUN_FUSE_LEVEL": "3"}, TRAIN_ROUTE),
            ({"LGTEUN_FUSED_ATTENTION": "v2"}, {
                "ln_mixer_head": 5, "window_attention_windows": 5,
                "block_tail_masked": 5})):
        runner = Runner(cfg, train_method(cfg, env), "cuda").init(
            SEED).set_optim()
        dev = runner.to_device(batch)
        runner.train_step(dev, 0)   # warm-up outside the count
        wrappers = reset_launches()
        losses = [runner.train_step(dev, i + 1)["full_loss"].item()
                  for i in range(steps)]
        check_launches(f"train {env}", wrappers, route, steps)
        print(f"train {env}: {steps} steps, l1 "
              f"{', '.join(f'{v:.6f}' for v in losses)}; launches per "
              f"forward {route}  [{card}]")
        if not np.isfinite(losses).all():
            raise AssertionError(f"train {env}: loss not finite")


if __name__ == "__main__":
    sys.exit(main())
