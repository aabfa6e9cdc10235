"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from `lgteun_tpu_torch/csrc` with nvcc,
holds each kernel against its plain PyTorch version at the main paths'
shapes (and the scene engine's three LGB kernels at 144^2 / 72^2; the
window attention also in its [N, C, S] and [N*S, C] layouts, at head
widths 4 and 32 and on 4x4 windows, which its FP32-core branch runs; the
block tail also with a seeded dropout mask, and the tails with and
without the mask and LN + FFN at 144^2 / 72^2 too, at channel counts the
tail kernel pads, 12 and 40, and on the wide tile at 96 and 128; the
whole block at C = 128 too), holds the differentiable wrappers' forward
and gradients (kernel forward, recompute backward; B1-B6, and LightNet's
stack, the neighbourhood attention and the two INNT searches, whose
training calls it also times) against plain autograd on the card, then
drives each ported eval path through `Runner.test` at its config's eval
batch size, with random weights from a seed:

- UnlgFormer (LGTEUN, WV-3, 8 bands, K=2): three kernels per LGB block
  (LGTEUN_FUSE_LEVEL 2, the default), then again at level 1 (window
  attention, the global mixer and LN + FFN per block), at level 3 (the
  whole block in one kernel) and with LGTEUN_FUSED_ATTENTION=v2 (the
  window attention on [N, C, S] windows);
- lightnet (WV-3, 8 bands): the SpanConv stack kernel (five launches);
- MDCUN (WV-3, 8 bands, T=4): the neighbourhood-attention kernel;
- INNT (WV-3, 8 bands, n_feat 8): the texture-match kernel, and in a
  second pass with LGTEUN_FUSED_TM=0 the patch-match kernel;
- PanFormer (WV-3, 8 bands, n_feats 64, 8 heads of 8, window 4, 3 cross
  blocks), SFIIN (WV-3, 8 bands) and MutInf (WV-3, 8 bands, the core
  module): no kernel of the port (the JAX package runs them as plain
  XLA), so every kernel's count must stay 0; PanFormer is also held
  before its clamp, with the share of clamped values printed.

Then a 16-band UnlgFormer (embed 64: blocks of C = 64 and, at the
bottleneck, C = 128 on the wide tail tile) at levels 1, 2 and 3, batch 4:
the card's distance from float64 against the CPU float32 plain path's,
and (printed) the card against the CPU plain path.

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
LGTEUN_FUSED_ATTENTION=v2. Then the rest of the zoo trains (`train
<method>` lines): LightNet, MDCUN, INNT, SFIIN and MutInf, each
`Runner.train` of its shipped config (optimisers, schedule, loss terms,
batch 8 for LightNet and 4 for the rest) for ZOO_TRAIN_ITERS iterations
on the same pairs: the loss curve (finite, rec_loss falling), launches
per training forward (`lightnet_stack` 5, `neighborhood_attention` 4,
`texture_match` 1), one step on 2 images against the CPU plain path
(MutInf mid-ramp with injected noise; INNT's near-tie queries printed;
SFIIN, whose phase gradients float32 resolves worse, held to float64 on
both devices, its target bins across the phase's branch cut printed),
MutInf's
resume (two modules, two optimisers) and the median step time at the
config's batch and at 16 with peak memory; then 3 steps of INNT with
LGTEUN_FUSED_TM=0 (1 `patch_match` a forward).

For each path it checks that every forward went through its kernels
(and launched no other), that the output agrees with a CPU run of the
plain path, and times batch-1 latency (printed beside the reference's
batch-1 figure, paper Table 4 on an RTX 3090) and batch-16 throughput.
It also
prints where the card-vs-CPU difference of each path comes from: the
card with the kernels, the card on the kernels' plain versions and the
CPU plain path, each against a float64 run of the CPU plain path.

The FFT mixer (the mixer head B1, the global mixer B4 and the whole
block's planes, one device body on the half spectrum) is also held on
planes constant along H and along W at 128^2, 144^2 and 72^2 against
the CPU plain version (which keeps their zero bins exactly zero whatever
the host's FFT library leaves there; a bin that is not would carry a
noise phase into the output), with a `c33` line per case: hashes of the
input and of the kernel's, the card's plain and the CPU's plain output,
the kernel's bits over REPEATS launches, the CPU side's capability, MKL
and threads, the planes' values off the constant and non-zero bins, and
the CPU output at 1 thread against N (ROADMAP C.33),
the head is launched REPEATS more times on the same inputs (same bits),
its twiddle and position tables (`lgteun_fft_tables`) are held against
their plain version, ptxas's registers and spills of the mixer's and the
whole block's kernels are printed from the build, and beside the
mixer's times stands cuFFT's rfft2 + irfft2 on the same planes, a
yardstick of the transforms alone.

The whole block (B8) is held at batch 16 too (128^2, C 32), launched
REPEATS more times on the same inputs and on grids of 1, 3 and 17 blocks
(its work list must give the full grid's bits), timed beside the
level-2 chain B1 -> B2 -> B3 on the same inputs (the only other
computation of the same function in the port, a yardstick), and
cuobjdump counts the local-memory loads and stores in its SASS (in all,
and in the window items' raised-register region). Beside the INNT
searches stands torch.bmm of their normalised vectors, the correlation
alone (a yardstick: no library call also takes the first max).

The INNT searches run on the tensor cores (wgmma TF32, 3xTF32) where
their shape allows it and on the FP32 cores elsewhere: each case prints
its branch, both branches of both searches must have been launched (a
C = 8 texture match at side 24 and a K = 72 patch match take the FP32
cores; a patch match at L = 100 ends inside a 64-query tile), the
wrappers' branch rule must equal the library's on every shape the
kernels take, and the tensor-core cases get the tensor-core bound, their
achieved TFLOP/s and cuobjdump's LDL/STL and HGMMA counts.

LightNet's stack (five launches of two layers, the pointwise convs on
the tensor cores) is held at 8 bands [4,9,128,128], 4 bands
[4,5,128,128] and a ragged [1,9,72,100]; the neighbourhood attention at
[4,8,128,128], [1,8,72,100], 4 bands [4,4,128,128], C = 16 and 32, a
31-wide window (two key chunks a row) and at C = 16, fs = 25 on its
FP32-core branch. Both are launched REPEATS more times on the same
inputs (same bits), print the tensor-core bound, count the mma.sync
(HMMA) instructions in their kernels' SASS (which must not be 0), the
attention's branch rule is held against the library's
(`lgteun_neighborhood_attention_tc`) and LightNet's weight layout
(`lightnet_fragments`) made on the card against the same made on the
CPU, bit for bit.

The two INNT searches pick, per query, the first maximum of a
similarity; a query whose best value lies within 1e-5 of the next lower
one (a near tie, found in float64 on the card) may pick another
sub-patch in another summation order. Their transferred values are held
only outside the near ties' footprint, which must stay under 1 % of the
output; the count is printed.

For each kernel the JSON line gives its time (device time a call, from
the profiler: at a few tens of microseconds the CUDA-event time of a
wrapper call is the host's), its plain version's time (CUDA events),
its bound (the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s,
the H100 SXM's published HBM and FP32 rates at 700 W; for the block
tails, the window attention and the INNT searches where their products
run on the tensor cores with the 3xTF32 split, those products'
operations x 3 at 495 TFLOP/s TF32 and the rest at the FP32 rate, with
the all-FP32 figure and the achieved TFLOP/s printed beside it) and the
time of one PyTorch call that computes the same function, where there
is one. The weight layouts of the tails
(`lgteun_tail_fragments`, TF32 hi/lo slabs in wgmma's order) and of the
window attention (`lgteun_attention_fragments`) are held bit for bit
against their plain versions and counted a training step; the window
attention and the whole-block kernel are launched REPEATS more times on
the same inputs and must give the same bits each time; every branch of
the window attention (tensor cores, FP32 cores) and of the tails (the
tile, the wide tile) must have been launched.

`--profile` adds a torch.profiler (CUPTI) pass over a few forwards of
each path at batch 1 and at the eval batch, and over a few training
steps at batch 4 and 16: device kernels per call, device busy time,
idle share and each device kernel's share of the busy time.

Then the reference's entry point (the `main` phase), `python -m
lgteun_tpu_torch.main -c CONFIG --device cuda` (`main.cli`): with
--test-only on the shipped WV-3 configs of UnlgFormer (seeded init,
level 2: 5 launches each of B1-B3 a forward, none of the others), GSA,
SFIM and Wavelet; without it, training then scoring, on copies of the
shipped configs of PanFormer, LightNet, MDCUN, INNT, SFIIN and MutInf
with max_iter cut to 40 (launches a training and an eval forward: 5 of
`lightnet_stack`, 4 of `neighborhood_attention`, 1 of `texture_match`,
none for the others; the loss curve; the checkpoint holds every module,
MutInf's `mi` too; PanFormer's seeded init besides fuses an image
uncorrelated with the scene, Q about 1e-5, which float32 resolves only
to about 1e-8), on a seeded synthetic WV-3 tree under
`build/chip_smoke/main` (20 training pairs, 20 reduced-resolution scenes
with targets, 20 full-resolution ones without; 128^2 PAN, batch 16):
every per-image
metric the card scores on both splits (PSNR, SSIM, Q, SAM, ERGAS;
D_lambda, D_s, QNR) held against the float64 oracle (`numpy_ref`, on the
CPU, in a pool of processes) on the same saved prediction, every written
TIFF against the rounded prediction (1 DN), both tags in
`eval_curves.json`; the metric suite's ms/img at batch 16 on each split,
the same suite on inputs with flat 8x8 and 32x32 windows (card vs CPU vs
float64), and each classical method's batch-16 images/s and batch-1
latency.

Right after it, the `reference` phase: the reference's released-weights
workflow on the main phase's seven DL runs. Each run's modules (MutInf's
`mi` too) are pickled whole as the reference saves them, as classes of
the reference's module paths that exist only while saving
(`convert/from_reference.py::write_reference_checkpoint`), converted by
`python -m lgteun_tpu_torch.convert.from_reference` in seven processes
started together, and run by `main.cli --test-only --device cuda
--checkpoint` (a strict load): last_iter restored, each
kernel's launches those of the main phase's eval forwards, the saved
outputs of both splits bit-equal to the main phase's. Every TIFF of
those runs must have been read by the native codec (`native/`, built
with g++ at first use), which is then held bit for bit to the Python
codec on every TIFF of the tree, with both decode rates and the batch
decoder's (warm file cache); and `downgrade_images` degrades a 512^2
WV-3 scene without importing PIL (held to Pillow's resize where the host
has it).

UnlgFormer's bf16 storage modes (`LGTEUN_EVAL_DTYPE` = bf16res / bf16,
`ops.storage_dtype`): after the float32 kernel checks, each bf16 entry
of B1-B6 and B8 at the batch-4 path shapes (B1-B3 at 128^2 / C 32,
64^2 / C 64, 144^2 and 72^2; the others at 128^2 and 64^2; B1 from
float32 and bf16 x, B3 in each storage combination, B8 with its
branches rounded from float32 and bf16 x) against its plain version's
float32 value p (`bf16 ...` rows: within 2^-8 |p| + KERNEL_REL_TOL
max|p|, 99 % of the elements equal to bf16(p); B8, which rounds inside,
99 % within and bit-equal to the level-2 chain in the same storage) with
its time beside the float32 entry's and its bytes bound; after the
slices, the whole forward in both modes at levels 2, 1, 3 and v2 (batch
4, seeded weights: launches, device kernels a forward, the drift's
envelope, card vs CPU plain against the CPU plain path's own
one-rounding spread, level 3 and v2 bit-equal to level 2), batch-1
latency and batch-16 images/s at level 2 in turns with float32 storage,
and the scene MP/s under bf16res at tile 144 / halo 8; after the
training phases, the first training step's loss under bf16res (equal to
float32 storage's) and the PSNR (float64 oracle, 16 held-out scenes) of
QUALITY_ITERS-iteration port-trained weights in float32 storage at level
2 and in each mode at levels 1, 2 and 3 (bf16res within 0.05 dB at every level;
see QUALITY_*). The bf16 rows also hold B4 from float32 x (the level-1
prior's mixer, ROADMAP C.35) and the bf16 entries of INNT's two
searches (both branches, the transferred values outside the float64
near ties) and of MDCUN's attention. The rest of the zoo under
`LGTEUN_EVAL_DTYPE=bf16` (`bf16 zoo ...` lines, after UnlgFormer's
modes): LightNet (its bf16 tap path, no kernel), MDCUN, INNT on both
search routes, PanFormer, SFIIN (the blanket cast) and MutInf (float32,
as in JAX) at batch 4 with seeded weights: launches a forward, the
drift's envelope (CPU plain path), card vs CPU plain in the mode against
the CPU's own spread at a one-step input change (BF16_ZOO_*), MutInf's
bits equal to float32's, and batch-1 latency and batch-16 images/s in
turns with float32 (printed only).

The JAX Runner's other training modes (after the zoo's training
blocks): `remat` (the loss inside torch.utils.checkpoint; UnlgFormer at
level 2 with dropout and MDCUN at batch 16, LightNet and INNT at their
training batch: the first loss bit-equal to the run without it, the
kernels launched twice a step, parameters within REMAT_* after 3 steps,
step ms and peak GiB in turns); `mixed_precision` (UnlgFormer's
selective bf16 blocks, B4 the only kernel; the blanket cast of LightNet,
MDCUN, INNT on both routes, PanFormer, SFIIN and MutInf: a drop-0 step
card vs CPU plain within MIXED_SPREAD of the CPU's own spread,
MIXED_ITERS iterations with the rec_loss falling, float32 masters and Adam states,
step ms and peak in turns with float32); adversarial training
(UnlgFormer + PatchDiscriminator(64, 3, IN) with LSGAN, LightNet with
GAN, LSGAN and WGAN-GP; one drop-0 step of both networks card vs CPU
plain at the training bounds, both networks moving over ADV_STEPS steps,
step ms) and a `QNR_loss` step; and, beside the autograd rows, the bf16
training entries of B10-B12 against plain autograd of their refs.

Last, data parallelism (the `mesh` phase, `parallel/mesh.py`): the
shipped UnlgFormer (level 2, dropout 0.1, batch 4) on a process group of
one rank under NCCL (a file:// rendezvous under `build/chip_smoke/mesh`)
against the Runner without a group from the same weights on the same
batches: the first loss bit-equal, 3 losses and the parameters within
the remat bounds (the card's own spread, two runs without a group,
printed), the launches a training forward unchanged, and the step ms at
batch 4 and 16 in turns (the cost of the all-reduces). Then two ranks
spawned on the one card under gloo (`parallel/ranks.py::spawn`; NCCL
refuses two ranks on one device), each with its rows of every batch,
against one rank in this process: 3 Adam steps (parameters by
tests/test_multichip.py's criterion, the ranks bit-equal), `Runner.test`
at eval batch 16 (per-image scores in order), a MutInf step mid-ramp and
its `mi` regulariser before the clip (loss parts, gradients); the
iteration ms of both, the two ranks time-sliced on one card (no
speed-up). A rank that fails fails the phase. The same spawn runs the
`space` phase's jobs (`parallel/spatial.py`, height-sharded eval
forwards; `space_jobs`, `run_space`): the shipped UnlgFormer (level 2,
seeded) at pan 128² and 240² on {"space": 2} and at 128², batch 2, on
{"data": 1, "space": 2}, LightNet at pan 1024², SFIM and Wavelet on a
1024² U(0.1, 0.9) scene and SFIM on the WV-3 scene, each rank's rows
gathered and held to the whole forward on the card within 1e-5 of
max|out| (SFIM on WV-3 to float64: within 2x the whole forward's
distance), each rank's B1, B2, B3 and B9 launches a forward counted and
checked, and the ms of a sharded forward on each rank beside the whole
forward's. Since the zoo's strips also: the shipped MDCUN (4 B12 a
forward) and INNT on both routes (1 B10, or 1 B11 with
LGTEUN_FUSED_TM=0; the whole forward's float64 near-tie queries
printed, and a case over the bound with near ties held by PSNR against
the scene's target instead, as the INNT slice is) at pan 128² and 256²,
UnlgFormer at 128² at fuse levels 1 (5 each of B2, B4, B5), 2, 3 (5 B8)
and v2 (5 B6) in float32, bf16res and bf16, and level 1 float32 at
240²: each against the whole forward of the same switches, every
rank's launches of every kernel checked, the collectives a forward by
kind; and kernel cases at the strips' shapes (B4 1x16x240x240, B5 /
B6 on the window strips, B8 1x32x128x128, B12 on a 256² image's rank
rows and 7-row halo 1x8x135x256, B10 / B11 on a rank's share of 512
patch-images). Then the `large` phase (planes above 240², where B1 and
B4 run the FFT mixer's cluster route up to 512² and 1024x512 and its
global route above, and B8 runs level 2's chain): B1 at 1x32x256²,
1x32x1024², 1x64x512² and the tile-256 scene's batch 32x32x256², B4 at
1x16x264² (odd parts 3, 11), 1x16x1024², 1x4x2048², 1x4x1024x2048,
1x4x1024x512 (a cluster of 16) and 32x16x256², their constant-plane
cases at 256² against the CPU plain version, B2 and B3 at 1x32x1024²,
each against its plain version (1e-4) with device ms, plain ms, bound,
share and a cuFFT yardstick, its route and cluster size (each case's
first launch counted on the route the mirror names), the bits over 8
more launches; on every cluster shape the global route forced on the
same inputs, bit-equal and timed beside it (the route's time before
this route); the cluster route forced at 2, 4, 8 and 16 blocks and the
global route forced on 128² / 240² planes, bit-equal to the one-block
body; the library's route of each (H, W, planes) against the mirror's;
the bf16 entries at 256², the tables at 1024² / 2048²; the shipped
UnlgFormer at pan 512², levels 1, 2, 3 and v2, against the CPU plain
path (5e-4) with its launches a forward by route (5 on the cluster
route), whole 1024² and 2048² tiles (ms, MP/s, peak GiB, launches by
route: 4 global + 1 cluster, 5 global), B1's training entry's gradients
at 256², `fuse_scene` on the 1024² scene at tile 256 (MP/s, 4 cluster
launches a forward, a crop against the CPU plain path) and the CLI
with --tile 0 against one whole forward (1 DN), and height-sharded 512²
forwards (level 2 float32, level 1 bf16res; run by the mesh phase's
spawn) against the whole forward. Each phase prints the seconds since
the start when it ends.

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
import hashlib
import importlib
import json
import logging
import os
import platform
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "lgteun_tpu_torch", "configs")
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
TF32_FLOPS_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
# the block tails, whose 1x1 products run on the tensor cores (3xTF32)
TAILS = ("block_tail", "block_tail_masked", "ln_ffn")
# the window attention's entries (B2, B6, B7): the tensor cores too
ATTENTION = ("window_attention", "window_attention_windows",
             "window_attention_rows")
# kernel -> the branches it must have launched in the kernel checks
BRANCHES = {**dict.fromkeys(ATTENTION, ("tc", "fp32")),
            **dict.fromkeys(("ln_mixer_head", "global_mixer"),
                            ("pair", "block512", "block256")),
            **dict.fromkeys(TAILS, ("tile", "wide")),
            "lgb_block": ("tc", "tile", "wide"),
            **dict.fromkeys(("texture_match", "patch_match",
                             "neighborhood_attention"), ("tc", "fp32"))}
DROP_RATE = 0.1             # the kernel cases' dropout mask
# a differentiable wrapper vs plain autograd on the card: the backward is
# the same plain graph on the same saved inputs and the loss is linear in
# the outputs, so only the backward's own run-to-run order may differ
GRAD_REL_TOL = 1e-5         # max|grad - plain grad| / max|plain grad|
AUTOGRAD_SHAPES = ("4x32x128x128", "4x64x64x64", "4x16x128x128",
                   "4x32x64x64", "1024x16x64", "256x32x64", "4x9x128x128",
                   "4x8x128x128", "1024x4x576", "1024x576x36")
# the kernels of the rest of the zoo (B9-B12), differentiable since the
# zoo trains on the card
ZOO_KERNELS = ("lightnet_stack", "neighborhood_attention", "texture_match",
               "patch_match")
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
# the training blocks of the rest of the zoo: (config, {kernel: launches
# per training forward; every other kernel 0}, environment of the build);
# then INNT's patch-match route for a few steps
ZOO_TRAIN = (("lightnet.py", {"lightnet_stack": 5}, {}),
             ("MDCUN.py", {"neighborhood_attention": 4}, {}),
             ("INNT.py", {"texture_match": 1}, {}),
             ("SFIIN.py", {}, {}),
             ("MutInf.py", {}, {}))
ZOO_TRAIN_PM = ("INNT.py", {"patch_match": 1}, {"LGTEUN_FUSED_TM": "0"})
ZOO_TRAIN_ITERS = 30        # bounded by the run's time limit
ZOO_TIMED = 10              # timed steps at each batch
ZOO_CPU_IMAGES = 2          # images of the card-vs-CPU step
# SFIIN's step held to float64 (see zoo_grad_split): the two devices'
# float64 steps within ZOO_F64_GRAD_TOL of a tensor's largest, and the
# card's float32 step no farther from float64 than ZOO_F64_FACTOR x the
# CPU's float32 step
ZOO_F64_GRAD_TOL = 1e-6
ZOO_F64_FACTOR = 2.0
# UnlgFormer's training path: fuse level 2, the image-layout attention
TRAIN_ENV = {"LGTEUN_FUSE_LEVEL": "2", "LGTEUN_FUSED_ATTENTION": "1"}
# the training forward at level 2 (and at level 3, which trains through
# level 2's chain): launches per forward
TRAIN_ROUTE = {"ln_mixer_head": 5, "window_attention": 5,
               "block_tail_masked": 5}
# the weight layouts remade a training step, after every optimizer step:
# the tails' proj, W1, W2, W3 and the window attention's wqkv of each of
# the 5 blocks
FRAGMENTS_PER_STEP = 20
ATTN_FRAGMENTS_PER_STEP = 5
REPEATS = 8                 # extra launches on the same inputs (B1, B2, B8)
# sides of the constant-plane mixer cases (B1, B4), and of the mixer's
# tables held against their plain version
CONST_SIDES = (128, 144, 72)
TABLE_SIZES = ((128, 128), (64, 64), (144, 144), (72, 72), (168, 168),
               (40, 56))
# the 16-band UnlgFormer (C 64 and 128) at each level: launches per
# forward and the tail variants of those launches
SIXTEEN = (({"LGTEUN_FUSE_LEVEL": "1"}, {"window_attention": 5,
                                         "global_mixer": 5, "ln_ffn": 5},
            "ln_ffn"),
           ({"LGTEUN_FUSE_LEVEL": "2"}, {"ln_mixer_head": 5,
                                         "window_attention": 5,
                                         "block_tail": 5}, "block_tail"),
           ({"LGTEUN_FUSE_LEVEL": "3"}, {"lgb_block": 5}, "lgb_block"))
# max|card - float64| - max|cpu plain - float64| of the 16-band model
# (the 8-band paths' card-vs-CPU bound; see run_sixteen_bands)
SIXTEEN_TOL = 5e-4

# the main phase: `python -m lgteun_tpu_torch.main --test-only` on a
# synthetic WV-3 tree of MAIN_IMAGES reduced-resolution scenes (with
# targets) and MAIN_IMAGES full-resolution ones (without)
MAIN_ROOT = os.path.join(REPO, "build", "chip_smoke", "main")
MAIN_IMAGES = 20
MAIN_CONFIGS = ("unlg_former.py", "GSA.py", "SFIM.py", "Wavelet.py",
                "PanFormer.py", "lightnet.py", "MDCUN.py", "INNT.py",
                "SFIIN.py", "MutInf.py")
# launches per forward (training and eval) by model; every other kernel,
# and every kernel of a model not listed, 0 (UnlgFormer at level 2)
MAIN_ROUTE = {"UnlgFormer": {"ln_mixer_head": 5, "window_attention": 5,
                             "block_tail": 5},
              "lightnet": {"lightnet_stack": 5},
              "MDCUN": {"neighborhood_attention": 4},
              "INNT": {"texture_match": 1}}
# card vs the float64 oracle (numpy_ref) on the same saved prediction:
# the bounds tests/test_metrics.py holds the JAX metrics to
MAIN_REF_RTOL = {"psnr": 1e-4, "ssim": 1e-4, "qindex": 1e-3, "sam": 1e-3,
                 "ergas": 1e-4}
MAIN_NO_REF_ATOL = {"d_lambda": 2e-4, "d_s": 2e-4, "qnr": 4e-4}
MAIN_TAGS = {True: "reduced-res (ref)", False: "full-res (no-ref)"}
# configs the main phase trains through `main` (no --test-only) on the
# tree's 20 training pairs, from a copy of the shipped config with
# max_iter cut to MAIN_TRAIN_ITERS (its optimisers, schedule, loss terms
# and batch as shipped), then scores: the rest of the zoo's training path
# end to end. PanFormer needs it besides: its seeded init fuses an image
# uncorrelated with the scene (Q about 1e-5, where float32's Q, the
# card's as JAX's, resolves 1e-8: MAIN_REF_RTOL's 1e-3 would measure that
# resolution); after 40 iterations its Q reads about 0.17 (H100)
MAIN_TRAINED = ("PanFormer.py", "lightnet.py", "MDCUN.py", "INNT.py",
                "SFIIN.py", "MutInf.py")
MAIN_TRAIN_ITERS = 40
DN_RANGE = 2.0 ** 11 - 0.5

# bf16 storage (LGTEUN_EVAL_DTYPE, ops.storage_dtype): each bf16 entry
# against its plain version's float32 result p before its last rounding:
# every element within BF16_REL |p| + KERNEL_REL_TOL max|p|, and at least
# BF16_EQUAL of the elements with |p| >= BF16_FLOOR max|p| equal to
# bf16(p) bit for bit (a store that truncated would match about half)
BF16 = torch.bfloat16
BF16_REL = 2.0 ** -8
BF16_EQUAL = 0.99
BF16_FLOOR = 1e-3
BF16_MODES = ("bf16res", "bf16")
# the FFT mixer's outputs (B1's x2, B4): a plane whose float64 spectrum
# has a bin within BF16_CUT x max|Z| of zero, or of the phase's branch
# cut (negative real axis; the self-conjugate bins, exactly real in both
# versions, aside), may take the other phase in the kernel's and the
# plain version's float32 FFTs: the learned phase scale then moves the
# whole plane past a rounding (ROADMAP C.9; one such plane of 64 read
# 0.984 equal on an H100, PERF.md §6). Such planes are set aside from the
# equal share, as the INNT searches' float64 near ties are (C.15), and
# counted; at most BF16_CUT_SHARE of the planes may be
BF16_CUT = 1e-6
BF16_CUT_SHARE = 0.25
# the bf16 forward of UnlgFormer at batch BF16_BATCH: (label, environment,
# launches per forward); every other kernel 0, as in float32 storage
BF16_BATCH = 4
BF16_LEVELS = (
    ("level 2", {"LGTEUN_FUSE_LEVEL": "2"},
     {"ln_mixer_head": 5, "window_attention": 5, "block_tail": 5}),
    ("level 1", {"LGTEUN_FUSE_LEVEL": "1"},
     {"window_attention": 5, "global_mixer": 5, "ln_ffn": 5}),
    ("level 3", {"LGTEUN_FUSE_LEVEL": "3"}, {"lgb_block": 5}),
    ("v2", {"LGTEUN_FUSE_LEVEL": "2", "LGTEUN_FUSED_ATTENTION": "v2"},
     {"ln_mixer_head": 5, "window_attention_windows": 5, "block_tail": 5}))
# the drift of a bf16 mode from float32 storage (CPU plain path), as the
# JAX package bounds its own (tests/test_lgteun.py): mean <= BF16_DRIFT_MEAN
# and max <= BF16_DRIFT_MAX, times max|float32 output|
BF16_DRIFT_MEAN = 5e-3
BF16_DRIFT_MAX = 5e-2
# card vs CPU plain in the same mode. Both modes are ill-conditioned at
# the level of their drift (ROADMAP C.37): the CPU plain path itself
# moves by 0.5-0.9 of the drift when its input moves by one float32
# rounding (an H100 run, PERF.md §6), so a quarter of the drift cannot
# hold between two float32 implementations. The card is held instead to that
# spread: mean|card - cpu| <= BF16_SPREAD x the CPU's one-rounding
# spread, and its own drift from its float32 output <= BF16_SPREAD x
# the CPU's (a kernel that rounded worse than the plain version would
# drift farther); level 3 and v2 on the card equal level 2 bit for bit
# (the whole block and the [N, C, S] attention run level 2's device
# code). The quarter is printed.
BF16_CARD_CPU = 0.25
BF16_SPREAD = 1.5
# quality with trained weights: QUALITY_ITERS iterations of the shipped
# config on QUALITY_TRAIN synthetic WV-3 pairs, then PSNR (float64
# oracle) on QUALITY_SCENES held-out scenes; bf16res within
# QUALITY_BUDGET_DB of float32 storage at levels 1, 2 and 3 (level 1
# once rounded the global mixer's input, as JAX's level-1 mirror does,
# which cost 0.26-0.33 dB on an H100, PERF.md §6; mended since, ROADMAP
# C.35)
# the rest of the zoo under LGTEUN_EVAL_DTYPE=bf16 (`run_bf16_zoo`):
# (config, environment of the build, launches per forward (every other
# kernel 0), images of the CPU comparison). LightNet runs its bf16 tap
# path (plain torch, as JAX's XLA path), no kernel; MDCUN and INNT reach
# the bf16 entries of B12 and B10 / B11; MutInf stays float32 (JAX's
# never casts). The card is held to the CPU plain path in the mode as
# UnlgFormer's modes are (BF16_SPREAD of the CPU's own spread), the
# spread taken at a one-bf16-step input change (`bf16_step`): the cast
# rounds the inputs, so a float32 rounding of them is lost
BF16_ZOO = (("lightnet.py", {}, {}, 2),
            ("MDCUN.py", {}, {"neighborhood_attention": 4}, 1),
            ("INNT.py", {"LGTEUN_FUSED_TM": "1"}, {"texture_match": 1}, 1),
            ("INNT.py", {"LGTEUN_FUSED_TM": "0"}, {"patch_match": 1}, 1),
            ("PanFormer.py", {}, {}, 2),
            ("SFIIN.py", {}, {}, 2),
            ("MutInf.py", {}, {}, 2))
BF16_ZOO_TIMED = 5
QUALITY_ITERS = 400         # bounded by the run's time limit
QUALITY_TRAIN = 32
QUALITY_SCENES = 16
QUALITY_BUDGET_DB = 0.05

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
# UnlgFormer the port's 5e-4 (ROADMAP.md); lightnet 1e-4, MDCUN 1e-3,
# INNT, PanFormer, SFIIN and MutInf 5e-4, those
# tests/test_torch_parity.py holds the JAX package to against the
# reference.
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
    ("lightnet.py", {"lightnet_stack": 5}, 1e-4, 2, {}, N_IMAGES),
    ("MDCUN.py", {"neighborhood_attention": 4}, 1e-3, 1, {}, N_IMAGES),
    ("INNT.py", {"texture_match": 1}, 5e-4, 1, {}, N_IMAGES),
    ("INNT.py", {"patch_match": 1}, 5e-4, 1, {"LGTEUN_FUSED_TM": "0"}, 16),
    ("PanFormer.py", {}, 5e-4, 2, {}, N_IMAGES),
    ("SFIIN.py", {}, 5e-4, 2, {}, N_IMAGES),
    ("MutInf.py", {}, 5e-4, 2, {}, N_IMAGES),
)
# the reference's batch-1 time, ms an image (paper Table 4: WV-3, RTX 3090)
REFERENCE_MS = {"UnlgFormer": 13.3, "lightnet": 1.9, "MDCUN": 174.7,
                "INNT": 42.6, "PanFormer": 16.0, "SFIIN": 52.9,
                "MutInf": 108.3}


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

    def lgb_args(c, hw, x=None, width=None, batch=b):
        """The args of ln_mixer_head (on x, if given), window_attention,
        block_tail and the FFN weights for an LGB block of C channels at
        hw x width (width hw if None), `batch` images."""
        c2, c4 = c // 2, 4 * c
        plane = (hw, width or hw)
        head = (n(batch, c, *plane) if x is None else x, 1 + 0.1 * n(c),
                0.1 * n(c), n(c2), 0.1 * n(c2), n(c2), 0.1 * n(c2))
        attn = (n(batch, c2, *plane), n(3 * c2, c2, scale=c2 ** -0.5),
                0.1 * n(3 * c2), n(2, 64, 64), 2, 8)
        ffn = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
               "w1": n(c4, c, scale=c ** -0.5), "b1": 0.1 * n(c4),
               "w2": n(c4, c4, scale=c4 ** -0.5), "b2": 0.1 * n(c4),
               "dw": n(c4, 3, 3, scale=1 / 3), "bdw": 0.1 * n(c4),
               "w3": n(c, c4, scale=c4 ** -0.5), "b3": 0.1 * n(c)}
        tail = (n(batch, c, *plane), n(batch, c2, *plane),
                n(batch, c2, *plane), n(c, c, scale=c ** -0.5), 0.1 * n(c),
                ffn)
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
        head, attn, ffn, tail = lgb_args(c, hw)
        yield "ln_mixer_head", shape, ln_mixer_head, ln_mixer_head_ref, head
        yield ("window_attention", shape, window_attention,
               window_attention_ref, attn)
        yield "block_tail", shape, block_tail, block_tail_ref, tail
        yield "ln_ffn", shape, ln_ffn, ln_ffn_ref, (tail[0], ffn)
        yield "block_tail_masked", shape, block_tail_masked, \
            block_tail_masked_ref, tail[:3] + (dropout_mask(tail[0]),) + \
            tail[3:]
    # the spatial path's shapes (`parallel/spatial.py`, two ranks, batch
    # 1): B1 on the whole 240^2 plane; B2 and B3 on a rank's window strip
    # (its rows rounded out to the 8-row grid plus a band): 72 rows of
    # 128 at C 32 (a 128^2 image), 72 rows of 120 at C 64 (240^2's
    # bottleneck)
    head, _, _, _ = lgb_args(32, 240, batch=1)
    yield ("ln_mixer_head", "1x32x240x240", ln_mixer_head,
           ln_mixer_head_ref, head)
    # and at level 1 B4 on the whole 240^2 plane's LN half, B5 and (v2)
    # B6 on the same strips; at level 3 B8 on the whole 128^2 plane
    yield ("global_mixer", "1x16x240x240", global_mixer, global_mixer_ref,
           (n(1, 16, 240, 240),) + head[3:])
    for c, rows, width in ((32, 72, 128), (64, 72, 120)):
        _, attn, ffn, tail = lgb_args(c, rows, width=width, batch=1)
        shape = f"1x{c}x{rows}x{width}"
        yield ("window_attention", shape, window_attention,
               window_attention_ref, attn)
        yield "block_tail", shape, block_tail, block_tail_ref, tail
        yield "ln_ffn", shape, ln_ffn, ln_ffn_ref, (tail[0], ffn)
        xt = window_partition(attn[0], 8)
        yield ("window_attention_windows", "x".join(map(str, xt.shape)),
               window_attention_windows, window_attention_windows_ref,
               (xt,) + attn[1:5])
    head, attn, ffn, tail = lgb_args(32, 128, batch=1)
    blk = dict(zip(("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b"),
                   head[1:]), wqkv=attn[1], bqkv=attn[2], pos=attn[3],
               proj_w=tail[3], proj_b=tail[4], ffn=ffn)
    yield "lgb_block", "1x32x128x128", lgb_block, lgb_block_ref, (head[0],
                                                                  blk)
    # the window attention at head widths 4 (C/2 = 8, padded to 8) and 32
    # (a 16-band model's bottleneck) on the tensor cores, and on 4x4
    # windows (S = 16), which the FP32-core branch runs; in each layout
    for c2, hw, win in ((8, 128, 8), (64, 64, 8), (16, 32, 4)):
        s = win * win
        attn = (n(b, c2, hw, hw), n(3 * c2, c2, scale=c2 ** -0.5),
                0.1 * n(3 * c2), n(2, s, s), 2, win)
        yield ("window_attention", f"{b}x{c2}x{hw}x{hw}w{win}",
               window_attention, window_attention_ref, attn)
        xt = window_partition(attn[0], win)
        yield ("window_attention_windows", "x".join(map(str, xt.shape)),
               window_attention_windows, window_attention_windows_ref,
               (xt,) + attn[1:5])
        xw = xt.transpose(1, 2).contiguous()
        yield ("window_attention_rows", "x".join(map(str, xw.shape)),
               window_attention_rows, window_attention_rows_ref,
               (xw,) + attn[1:5])
    # channel counts the tail kernel pads (to 32 and to 64 channels) and
    # the wide tile's (C > 64, padded to 128)
    for c, (h, w) in ((12, (16, 24)), (40, (24, 16)), (96, (16, 24)),
                      (128, (32, 32))):
        x = n(2, c, h, w)
        ffn = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
               "w1": n(4 * c, c, scale=c ** -0.5), "b1": 0.1 * n(4 * c),
               "w2": n(4 * c, 4 * c, scale=(4 * c) ** -0.5),
               "b2": 0.1 * n(4 * c), "dw": n(4 * c, 3, 3, scale=1 / 3),
               "bdw": 0.1 * n(4 * c), "w3": n(c, 4 * c, scale=(4 * c) ** -0.5),
               "b3": 0.1 * n(c)}
        tail = (x, n(2, c // 2, h, w), n(2, c // 2, h, w),
                n(c, c, scale=c ** -0.5), 0.1 * n(c), ffn)
        yield "block_tail", f"2x{c}x{h}x{w}", block_tail, block_tail_ref, tail
        yield "ln_ffn", f"2x{c}x{h}x{w}", ln_ffn, ln_ffn_ref, (x, ffn)
        if c > 64:
            yield ("block_tail_masked", f"2x{c}x{h}x{w}", block_tail_masked,
                   block_tail_masked_ref,
                   tail[:3] + (dropout_mask(x),) + tail[3:])
    # the whole block at a 16-band model's bottleneck (C = 128: the wide
    # tile in phase C, head width 32 in phase B)
    c, hw = 128, 64
    head, attn, ffn, tail = lgb_args(c, hw)
    blk = dict(zip(("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b"),
                   head[1:]), wqkv=attn[1], bqkv=attn[2], pos=attn[3],
               proj_w=tail[3], proj_b=tail[4], ffn=ffn)
    yield "lgb_block", f"{b}x{c}x{hw}x{hw}", lgb_block, lgb_block_ref, (
        head[0], blk)
    # the whole block at the eval batch (128^2, C 32)
    c, hw = BLOCK_SHAPES[0]
    head, attn, ffn, tail = lgb_args(c, hw, n(16, c, hw, hw))
    blk = dict(zip(("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b"),
                   head[1:]), wqkv=attn[1], bqkv=attn[2], pos=attn[3],
               proj_w=tail[3], proj_b=tail[4], ffn=ffn)
    yield "lgb_block", f"16x{c}x{hw}x{hw}", lgb_block, lgb_block_ref, (
        head[0], blk)
    # the mixer at the eval batch (256 planes: two 256-thread blocks an SM)
    c, hw = BLOCK_SHAPES[0]
    yield ("ln_mixer_head", f"16x{c}x{hw}x{hw}", ln_mixer_head,
           ln_mixer_head_ref, (n(16, c, hw, hw),) + lgb_args(c, hw)[0][1:])
    # and any even size: 168^2, the shared-memory limit (240^2), odd parts
    # 5, 7, and the eval batch
    for shape in ((b, 16, 72, 72), (1, 4, 168, 168), (1, 4, 240, 240),
                  (2, 8, 40, 56), (16, 16, 128, 128)):
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
    # planes constant along H (equal rows) or along W (constant rows): the
    # bins that are zero in exact arithmetic must be exactly zero, or
    # their phase is noise that pha_w and pha_b carry into the output
    for hw in CONST_SIDES:
        for axis in "HW":
            const = lambda c: n(b, c, 1, hw) if axis == "H" else n(
                b, c, hw, 1)
            x = const(32).expand(b, 32, hw, hw).contiguous()
            yield ("ln_mixer_head", f"{b}x32x{hw}x{hw}-const{axis}",
                   ln_mixer_head, ln_mixer_head_ref, lgb_args(32, hw, x)[0])
            x = const(16).expand(b, 16, hw, hw).contiguous()
            yield ("global_mixer", f"{b}x16x{hw}x{hw}-const{axis}",
                   global_mixer, global_mixer_ref,
                   (x, n(16), 0.1 * n(16), n(16), 0.1 * n(16)))

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
    # the 4-band stack (5 input channels), a ragged batch-1 image, and a
    # rank's strip of a 1024^2 scene on two ranks (`parallel/spatial.py`:
    # 512 rows and a 10-row halo)
    for sb, sbands, sh_, sw in ((b, 4, hw, hw), (1, bands, 72, 100),
                                (1, bands, 522, 1024)):
        slayers = []
        for _n, cin, cout, _r in lightnet_layers(sbands):
            span = []
            for _branch in range(2):
                span += [n(cout, cin, 1, 1, scale=(2 / cout) ** 0.5),
                         0.1 * n(cout), n(cout, 1, 3, 3, scale=(2 / 9 / cout)
                                          ** 0.5), 0.1 * n(cout)]
            slayers.append(tuple(span))
        slms = n(sb, sbands, sh_, sw)
        sx = torch.cat([n(sb, 1, sh_, sw), slms], dim=1)
        yield ("lightnet_stack", f"{sb}x{sbands + 1}x{sh_}x{sw}",
               lightnet_stack, lightnet_stack_ref, (sx, slms, slayers))
    # MDCUN's blockNL at 8 bands, one ragged shape for the borders, 4
    # bands, C = 16 and 32 (tensor cores), a 31-wide window (two key
    # chunks a row) and a 25-wide one at C = 16 (the FP32-core branch)
    from lgteun_tpu_torch.ops.nonlocal_kernel import (
        neighborhood_attention, neighborhood_attention_ref)
    for shape, fs in (((b, bands, hw, hw), 15), ((1, bands, 72, 100), 15),
                      ((b, 4, hw, hw), 15), ((2, 16, 40, 56), 15),
                      ((2, 32, 24, 40), 15), ((1, bands, 40, 40), 31),
                      ((1, 16, 40, 40), 25),
                      # a rank's rows of a 256^2 image on two ranks and
                      # the 7-row halo (`parallel/spatial.py`)
                      ((1, bands, 135, 256), 15)):
        c = shape[1]
        na = (n(*shape),) + tuple(n(c, c, scale=c ** -0.5)
                                  for _ in range(4)) + (fs,)
        yield ("neighborhood_attention", "x".join(map(str, shape))
               + ("" if fs == 15 else f"-fs{fs}"), neighborhood_attention,
               neighborhood_attention_ref, na)

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
    # a rank's share of a 256^2 image's 1024 patch-images on two ranks
    # (`parallel/spatial.py`)
    yield ("texture_match", f"512x{c}x{side * side}", texture_match,
           texture_match_ref, (patch_images(512, c, side),
                               patch_images(512, c, side)))
    yield ("texture_match", "64x8x64", texture_match, texture_match_ref,
           (n(64, 8, 64), n(64, 8, 64)))
    # C = 8 at side 24: the FP32-core branch (hi/lo refs would not fit)
    yield ("texture_match", "64x8x576", texture_match, texture_match_ref,
           (patch_images(64, 8, side), patch_images(64, 8, side)))
    yield ("texture_match", "64x4x576-tie", texture_match, texture_match_ref,
           (n(64, 4, 576), torch.full((64, 4, 576), 0.37).cuda()))

    def pm_args(nimg, c, side):
        unf = lambda v: F.unfold(v.view(nimg, c, side, side), 3, padding=1)
        lr_u, ref_u = unf(patch_images(nimg, c, side)), unf(patch_images(
            nimg, c, side))
        return (row_normalize(lr_u, 1).transpose(1, 2).contiguous(),
                row_normalize(ref_u, 1).transpose(1, 2).contiguous(), ref_u)

    pm = pm_args(nimg, c, side)
    yield ("patch_match", f"{nimg}x{side * side}x{9 * c}", patch_match,
           patch_match_ref, pm)
    yield ("patch_match", f"512x{side * side}x{9 * c}", patch_match,
           patch_match_ref, pm_args(512, c, side))
    # L = 100, not a multiple of the 64-query tile; K = 72 (C = 8): the
    # FP32-core branch
    yield ("patch_match", "256x100x36", patch_match, patch_match_ref,
           pm_args(256, c, 10))
    yield ("patch_match", "64x576x72", patch_match, patch_match_ref,
           pm_args(64, 8, side))
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


def bound(name: str, args, outs,
          fp32_only: bool = False) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): each
    input read once and each output written once at the HBM rate, or
    the operations at their type's rate, whichever is longer. Where this
    call runs its products on the tensor cores (and not `fp32_only`),
    those products count three times (the 3xTF32 passes) at the TF32
    rate and the rest at the FP32 rate; else all at the FP32 rate."""
    by_bytes = (tensor_bytes(args) + tensor_bytes(outs)) / HBM_BYTES_PER_S
    pw = (product_flops(name, args)
          if not fp32_only and on_tensor_cores(name, args) else 0.0)
    by_ops = (3 * pw / TF32_FLOPS_PER_S
              + (kernel_flops(name, args) - pw) / FP32_FLOPS_PER_S)
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def attention_shape(name: str, args) -> tuple:
    """(C, heads, win) of a window attention call's args."""
    x, heads = args[0], args[4]
    if name == "window_attention":
        return x.shape[1], heads, args[5]
    c = x.shape[1] if name == "window_attention_windows" else x.shape[2]
    s = x.shape[2] if name == "window_attention_windows" else x.shape[1]
    return c, heads, int(round(s ** 0.5))


def search_branch(name: str, args) -> str:
    """The branch ("tc" or "fp32") a search kernel or the neighbourhood
    attention takes for its args."""
    from lgteun_tpu_torch.ops.nonlocal_kernel import \
        neighborhood_attention_branch
    from lgteun_tpu_torch.ops.patch_match_kernel import patch_match_branch
    from lgteun_tpu_torch.ops.texture_match_kernel import \
        texture_match_branch
    x = args[0]
    if name == "neighborhood_attention":
        return neighborhood_attention_branch(x.shape[1], args[5])
    if name == "texture_match":
        return texture_match_branch(x.shape[1], int(round(x.shape[2]
                                                          ** 0.5)))
    return patch_match_branch(x.shape[2], x.shape[1])


def on_tensor_cores(name: str, args) -> bool:
    """Whether this call of kernel `name` runs its products on the tensor
    cores (3xTF32)."""
    if name in TAILS:
        return True
    if name in ATTENTION:
        from lgteun_tpu_torch.ops.window_attention import attention_branch
        return attention_branch(*attention_shape(name, args)) == "tc"
    if name in ("texture_match", "patch_match", "neighborhood_attention"):
        return search_branch(name, args) == "tc"
    return name == "lightnet_stack"


def product_flops(name: str, args) -> float:
    """The operations of the products a kernel runs on the tensor cores,
    which kernel_flops counts among the rest: a tail's four (three for
    ln_ffn) 1x1 products; the window attention's qkv, logits and A.V;
    the searches' R = ref_n . lr_n^T; LightNet's pointwise convs (both
    branches of every layer); the neighbourhood attention's logits and
    weighted sum over the fs^2 offsets."""
    x = args[0]
    if name == "lightnet_stack":
        from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_layers
        b, _, h, w = x.shape
        return b * h * w * sum(2 * 2 * cin * cout for _n, cin, cout, _r in
                               lightnet_layers(args[1].shape[1]))
    if name == "neighborhood_attention":
        b, c, h, w = x.shape
        return b * h * w * args[5] ** 2 * 4 * c
    if name == "texture_match":
        nimg, c, q = x.shape
        return nimg * 2 * q * q * 9 * c
    if name == "patch_match":
        nimg, ll, k = x.shape
        return nimg * 2 * ll * ll * k
    if name in ATTENTION:
        c, _heads, win = attention_shape(name, args)
        return x.numel() // c * (6 * c * c + 4 * win * win * c)
    b, c, h, w = x.shape
    return 2 * b * h * w * ((c * c if name != "ln_ffn" else 0) + 24 * c * c)


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
    double = copy.copy(method)
    double.module = copy.deepcopy(method.module).double()
    nchw = lambda a: torch.from_numpy(np.asarray(a, np.float64)).permute(
        0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        return double.forward(nchw(batch["input_lr"]),
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
    # CUPTI now and then hands back an empty trace (seen once in about a
    # hundred short windows on an H100): trace the window again then
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    else:
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


def bf16_equal_share(got: torch.Tensor, p: torch.Tensor,
                     keep: torch.Tensor | None = None) -> tuple:
    """(share of the elements with |p| >= BF16_FLOOR max|p| (and, given
    `keep`, of the [B, C] planes it keeps) whose bf16 value equals
    bf16(p) bit for bit, their count)."""
    big = p.abs() >= BF16_FLOOR * p.abs().max()
    if keep is not None:
        big &= keep[..., None, None]
    same = got.view(torch.int16) == p.to(BF16).view(torch.int16)
    n = int(big.sum())
    return (float((same & big).sum()) / max(n, 1), n)


def mixer_cut_planes(planes: torch.Tensor) -> torch.Tensor:
    """[B, C] True where the float64 spectrum of the mixer's input plane
    has a bin within BF16_CUT max|Z| of zero or of the negative real axis
    (the self-conjugate bins aside): see BF16_CUT."""
    z = torch.fft.rfft2(planes.double())
    h, half = z.shape[-2:]
    tol = BF16_CUT * z.abs().amax((-2, -1), keepdim=True)
    near = (z.abs() <= tol) | ((z.real < 0) & (z.imag.abs() <= tol))
    for r in {0, h // 2} if h % 2 == 0 else {0}:
        for c in {0, half - 1}:
            near[..., r, c] = False
    return near.flatten(-2).any(-1)


def bf16_kernel_cases(gen: torch.Generator):
    """(name, shape, storage label, kernel call, the plain version's
    float32 result before its last rounding, the tensors for the bytes
    bound, the float32 case's shape) per bf16 entry at the main path's
    batch-4 shapes: B1-B3 at 128^2 / C 32, 64^2 / C 64 and the scene
    tiles' 144^2 / 72^2; B4-B6 and B8 at 128^2 / 64^2."""
    from lgteun_tpu_torch.ops.ffn_kernel import (block_tail, block_tail_ref,
                                                 ln_ffn, ln_ffn_ref)
    from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block, lgb_block_ref
    from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                      global_mixer_ref,
                                                      ln_mixer_head,
                                                      ln_mixer_head_ref)
    from lgteun_tpu_torch.ops.window_attention import (
        window_attention, window_attention_ref, window_attention_windows,
        window_attention_windows_ref, window_partition)
    f32 = torch.float32

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    b = KERNEL_BATCH
    for c, hw in BLOCK_SHAPES + ((32, 144), (64, 72)):
        c2, c4 = c // 2, 4 * c
        shape = f"{b}x{c}x{hw}x{hw}"
        x = n(b, c, hw, hw)
        xb = x.to(BF16)
        hw_ = (1 + 0.1 * n(c), 0.1 * n(c), n(c2), 0.1 * n(c2), n(c2),
               0.1 * n(c2))
        for xs in (x, xb):
            label = f"{str(xs.dtype)[6:]}>bf16"
            yield ("ln_mixer_head", shape, label,
                   lambda xs=xs: ln_mixer_head(*(xs,) + hw_, out_dtype=BF16),
                   lambda xs=xs: ln_mixer_head_ref(*(xs,) + hw_,
                                                   out_dtype=f32),
                   (xs,) + hw_, shape)
        y1 = n(b, c2, hw, hw).to(BF16)
        attn = (n(3 * c2, c2, scale=c2 ** -0.5), 0.1 * n(3 * c2),
                n(2, 64, 64))
        yield ("window_attention", shape, "bf16",
               lambda: window_attention(y1, *attn, 2, 8),
               lambda: window_attention_ref(y1, *attn, 2, 8, out_dtype=f32),
               (y1,) + attn + (2, 8), shape)
        ffn = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
               "w1": n(c4, c, scale=c ** -0.5), "b1": 0.1 * n(c4),
               "w2": n(c4, c4, scale=c4 ** -0.5), "b2": 0.1 * n(c4),
               "dw": n(c4, 3, 3, scale=1 / 3), "bdw": 0.1 * n(c4),
               "w3": n(c, c4, scale=c4 ** -0.5), "b3": 0.1 * n(c)}
        proj = (n(c, c, scale=c ** -0.5), 0.1 * n(c))
        x1, x2 = n(b, c2, hw, hw), n(b, c2, hw, hw)
        for xs, br in ((x, BF16), (xb, BF16), (xb, f32)):
            t = (xs, x1.to(br), x2.to(br)) + proj + (ffn,)
            yield ("block_tail", shape,
                   f"{str(xs.dtype)[6:]},{str(br)[6:]}",
                   lambda t=t: block_tail(*t),
                   lambda t=t: block_tail_ref(*t, out_dtype=f32), t, shape)
        if (c, hw) not in BLOCK_SHAPES:
            continue
        gshape = f"{b}x{c2}x{hw}x{hw}"
        mix = hw_[2:]
        yield ("global_mixer", gshape, "bf16",
               lambda: global_mixer(y1, *mix),
               lambda: global_mixer_ref(y1, *mix, out_dtype=f32),
               (y1,) + mix, gshape)
        # the level-1 prior's mixer: the float32 LN in, bf16 out (C.35)
        x2f = n(b, c2, hw, hw)
        yield ("global_mixer", gshape, "float32>bf16",
               lambda: global_mixer(x2f, *mix, out_dtype=BF16),
               lambda: global_mixer_ref(x2f, *mix, out_dtype=f32),
               (x2f,) + mix, gshape)
        yield ("ln_ffn", shape, "bf16", lambda: ln_ffn(xb, ffn),
               lambda: ln_ffn_ref(xb, ffn, out_dtype=f32), (xb, ffn), shape)
        xt = window_partition(y1, 8)
        wshape = "x".join(map(str, xt.shape))
        yield ("window_attention_windows", wshape, "bf16",
               lambda: window_attention_windows(xt, *attn, 2),
               lambda: window_attention_windows_ref(xt, *attn, 2,
                                                    out_dtype=f32),
               (xt,) + attn + (2,), wshape)
        blk = dict(zip(("ln_w", "ln_b", "amp_w", "amp_b", "pha_w", "pha_b"),
                       hw_), wqkv=attn[0], bqkv=attn[1], pos=attn[2],
                   proj_w=proj[0], proj_b=proj[1], ffn=ffn)
        for xs in (x, xb):
            yield ("lgb_block", shape, f"{str(xs.dtype)[6:]},round",
                   lambda xs=xs: lgb_block(xs, blk, branch_dtype=BF16),
                   lambda xs=xs: lgb_block_ref(xs, blk, branch_dtype=BF16,
                                               out_dtype=f32),
                   (xs, blk), shape)

    # INNT's searches and MDCUN's attention on bf16, as the blanket cast
    # (LGTEUN_EVAL_DTYPE=bf16) gives them their inputs: each search on both
    # branches (tc: C 4 / K 36 at side 24; fp32: C 8 / K 72), the
    # attention at 8 and 4 bands (its weights bf16 too: the wrapper upcasts
    # them)
    from lgteun_tpu_torch.ops.nonlocal_kernel import (
        neighborhood_attention, neighborhood_attention_ref)
    from lgteun_tpu_torch.ops.patch_match_kernel import (patch_match,
                                                         patch_match_ref)
    from lgteun_tpu_torch.ops.texture_match_kernel import (
        row_normalize, texture_match, texture_match_ref)

    def patch_images(nimg, c, side=24):
        x = n(nimg, c, side, side)
        x[: nimg // 4, :, :8] = 0
        x[: nimg // 4, :, :, :8] = 0
        return x.reshape(nimg, c, side * side).to(BF16)

    # (512 patch-images: a rank's share of a height-sharded forward)
    for nimg, c in ((256 * b, 4), (64, 8), (SPACE_SHARE, 4)):
        shape = f"{nimg}x{c}x576"
        tm = (patch_images(nimg, c), patch_images(nimg, c))
        yield ("texture_match", shape, "bf16",
               lambda tm=tm: texture_match(*tm),
               lambda tm=tm: texture_match_ref(*tm, out_dtype=f32), tm,
               shape)
    for nimg, c in ((256 * b, 4), (64, 8), (SPACE_SHARE, 4)):
        shape = f"{nimg}x576x{9 * c}"
        lr_u, ref_u = (F.unfold(patch_images(nimg, c).view(nimg, c, 24, 24),
                                3, padding=1) for _ in range(2))
        pm = (row_normalize(lr_u, 1).transpose(1, 2).contiguous(),
              row_normalize(ref_u, 1).transpose(1, 2).contiguous(), ref_u)
        yield ("patch_match", shape, "bf16", lambda pm=pm: patch_match(*pm),
               lambda pm=pm: patch_match_ref(*pm, out_dtype=f32), pm, shape)
    # (and a strip of a height-sharded forward: 128 rows and a 7-row halo)
    for xshape in ((b, 8, 128, 128), (b, 4, 128, 128), SPACE_STRIP):
        c = xshape[1]
        shape = "x".join(map(str, xshape))
        na = (n(*xshape).to(BF16),) + tuple(
            n(c, c, scale=c ** -0.5).to(BF16) for _ in range(4))
        yield ("neighborhood_attention", shape, "bf16",
               lambda na=na: neighborhood_attention(*na),
               lambda na=na: neighborhood_attention_ref(*na, out_dtype=f32),
               na + (15,), shape)


def bf16_outputs(name: str, tensors, got, p, cut=None) -> tuple:
    """A bf16 entry's outputs `got` against its plain version's float32
    outputs `p` on the card: (the worst excess of |got - p| over BF16_REL
    |p| + KERNEL_REL_TOL max|p|, of max|p|; each bf16 output's share
    equal to bf16(p) (`bf16_equal_share`, the last output's mixer planes
    `cut` set aside); each output's share within the bound; the near-tie
    note; whether the near ties stay within NEAR_TIE_MAX_SHARE)."""
    worst, shares, within = 0.0, [], []
    # the searches' picks may differ at float64 near ties of the
    # (upcast) inputs: their transferred values are held elsewhere
    keep, near, ties_ok = None, "", True
    if name in ("texture_match", "patch_match"):
        mask, n_near = near_tie_mask(name, tensors, p[0])
        keep = ~mask
        near = (f"; near-tie queries {n_near}, transferred values set "
                f"aside {int(mask.sum())} of {mask.numel()}")
        ties_ok = mask.sum() <= NEAR_TIE_MAX_SHARE * mask.numel()
    for i, (g, w) in enumerate(zip(got, p)):
        if g.dtype not in (BF16, torch.float32) or g.shape != w.shape:
            raise AssertionError(f"bf16 {name}: output {g.dtype} "
                                 f"{tuple(g.shape)}")
        if keep is not None and i == 0:
            g, w = g[keep], w[keep]
        scale = w.abs().max().item()
        over = ((g.float() - w).abs() - BF16_REL * w.abs()
                - KERNEL_REL_TOL * scale)
        worst = max(worst, over.max().item() / max(scale, 1e-30))
        within.append(float((over <= 0).float().mean()))
        if g.dtype == BF16:
            mixed = cut is not None and i == len(got) - 1
            shares.append(bf16_equal_share(
                g, w, ~cut if mixed else None)[0])
    return worst, shares, within, near, ties_ok


def run_bf16_kernels(gen: torch.Generator, record: dict, card: str) -> None:
    """Each bf16 entry of B1-B6, B8 and B10-B12 (B4 also float32 in,
    bf16 out) against its plain version on the card (BF16_REL and
    BF16_EQUAL; the searches' transferred values outside the float64
    near ties' footprint, `near_tie_mask`, as their float32 entries are
    held), its time beside the float32 entry's at the same shape, and
    its bytes bound (each tensor's own element size); the rows go into
    `record[name]["bf16"]`. The whole block rounds its branches inside:
    it is also held to the level-2 chain on the card in the same storage
    (`level2_chain`, the same device code)."""
    from lgteun_tpu_torch.ops.norm import channel_layer_norm
    wrappers = reset_launches()
    failures = []
    for name, shape, label, kernel, plain, tensors, f32_shape in \
            bf16_kernel_cases(gen):
        got, p = as_tuple(kernel()), as_tuple(plain())
        # the mixer's input planes in float64, for its outputs' share
        cut = None
        if name in ("ln_mixer_head", "global_mixer"):
            x = tensors[0].double()
            if name == "ln_mixer_head":
                x = channel_layer_norm(x, tensors[1].double(),
                                       tensors[2].double())[:, x.shape[1]
                                                            // 2:]
            cut = mixer_cut_planes(x)
        worst, shares, within, near, ties_ok = bf16_outputs(
            name, tensors, got, p, cut)
        if not ties_ok:
            failures.append(f"{name} {shape} {label}: near ties")
        ok = all(v >= BF16_EQUAL for v in shares)
        if cut is not None:
            ok = ok and cut.float().mean().item() <= BF16_CUT_SHARE
        ok = ok and (min(within) >= BF16_EQUAL if name == "lgb_block"
                     else worst <= 0)
        if not ok:
            failures.append(f"{name} {shape} {label}")
        if name == "lgb_block":
            x, blk = tensors
            chain = level2_chain(x, blk, BF16)
            d = (got[0].float() - chain.float()).abs().max().item()
            print(f"kernel {name:17s} {shape:14s} bf16 {label:14s} vs the "
                  f"level-2 chain in the same storage: max-abs {d:.3e}, "
                  f"bit-equal {torch.equal(got[0], chain)}")
        bound_ms, bound_by = bound(name, tensors, got)
        # CUPTI has dropped events of a short window (a B1 call read 0.0017
        # ms, below its bound, once on an H100): trace again then
        for _attempt in range(3):
            ms = device_profile(kernel, n=20)["busy_ms_per_call"]
            if ms >= bound_ms:
                break
        else:
            raise AssertionError(f"bf16 {name} {shape} {label}: device "
                                 f"time {ms:.4f} ms below its bound")
        plain_ms = time_ms(plain)
        f32_ms = record.get(name, {}).get("by_shape", {}).get(
            f32_shape, {}).get("ms", float("nan"))
        equal = (", ".join(f"{v:.5f}" for v in shares) or "(float32 out)"
                 ) + near
        if cut is not None:
            equal += (f" (mixer planes set aside: {int(cut.sum())} of "
                      f"{cut.numel()}, BF16_CUT)")
        print(f"kernel {name:17s} {shape:14s} bf16 {label:14s} "
              f"{'ok' if ok else 'FAILED'}: |k - p| beyond {BF16_REL:.3e} "
              f"|p| + {KERNEL_REL_TOL:g} max|p| at most {worst:.3e} max|p| "
              f"(within: {', '.join(f'{v:.5f}' for v in within)}); equal "
              f"to bf16(p) {equal}  kernel {ms:.4f} ms (float32 entry "
              f"{f32_ms:.4f})  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} "
              f"ms ({bound_by}; roofline share {bound_ms / ms:.3f})  [{card}]")
        rec = record.setdefault(name, {}).setdefault("bf16", {})
        rec[f"{shape} {label}"] = {"ms": ms, "float32_ms": f32_ms,
                                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                                   "bound_by": bound_by,
                                   "equal_share": shares, "within": within,
                                   "worst": worst}
    print("bf16 entries launched: "
          + ", ".join(f"{k} {fn.launches}" for k, fn in wrappers.items()
                      if fn.launches))
    if failures:
        raise AssertionError(f"bf16 entries off their plain versions: "
                             f"{failures}")


def bf16_methods(cfg, env: dict):
    """cfg's method (UnlgFormer, or another of the zoo) on the card and on
    the CPU under `env`, the card's with seeded weights (Runner.init) and
    the CPU's a copy of them."""
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner
    with mock.patch.dict(os.environ, env):
        method = build_model(cfg.model_type, cfg, device="cuda")
        cpu = build_model(cfg.model_type, cfg, device="cpu")
    runner = Runner(cfg, method, "cuda").init(SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    return runner, cpu


def run_bf16_forward(card: str, profile: bool) -> None:
    """UnlgFormer's eval forward in each bf16 mode at each of BF16_LEVELS
    (seeded weights, batch BF16_BATCH): launches per forward, device
    kernels per forward, the mode's drift from float32 storage (the CPU
    plain path's; BF16_DRIFT_*), card vs the CPU plain path in the same
    mode against the CPU plain path's own spread when its input moves by
    one float32 rounding (BF16_SPREAD; the quarter of the drift,
    BF16_CARD_CPU, printed), and level 3 and v2 bit-equal to level 2 on
    the card. Then batch-1 latency and batch-16 images/s at level 2 in
    each mode (float32 storage in the same turns), and the scene
    engine's MP/s under bf16res at tile 144 / halo 8."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import eval_batches
    from lgteun_tpu_torch.parallel.scene import fuse_scene

    cfg = load_config(os.path.join(CONFIGS, "unlg_former.py"))
    ds = SceneDataset(16, cfg.ms_chans, SEED)
    first = {k: v[:BF16_BATCH] for k, v in next(eval_batches(
        ds, BF16_BATCH))[0].items() if k != "image_id"}
    bumped = {k: (v * (1 + 2.0 ** -23)).astype(np.float32)
              for k, v in first.items()}
    base = {"LGTEUN_EVAL_DTYPE": "", "LGTEUN_FUSED_ATTENTION": "1"}
    runner, cpu = bf16_methods(cfg, dict(base, LGTEUN_FUSE_LEVEL="2"))
    ref_card = runner.predict(runner.to_device(first)).cpu()
    ref = cpu.apply(first)
    scale = ref.abs().max().item()
    failures = []
    for mode in BF16_MODES:
        level2 = None
        for label, env, per_forward in BF16_LEVELS:
            tag = f"bf16 {mode} {label}"
            runner, cpu = bf16_methods(cfg, dict(base, LGTEUN_EVAL_DTYPE=mode,
                                                 **env))
            batch = runner.to_device(first)
            runner.predict(batch)
            torch.cuda.synchronize()
            wrappers = reset_launches()
            got = runner.predict(batch)
            torch.cuda.synchronize()
            counted = check_launches(tag, wrappers, per_forward, 1)
            got = got.cpu()
            want, moved = cpu.apply(first), cpu.apply(bumped)
            if got.dtype != torch.float32 or not torch.isfinite(got).all():
                raise AssertionError(f"{tag}: output {got.dtype} not finite "
                                     "float32")
            drift = (want - ref).abs()
            card_drift = (got - ref_card).abs()
            gap = (got - want).abs().mean().item()
            spread = (moved - want).abs().mean().item()
            kernels = device_profile(lambda: runner.predict(batch),
                                     n=3)["kernels_per_call"]
            level2 = got if level2 is None else level2
            same = torch.equal(got, level2)
            d_mean = drift.mean().item()
            print(f"{tag}: launches per forward "
                  f"{ {k: counted[k] for k in per_forward} }, "
                  f"{kernels:g} device kernels a forward; drift from float32 "
                  f"(cpu plain) mean {d_mean:.3e} max "
                  f"{drift.max().item():.3e} (scale {scale:.3f}; card "
                  f"mean {card_drift.mean().item():.3e} max "
                  f"{card_drift.max().item():.3e}); mean|card - cpu plain| "
                  f"{gap:.3e} = {gap / spread:.3f} of the cpu plain path's "
                  f"own spread at a one-rounding input change ({spread:.3e}"
                  f"; bound {BF16_SPREAD}) = {gap / d_mean:.3f} of the drift"
                  f" (the quarter, {BF16_CARD_CPU}, "
                  f"{'met' if gap <= BF16_CARD_CPU * d_mean else 'not met'})"
                  f"; bit-equal to level 2 on the card: {same}  [{card}]")
            if not (d_mean <= BF16_DRIFT_MEAN * scale
                    and drift.max().item() <= BF16_DRIFT_MAX * scale):
                failures.append(f"{tag}: drift outside the envelope")
            if not (gap <= BF16_SPREAD * spread and card_drift.mean().item()
                    <= BF16_SPREAD * d_mean):
                failures.append(f"{tag}: card vs cpu {gap:.3e}, card drift "
                                f"{card_drift.mean().item():.3e}")
            if label in ("level 3", "v2") and not same:
                failures.append(f"{tag}: not level 2's bits")
            if profile and label == "level 2":
                print_profile(f"bf16 {mode} level 2 batch-{BF16_BATCH}",
                              device_profile(lambda: runner.predict(batch)),
                              card)

    # speed at level 2: float32, bf16res, bf16 storage in turns
    items = next(eval_batches(ds, cfg.eval_batch_size))[0]
    runners = {}
    for mode in ("",) + BF16_MODES:
        runners[mode] = bf16_methods(cfg, dict(
            base, LGTEUN_EVAL_DTYPE=mode, LGTEUN_FUSE_LEVEL="2"))[0]
    b1 = runners[""].to_device({k: v[:1] for k, v in items.items()
                                if k != "image_id"})
    b16 = runners[""].to_device(items)
    lat, ips = collections.defaultdict(list), collections.defaultdict(list)
    for mode in ("",) + BF16_MODES + BF16_MODES[::-1] + ("",):
        run = runners[mode]
        for _ in range(3):
            run.predict(b1)
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.predict(b1)
            torch.cuda.synchronize()
            lat[mode].append(time.perf_counter() - t0)
        ips[mode].append(cfg.eval_batch_size / (time_ms(
            lambda: run.predict(b16), iters=10) / 1e3))
    for mode in ("",) + BF16_MODES:
        print(f"bf16 speed {mode or 'float32'} level 2: batch-1 latency "
              f"median {statistics.median(lat[mode]) * 1e3:.3f} ms; batch-"
              f"{cfg.eval_batch_size} {statistics.mean(ips[mode]):.1f} "
              f"images/s (turns {', '.join(f'{v:.1f}' for v in ips[mode])})"
              f"  [{card}]")
        if profile:
            print_profile(f"bf16 {mode or 'float32'} level 2 batch-"
                          f"{cfg.eval_batch_size}", device_profile(
                              lambda: runners[mode].predict(b16)), card)

    # the scene engine under bf16res at tile 144 / halo 8
    sc = 2.0 ** cfg.bit_depth - 0.5
    lr, pan = synthetic_scene(SCENE, cfg.ms_chans, SEED)
    lr_d = torch.from_numpy(lr / sc).cuda()
    pan_d = torch.from_numpy(pan / sc).cuda()
    for mode in ("", "bf16res"):
        method = runners[mode].method
        run = lambda: fuse_scene(method, lr_d, pan_d, tile=144, halo=8,
                                 batch=SCENE_BATCH)
        run()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("bf16 scene: output not finite")
        print(f"bf16 scene {mode or 'float32'} {SCENE}x{SCENE} tile 144 halo "
              f"8: {SCENE * SCENE / statistics.median(times) / 1e6:.2f} MP/s "
              f"(median of 3)  [{card}]")
    if failures:
        raise AssertionError(f"bf16 forward: {failures}")


def run_bf16_zoo(card: str) -> None:
    """Each of BF16_ZOO under LGTEUN_EVAL_DTYPE=bf16 on the card, seeded
    weights, batch BF16_BATCH: the kernels launched a forward (every
    other counter 0), finite float32 output, the mode's drift from
    float32 (the CPU plain path's) inside BF16_DRIFT_*, card vs CPU plain
    in the mode within BF16_SPREAD of the CPU plain path's own spread at
    a one-bf16-step input change (BF16_ZOO_STEP), the card's own drift
    within BF16_SPREAD of the CPU's; MutInf bit-equal to its float32
    output. Then batch-1 latency and batch-16 images/s, float32 and
    bf16 in turns (printed only)."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import eval_batches

    failures = []
    for config, env, per_forward, n_cmp in BF16_ZOO:
        cfg = load_config(os.path.join(CONFIGS, config))
        tag = f"bf16 zoo {cfg.model_type}" + "".join(
            f" ({k}={v})" for k, v in env.items())
        ds = SceneDataset(cfg.eval_batch_size, cfg.ms_chans, SEED)
        items = next(eval_batches(ds, cfg.eval_batch_size))[0]
        first = {k: v[:BF16_BATCH] for k, v in items.items()
                 if k != "image_id"}
        cmp_ = {k: v[:n_cmp] for k, v in first.items()}
        stepped = {k: bf16_step(v) for k, v in cmp_.items()}
        runs = {}
        for mode in ("", "bf16"):
            runs[mode] = bf16_methods(cfg, dict(env, LGTEUN_EVAL_DTYPE=mode))
        runner, cpu = runs["bf16"]
        batch = runner.to_device(first)
        runner.predict(batch)
        torch.cuda.synchronize()
        wrappers = reset_launches()
        got = runner.predict(batch)
        torch.cuda.synchronize()
        counted = check_launches(tag, wrappers, per_forward, 1)
        got = got.cpu()
        ref_card = runs[""][0].predict(batch).cpu()
        if got.dtype != torch.float32 or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: output {got.dtype} not finite "
                                 "float32")
        if cfg.model_type == "MutInf":
            same = torch.equal(got, ref_card)
            print(f"{tag}: launches {sum(counted.values())}, float32 as in "
                  f"JAX (eval_dtype {runner.method.eval_dtype}); bit-equal to "
                  f"its float32 output: {same}  [{card}]")
            if not same:
                failures.append(f"{tag}: not float32's bits")
        else:
            ref = runs[""][1].apply(cmp_)
            want, moved = cpu.apply(cmp_), cpu.apply(stepped)
            scale = ref.abs().max().item()
            drift = (want - ref).abs()
            card_drift = (got - ref_card).abs()
            d_mean = drift.mean().item()
            gap = (got[:n_cmp] - want).abs().mean().item()
            spread = (moved - want).abs().mean().item()
            print(f"{tag}: launches per forward "
                  f"{ {k: counted[k] for k in per_forward} }; drift from "
                  f"float32 (cpu plain, {n_cmp} image(s)) mean {d_mean:.3e}"
                  f" max {drift.max().item():.3e} (scale {scale:.3f}; card "
                  f"mean {card_drift.mean().item():.3e} max "
                  f"{card_drift.max().item():.3e}); mean|card - cpu plain| "
                  f"{gap:.3e} = {gap / max(spread, 1e-30):.3f} of the cpu "
                  f"plain path's own spread at a one-bf16-step input change"
                  f" ({spread:.3e}; bound {BF16_SPREAD}) = "
                  f"{gap / max(d_mean, 1e-30):.3f} of the drift  [{card}]")
            if not (d_mean <= BF16_DRIFT_MEAN * scale
                    and drift.max().item() <= BF16_DRIFT_MAX * scale):
                failures.append(f"{tag}: drift outside the envelope")
            if not (gap <= BF16_SPREAD * spread and card_drift.mean().item()
                    <= BF16_SPREAD * d_mean):
                failures.append(f"{tag}: card vs cpu {gap:.3e} (spread "
                                f"{spread:.3e}), card drift "
                                f"{card_drift.mean().item():.3e}")

        # speed: float32 and bf16 in turns (printed only)
        b1 = runner.to_device({k: v[:1] for k, v in items.items()
                               if k != "image_id"})
        b16 = runner.to_device(items)
        lat, ips = collections.defaultdict(list), collections.defaultdict(
            list)
        for mode in ("", "bf16", "bf16", ""):
            run = runs[mode][0]
            for _ in range(2):
                run.predict(b1)
            for _ in range(BF16_ZOO_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run.predict(b1)
                torch.cuda.synchronize()
                lat[mode].append(time.perf_counter() - t0)
            ips[mode].append(cfg.eval_batch_size / (time_ms(
                lambda: run.predict(b16), iters=3, warmup=1) / 1e3))
        print(f"{tag} speed: batch-1 latency median float32 "
              f"{statistics.median(lat['']) * 1e3:.3f} ms, bf16 "
              f"{statistics.median(lat['bf16']) * 1e3:.3f} ms; batch-"
              f"{cfg.eval_batch_size} images/s float32 "
              f"{statistics.mean(ips['']):.1f}, bf16 "
              f"{statistics.mean(ips['bf16']):.1f} (turns float32 "
              f"{', '.join(f'{v:.1f}' for v in ips[''])}, bf16 "
              f"{', '.join(f'{v:.1f}' for v in ips['bf16'])})  [{card}]")
    if failures:
        raise AssertionError(f"bf16 zoo: {failures}")


def bf16_step(a: np.ndarray) -> np.ndarray:
    """Each value of a non-negative float32 array moved to the next
    bfloat16 value above its own rounding: the blanket cast rounds the
    inputs to bf16, so a float32 rounding of them is lost, and one bf16
    step is the cast's own input rounding."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
    return (t.view(torch.int16) + 1).view(BF16).float().numpy()


def run_bf16_quality(card: str) -> None:
    """Port-trained weights (QUALITY_ITERS iterations of the shipped
    config, batch 4, on QUALITY_TRAIN synthetic WV-3 pairs), then PSNR
    with the float64 oracle (metrics/numpy_ref) on QUALITY_SCENES
    held-out scenes: float32 storage at level 2, bf16res and bf16 at
    levels 1, 2 and 3; bf16res within QUALITY_BUDGET_DB of float32 at
    every level (bf16's are printed: see QUALITY_*).
    Also: the first training step under
    LGTEUN_EVAL_DTYPE=bf16res has the loss of float32 storage, bit for
    bit (training ignores the mode)."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.dataset import PSDataset
    from lgteun_tpu_torch.data.pipeline import (data_denormalize,
                                                eval_batches, train_iterator)
    from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
    from lgteun_tpu_torch.metrics import numpy_ref
    from lgteun_tpu_torch.runner import Runner

    cfg = load_config(os.path.join(CONFIGS, "unlg_former.py"))
    root = os.path.join(REPO, "build", "chip_smoke", "quality")
    dirs = make_synthetic_dataset(root, QUALITY_TRAIN, QUALITY_SCENES,
                                  bands=cfg.ms_chans, size=128,
                                  seed=SEED + 7, sensor="WV3")
    train_ds = PSDataset([dirs["train"]], bit_depth=cfg.bit_depth)
    test_ds = PSDataset([dirs["test"]], bit_depth=cfg.bit_depth)

    # training ignores the mode: the first step's loss, bit for bit
    losses = {}
    batch = next(train_iterator(train_ds, cfg.train_set_cfg.batch_size,
                                bit_depth=cfg.bit_depth, seed=SEED))
    for mode in ("", "bf16res"):
        runner = Runner(cfg, train_method(cfg, {"LGTEUN_EVAL_DTYPE": mode}),
                        "cuda").init(SEED).set_optim()
        losses[mode] = runner.train_step(runner.to_device(batch), 0)
    a, b = losses[""]["full_loss"], losses["bf16res"]["full_loss"]
    same = torch.equal(a, b)
    print(f"bf16 train: first step's loss float32 storage {a.item():.9g}, "
          f"under LGTEUN_EVAL_DTYPE=bf16res {b.item():.9g}; bit-equal "
          f"{same}")
    if not same:
        raise AssertionError("bf16 train: the mode changed a training step")

    cfg.max_iter, cfg.log_freq, cfg.work_dir = QUALITY_ITERS, 200, root
    cfg.save_freq = cfg.eval_freq = cfg.test_freq = 0
    runner = Runner(cfg, train_method(cfg), "cuda", train_ds=train_ds).init(
        SEED).set_optim()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    print(f"bf16 quality: {QUALITY_ITERS} iterations at batch "
          f"{cfg.train_set_cfg.batch_size} on {len(train_ds)} synthetic WV-3 "
          f"pairs in {time.perf_counter() - t0:.1f} s; l1 "
          f"{runner.loss_log[0][1]['rec_loss']:.5f} -> "
          f"{runner.loss_log[-1][1]['rec_loss']:.5f}  [{card}]")
    state = {k: v.detach().clone() for k, v in
             runner.method.module.state_dict().items()}
    dr = 2.0 ** cfg.bit_depth - 0.5

    def score(env: dict) -> float:
        method = train_method(cfg, env)
        method.load_state_dict(state)
        method.eval()
        vals = []
        for b, n_valid in eval_batches(test_ds, cfg.eval_batch_size,
                                       bit_depth=cfg.bit_depth):
            pred = method.apply({k: torch.from_numpy(v).cuda() for k, v in
                                 b.items() if k != "image_id"})
            pred = data_denormalize(pred, cfg.bit_depth).double().cpu()
            tgt = data_denormalize(torch.from_numpy(b["target"]),
                                   cfg.bit_depth).double()
            vals += [numpy_ref.psnr(pred[i].numpy(), tgt[i].numpy(),
                                    dynamic_range=dr)
                     for i in range(n_valid)]
        return float(np.mean(vals))

    base = score({"LGTEUN_FUSE_LEVEL": "2", "LGTEUN_EVAL_DTYPE": ""})
    failures = []
    print(f"bf16 quality: float32 storage level 2 PSNR {base:.5f} dB "
          f"(float64 oracle, {QUALITY_SCENES} scenes)")
    for mode in BF16_MODES:
        for level in ("1", "2", "3"):
            got = score({"LGTEUN_FUSE_LEVEL": level,
                         "LGTEUN_EVAL_DTYPE": mode})
            delta = got - base
            held = mode == "bf16res"
            where = "in" if abs(delta) <= QUALITY_BUDGET_DB else "outside"
            print(f"bf16 quality: {mode} level {level} PSNR {got:.5f} dB, "
                  f"delta {delta:+.5f} dB"
                  + (f" (budget {QUALITY_BUDGET_DB})" if held else
                     f" (printed: {where} the {QUALITY_BUDGET_DB} dB budget, "
                     "not held to it)")
                  + f"  [{card}]")
            if held and not abs(delta) <= QUALITY_BUDGET_DB:
                failures.append(f"bf16res level {level} {delta:+.5f} dB")
    if failures:
        raise AssertionError(f"bf16 quality: {failures}")


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

    # float32 storage everywhere but in the bf16 phases, which set the
    # mode themselves
    mode = os.environ.pop("LGTEUN_EVAL_DTYPE", None)
    if mode is not None:
        print(f"LGTEUN_EVAL_DTYPE={mode!r} ignored: the bf16 phases run "
              "each storage mode themselves")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s")
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(sh(_cuda.find_nvcc(), "--version").splitlines()[-1])
    print(f"card: {card}")

    started = time.perf_counter()

    def phase_done(name: str) -> None:
        print(f"phase {name} done at {time.perf_counter() - started:.1f} s")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _cuda.build_library()
    _cuda.kernels()
    print(f"build: {lib_path.name} ({' '.join(_cuda.NVCC_FLAGS)}) "
          f"in {time.perf_counter() - t0:.1f} s")
    print_ptxas(lib_path)
    print_sass(lib_path)

    # 2. each kernel vs its plain version (TF32 off for the plain convs
    #    and matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    record, lgb_inputs = {}, {}
    wrappers = reset_launches()
    for name, shape, kernel, plain, args in kernel_cases(gen):
        got, want = kernel(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if "-const" in shape:
            # against the CPU plain version, which keeps those bins
            # exactly zero (the card's plain line is printed)
            cpu, evidence = const_plane_cpu(name, shape, kernel, plain,
                                            args, got, want)
            print(f"kernel {name:17s} {shape:14s} card plain vs CPU plain "
                  f"{rel_err(want, cpu)[0]:.3e}")
            print(evidence)
            want = cpu
        if name in ("texture_match", "patch_match"):
            rel, ab = check_search(name, shape, got, want, args)
        else:
            rel, ab = rel_err(got, want)
        event_ms, plain_ms = in_turns(lambda: plain(*args),
                                      lambda: kernel(*args))
        ms = device_profile(lambda: kernel(*args), n=20)["busy_ms_per_call"]
        bound_ms, bound_by = bound(name, args, want)
        print(f"kernel {name:17s} {shape:14s} rel err {rel:.3e} "
              f"(max-abs {ab:.3e})  kernel {ms:.4f} ms (device; events "
              f"{event_ms:.4f})  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by}; roofline share "
              f"{bound_ms / ms:.3f})")
        if not rel <= KERNEL_REL_TOL:
            raise AssertionError(f"{name} {shape}: rel err {rel:.3e} > "
                                 f"{KERNEL_REL_TOL}")
        rec = record.setdefault(name, {"max_abs_err": 0.0, "by_shape": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        rec["by_shape"][shape] = {"rel_err": rel, "ms": ms,
                                  "event_ms": event_ms,
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by}
        if name in ("ln_mixer_head", "global_mixer") and "-" not in shape:
            yard = cufft_ms(mixer_planes(name, args))
            print(f"kernel {name:17s} {shape:14s} cuFFT rfft2 + irfft2 on "
                  f"the same planes {yard:.4f} ms (a yardstick only)")
            rec["by_shape"][shape]["cufft_ms"] = yard
        if name == "lgb_block":
            chain = device_profile(lambda: level2_chain(*args),
                                   n=20)["busy_ms_per_call"]
            print(f"kernel {name:17s} {shape:14s} the level-2 chain B1 -> "
                  f"B2 -> B3 on the same inputs {chain:.4f} ms (device; a "
                  f"yardstick only): B8 / chain {ms / chain:.3f}")
            rec["by_shape"][shape]["chain_ms"] = chain
            lgb_inputs[shape] = args
        if name in ("texture_match", "patch_match"):
            yard = bmm_ms(*search_inputs(name, args))
            print(f"kernel {name:17s} {shape:14s} torch.bmm of the "
                  f"normalised vectors (the correlation alone, no first-max)"
                  f" {yard:.4f} ms (a yardstick only)")
            rec["by_shape"][shape]["bmm_ms"] = yard
        if name in ("lgb_block", "window_attention", "lightnet_stack",
                    "neighborhood_attention") or (
                name == "ln_mixer_head" and "-" not in shape):
            same = all(all(map(torch.equal, as_tuple(kernel(*args)), got))
                       for _ in range(REPEATS))
            print(f"kernel {name:17s} {shape:14s} {REPEATS} more launches "
                  f"on the same inputs bit-identical: {same}")
            if not same:
                raise AssertionError(f"{name} {shape}: not deterministic")
        if name in ("texture_match", "patch_match",
                    "neighborhood_attention"):
            print(f"kernel {name:17s} {shape:14s} branch "
                  f"{search_branch(name, args)}")
        if on_tensor_cores(name, args):
            fp32_ms = bound(name, args, want, fp32_only=True)[0]
            tflops = kernel_flops(name, args) / ms / 1e9
            print(f"kernel {name:17s} {shape:14s} tensor-core bound "
                  f"{bound_ms:.4f} ms (3xTF32 products at "
                  f"{TF32_FLOPS_PER_S / 1e12:g} TFLOP/s, the rest at "
                  f"{FP32_FLOPS_PER_S / 1e12:g}; share {bound_ms / ms:.3f}; "
                  f"all at the FP32 rate {fp32_ms:.4f} ms)  achieved "
                  f"{tflops:.2f} TFLOP/s")
            rec["by_shape"][shape].update(fp32_bound_ms=fp32_ms,
                                          tflops=tflops)

    check_branches(wrappers)
    # 2b. the bf16 storage entries against their plain versions
    run_bf16_kernels(torch.Generator().manual_seed(SEED + 5), record, card)
    check_search_rule()
    check_na_rule()
    check_lightnet_layout(gen)
    check_lgb_grids(lgb_inputs)
    check_tail_layout(gen)
    check_fft_tables()
    phase_done("kernels")

    # 3. the differentiable wrappers against plain autograd, and the bf16
    #    training entries of B10-B12
    run_autograd(torch.Generator().manual_seed(SEED + 2), card)
    run_bf16_train_entries(torch.Generator().manual_seed(SEED + 8), card)
    phase_done("autograd")

    # 4. each slice: shipped config, seeded weights, Runner.test
    #    (a kernel's launches are those of the first path that runs it)
    launches = {}
    for config, per_forward, abs_tol, n_cmp, env, n_images in SLICES:
        counted = run_slice(os.path.join(CONFIGS, config), per_forward,
                            abs_tol, n_cmp, env, n_images, card,
                            opts.profile)
        for k in per_forward:
            launches.setdefault(k, counted[k])

    phase_done("slices")
    # 4b. a 16-band UnlgFormer (the wide tail at its bottleneck)
    run_sixteen_bands(card)
    # 4c. UnlgFormer's bf16 storage modes at every level
    run_bf16_forward(card, opts.profile)
    # 4d. the rest of the zoo under LGTEUN_EVAL_DTYPE=bf16
    run_bf16_zoo(card)
    phase_done("bf16")

    # 5. the scene engine, then the CLI on the same scene
    method = run_scene(card, opts.profile)
    run_cli(method, card)
    phase_done("scene")

    # 6. training: Runner.train on a synthetic dataset, resume, card vs
    #    CPU gradients, the other routes' training steps
    train_ds, counted = run_training(card, opts.profile)
    launches["block_tail_masked"] = counted["block_tail_masked"]
    launches.setdefault("window_attention_rows", 0)   # on no model path
    run_grad_split(train_ds, card)
    run_train_variants(train_ds, card)
    phase_done("training")
    # 6b. the rest of the zoo trains: LightNet, MDCUN, INNT (B9-B12 through
    #     their recompute entries), SFIIN and MutInf
    run_zoo_training(train_ds, card, opts.profile)
    phase_done("zoo training")
    # 6c. the JAX Runner's other training modes: remat, mixed_precision
    #     (UnlgFormer's selective mode and the zoo's blanket cast) and
    #     adversarial training (with the QNR loss)
    run_remat(train_ds, card)
    run_mixed(train_ds, card)
    run_adversarial(train_ds, card)
    phase_done("training modes")
    # 6d. bf16 storage with port-trained weights; training ignores it
    run_bf16_quality(card)
    phase_done("bf16 quality")

    # 7. the evaluation entry point: main.cli --test-only, both splits,
    #    UnlgFormer and the classical methods
    runs = run_main(card)
    phase_done("main")
    # 7b. the reference's released-weights workflow on the main phase's
    #     weights; the native TIFF codec and the Wald degradation
    run_reference(runs, card)
    run_data(card)
    phase_done("reference")
    # 8. data parallelism: NCCL at world 1, two gloo ranks on the card;
    #    the same spawn runs the space and large phases' height-sharded
    #    forwards
    space, large = space_jobs(), large_space_jobs()
    results = run_mesh(train_ds, card, space + large)
    phase_done("mesh")
    # 9. height-sharded eval forwards (`parallel/spatial.py`) against the
    #    whole forward on the card
    run_space(space, [r[:len(space)] for r in results], card)
    phase_done("space")
    # 10. planes above 240^2: the mixer's cluster and global routes, B8 by
    #     shape, whole tiles, the scene at tile 256 and whole, sharded
    #     512^2 forwards
    large_routes, large_record = run_large(
        card, large, [r[len(space):] for r in results])
    # a route's launches on the path that runs it: the cluster's in a
    # level-2 forward at PAN 512^2, the global route's on a whole 1024^2
    # tile
    launches["fft_mixer_cluster"] = large_routes[
        f"large UnlgFormer {LARGE_SIDE}^2 level 2"]["cluster"]
    launches["fft_mixer_global"] = large_routes[
        "large UnlgFormer whole tile 1024"]["global"]
    for name, rec in large_record.items():
        mine = record.setdefault(name, {"max_abs_err": 0.0, "by_shape": {}})
        mine["max_abs_err"] = max(mine["max_abs_err"], rec["max_abs_err"])
        mine["by_shape"].update(rec["by_shape"])
    phase_done("large")

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
                        "by_shape": rec["by_shape"],
                        "bf16_by_shape": rec.get("bf16", {})})
    # the mixer's cluster and global routes (B1 and B4 above 240^2), each
    # a route of its own
    for name, (src, replaces, main_shape, no_library) in \
            LARGE_ROUTES.items():
        rec = record[name]
        full = rec["by_shape"][main_shape]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"], "ms": full["ms"],
                        "plain_ms": full["plain_ms"],
                        "bound_ms": full["bound_ms"],
                        "bound_by": full["bound_by"], "library_ms": None,
                        "library": f"none: {no_library}",
                        "launches_a_forward_by_path": {
                            path: routes.get(name[len("fft_mixer_"):], 0)
                            for path, routes in large_routes.items()},
                        "by_shape": rec["by_shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes (on the host)."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:10]


def cpu_identity() -> str:
    """The CPU side of the plain path: torch's kernel capability, MKL,
    the thread count and the CPU model."""
    fields = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                fields.setdefault(key.strip(), value.strip())
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
        if k in fields) or platform.processor() or "unknown"
    return (f"capability {torch.backends.cpu.get_cpu_capability()}, mkl "
            f"{torch.backends.mkl.is_available()}, threads "
            f"{torch.get_num_threads()}, {model}")


def const_plane_cpu(name, shape, kernel, plain, args, got,
                    card_plain) -> tuple:
    """ROADMAP C.33: the CPU plain output of a constant-plane mixer case
    and one line of evidence on it: hashes of the input, the kernel's
    output, the card's and the CPU's plain output; the kernel's bits over
    REPEATS more launches; the CPU side's identity; the plain version's
    stages (the mixer's planes, their rfft2 with the exact zero bins, the
    mixed spectrum, the output) in this first CPU run, in a second one
    and in one on 1 thread, with the first stage where the second or the
    1-thread run differs from the first; the planes' values off the
    constant and the FFT library's own non-zero bins along it."""
    from lgteun_tpu_torch.ops.norm import channel_layer_norm
    from lgteun_tpu_torch.ops.spectral_kernel import (mixer_inverse,
                                                      mixer_spectrum,
                                                      plane_rfft2)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    axis = -2 if shape.endswith("H") else -1

    def run():
        out = as_tuple(plain(*cpu_args))
        x = cpu_args[0]
        mix = cpu_args[3:] if name == "ln_mixer_head" else cpu_args[1:]
        if name == "ln_mixer_head":
            x = channel_layer_norm(x, cpu_args[1], cpu_args[2])[
                :, x.shape[1] // 2:]
        raw = torch.fft.rfft2(x)
        z = plane_rfft2(x)
        spec = mixer_spectrum(z, x.shape[-1], *mix)
        stages = (x, z, spec, mixer_inverse(spec, x.shape[-1]), out[-1])
        return out, stages, (int((x != x.narrow(axis, 0, 1)).sum()), int(
            (raw.narrow(axis, 1, raw.shape[axis] - 1) != 0).sum()))

    first, stages1, counts1 = run()
    _, stages2, counts2 = run()
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        _, stages_t1, counts_t1 = run()
    finally:
        torch.set_num_threads(threads)
    labels = ("planes", "rfft2", "spectrum", "stages' output", "output")

    def differs(other):
        return next((lab for lab, a, b in zip(labels, stages1, other)
                     if not torch.equal(a, b)), "none")
    hashes = {digest(*as_tuple(kernel(*args))) for _ in range(REPEATS)}
    line = (f"c33 {name} {shape}: input {digest(args[0])} kernel "
            f"{digest(*got)} card plain {digest(*card_plain)} cpu plain "
            f"{digest(*first)}; kernel over {REPEATS} launches "
            f"{'same bits' if hashes == {digest(*got)} else sorted(hashes)}; "
            f"cpu {cpu_identity()}; first stage that differs from the first "
            f"CPU run: a second run {differs(stages2)}, on 1 thread "
            f"{differs(stages_t1)}; planes off the constant, the FFT "
            f"library's non-zero bins along it: {counts1}, {counts2}, "
            f"{counts_t1}; the stages give the plain output: "
            f"{torch.equal(stages1[3], stages1[4])}")
    return tuple(t.cuda() for t in first), line


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def mixer_planes(name: str, args) -> torch.Tensor:
    """The planes the FFT mixer of B1 (the second half of the LN
    output's channels) or B4 transforms, for the cuFFT yardstick."""
    x = args[0]
    return x[:, x.shape[1] // 2:].contiguous() if name == "ln_mixer_head" \
        else x


def cufft_ms(planes: torch.Tensor) -> float:
    """Device ms of torch.fft.rfft2 + irfft2 (cuFFT) on the planes: a
    yardstick of the transforms alone, two library calls without the
    mixer between them (not the same function, not used by the port)."""
    size = planes.shape[-2:]
    return device_profile(lambda: torch.fft.irfft2(torch.fft.rfft2(planes),
                                                   s=size),
                          n=20)["busy_ms_per_call"]


def level2_chain(x, blk, storage=None):
    """The level-2 chain B1 -> B2 -> B3 on the whole block's inputs (2
    heads, 8x8 windows): what `lgb_block` computes in three launches;
    `storage`: the branches' dtype (None: x's)."""
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail
    from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head
    from lgteun_tpu_torch.ops.window_attention import window_attention
    y1, x2 = ln_mixer_head(x, *(blk[k] for k in ("ln_w", "ln_b", "amp_w",
                                                 "amp_b", "pha_w", "pha_b")),
                           out_dtype=storage)
    x1 = window_attention(y1, blk["wqkv"], blk["bqkv"], blk["pos"], 2, 8)
    return block_tail(x, x1, x2, blk["proj_w"], blk["proj_b"], blk["ffn"])


def bmm_ms(lr_n, ref_n) -> float:
    """Device ms of torch.bmm(lr_n, ref_n^T) in float32: the searches'
    correlation alone ([N, L, K] x [N, K, L]), a yardstick for rows 10
    and 11 (no library call also takes the first max and gathers)."""
    a = lr_n.float().contiguous()
    bt = ref_n.float().transpose(1, 2).contiguous()
    return device_profile(lambda: torch.bmm(a, bt), n=20)["busy_ms_per_call"]


# the whole block's shapes whose output must not depend on the grid, and
# the grids (blocks) held to the full grid's bits
LGB_GRID_SHAPES = ("4x32x128x128", "4x128x64x64")
LGB_GRIDS = (1, 3, 17)


def check_lgb_grids(lgb_inputs: dict) -> None:
    """B8 on grids of LGB_GRIDS blocks bit-equal to the full grid (one
    block an SM) at LGB_GRID_SHAPES: the work list gives the same bits
    wherever and whenever an item runs, and one block runs it in order."""
    from lgteun_tpu_torch.ops.lgb_block_kernel import _launch
    for shape in LGB_GRID_SHAPES:
        x, blk = lgb_inputs[shape]
        full = _launch(x, blk, 2, 8, 1e-5, 0)
        same = {}
        for blocks in LGB_GRIDS:
            t0 = time.perf_counter()
            got = _launch(x, blk, 2, 8, 1e-5, blocks)
            torch.cuda.synchronize()
            same[blocks] = (torch.equal(got, full),
                            round((time.perf_counter() - t0) * 1e3, 1))
        print(f"kernel lgb_block         {shape:14s} grids of "
              f"{', '.join(map(str, LGB_GRIDS))} blocks bit-equal to the "
              f"full grid (host ms): {same}")
        if not all(v[0] for v in same.values()):
            raise AssertionError(f"lgb_block {shape}: the output depends on "
                                 f"the grid: {same}")


# kernels whose products run as mma.sync on the tensor cores: their SASS
# must hold HMMA instructions
MMA_KERNELS = ("lightnet_group_kernel", "na_tc_kernel")


def print_sass(lib_path) -> None:
    """Local-memory loads and stores (LDL / STL) in the SASS of the whole
    block's kernel (its calls, the mixer's plane and the tail's tile,
    included): in all, and between the attention's raising setmaxnreg and
    the one that returns the registers (the window items' region); in
    the searches' tensor-core kernels, with their wgmma (HGMMA) count;
    and in LightNet's and the neighbourhood attention's kernels
    (MMA_KERNELS), with their mma.sync (HMMA) count, which must not be
    0."""
    import re
    from lgteun_tpu_torch.ops import _cuda
    cuobjdump = os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    mma = collections.Counter()
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        head = fn.split("\n", 1)[0]
        search = next((k for k in ("tm_tc_kernel", "pm_tc_kernel")
                       if k in head), None)
        bf16 = "<bf16>" if "nv_bfloat16" in head else ""
        if search:
            local = len(re.findall(r"\b(?:LDL|STL)\b", fn))
            print(f"sass {search}{bf16}: LDL/STL {local}, HGMMA "
                  f"{len(re.findall(r'HGMMA', fn))}")
            continue
        tc = next((k for k in MMA_KERNELS if k in head), None)
        if tc:
            inst = re.search(r"ILi(\d+)E", head)
            label = tc + (f"<{inst.group(1)}>" if inst else "") + bf16
            local = len(re.findall(r"\b(?:LDL|STL)\b", fn))
            hmma = len(re.findall(r"\bHMMA\b", fn))
            mma[tc] += hmma
            print(f"sass {label}: LDL/STL {local}, HMMA {hmma}")
            continue
        name = "lgb_block_kernel"
        if name not in head:
            continue
        total = raised = 0
        inside = False
        for line in fn.splitlines():
            if "USETMAXREG.TRY_ALLOC" in line and "0x80" not in line:
                inside = True
            elif "USETMAXREG.DEALLOC" in line and "0x80" in line:
                inside = False
            if re.search(r"\b(LDL|STL)\b", line):
                total += 1
                raised += inside
        print(f"sass {name}: LDL/STL {total}, of them {raised} in the "
              f"window items' raised-register regions")
    missing = [k for k in MMA_KERNELS if not mma[k]]
    if missing:
        raise AssertionError(f"no mma.sync (HMMA) in the SASS of {missing}")


def check_fft_tables(sizes=TABLE_SIZES) -> None:
    """The FFT mixer's tables as the card makes them (lgteun_fft_tables)
    at each (H, W) of `sizes` against their plain version
    (fft_tables_ref, in long double): the plan at their head and the
    positions bit-equal (the kernel's plan is the Python mirror's), the
    twiddles within 6e-8 with the same exact zeros."""
    from lgteun_tpu_torch.ops.spectral_kernel import (FFT_PLAN_FLOATS,
                                                      fft_mixer_plan,
                                                      fft_tables,
                                                      fft_tables_ref)
    worst, head = 0.0, FFT_PLAN_FLOATS
    for h, w in sizes:
        got = fft_tables(h, w, torch.device("cuda")).cpu()
        want = fft_tables_ref(h, w)
        k = fft_mixer_plan(h, w)["pos_row"]
        bits = lambda t: t.view(torch.int32)
        err = (got[head:k] - want[head:k]).abs().max().item()
        worst = max(worst, err)
        if err > 6e-8 or \
                not torch.equal(got[head:k] == 0, want[head:k] == 0) or \
                not torch.equal(bits(got[:head]), bits(want[:head])) or \
                not torch.equal(bits(got[k:]), bits(want[k:])):
            raise AssertionError(f"fft tables {h}x{w}: the card's differ from "
                                 f"the plain ones (twiddles {err:.2e})")
    print(f"fft_tables: {len(sizes)} sizes, plan and positions "
          f"bit-equal to the plain tables, twiddles within {worst:.2e} with "
          "the same exact zeros")


# functions of the FFT mixer and the whole block whose ptxas report the
# smoke prints (the whole block calls the mixer's body as mixer_plane)
PTXAS_NAMES = ("fft_mixer_pair_kernel", "fft_mixer_cluster_kernel",
               "fft_mixer_kernel", "mixer_plane",
               "fft_pass_generic", "fft_rows_forward_kernel",
               "fft_columns_kernel", "fft_rows_inverse_kernel",
               "lgb_block_kernel", "tm_tc_kernel",
               "pm_tc_kernel", "lightnet_group_kernel", "na_tc_kernel",
               "na_fp32_kernel")


def print_ptxas(lib_path) -> None:
    """ptxas's registers, stack and spills of the FFT mixer's kernels and
    functions (its cluster route's and global route's too), of the
    whole-block kernel, of the searches' and LightNet's
    tensor-core kernels and of the neighbourhood attention's two bodies,
    from the build's log."""
    import re
    from lgteun_tpu_torch.ops import _cuda
    entry = None
    for line in _cuda.ptxas_log(lib_path).read_text().splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            mangled = line.split("'")[1] if "'" in line else line.split()[-1]
            name = next((k for k in PTXAS_NAMES if k in mangled), None)
            inst = re.search(r"(?:fft_mixer_kernel|na_tc_kernel|"
                             r"na_fp32_kernel)ILi(\d+)E", mangled)
            entry = name and name + (f"<{inst.group(1)}>" if inst else "") \
                + ("<bf16>" if "nv_bfloat16" in mangled else "")
        elif entry and ("spill" in line or "Used" in line):
            print(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")


def check_branches(wrappers: dict) -> None:
    """Every branch of BRANCHES was launched in the kernel checks (the
    counts since `wrappers` were reset)."""
    for name, branches in BRANCHES.items():
        got = dict(wrappers[name].variants)
        print(f"kernel {name:17s} launches by branch {got}")
        missing = [b for b in branches if not got.get(b)]
        if missing:
            raise AssertionError(f"{name}: branches {missing} never launched")


def check_search_rule() -> None:
    """The searches' branch rule in Python (which the wrappers count)
    equals the library's (which the C entries follow) on every shape the
    kernels take: C 1-8 at sides 1-40, K 1-72 at L 1-1614."""
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.patch_match_kernel import (_smem_bytes as pm_smem,
                                                         patch_match_branch)
    from lgteun_tpu_torch.ops.texture_match_kernel import (
        _SMEM_MAX, _smem_bytes as tm_smem, texture_match_branch)
    lib = _cuda.kernels()
    shapes = {"texture_match": [(c, side) for c in range(1, 9)
                                for side in range(1, 41)
                                if tm_smem(c, side * side) <= _SMEM_MAX],
              "patch_match": [(k, ll) for k in range(1, 73)
                              for ll in range(1, 1615)
                              if pm_smem(k, ll) <= _SMEM_MAX]}
    rules = {"texture_match": (texture_match_branch,
                               lib.lgteun_texture_match_tc),
             "patch_match": (patch_match_branch, lib.lgteun_patch_match_tc)}
    for name, (python, library) in rules.items():
        differ = [sh for sh in shapes[name]
                  if (python(*sh) == "tc") != bool(library(*sh))]
        n_tc = sum(python(*sh) == "tc" for sh in shapes[name])
        print(f"kernel {name:17s} branch rule: {len(shapes[name])} shapes, "
              f"{n_tc} tc, the library agrees on all but {len(differ)}")
        if differ:
            raise AssertionError(f"{name}: the library's branch differs at "
                                 f"{differ[:5]}")


def check_na_rule() -> None:
    """The neighbourhood attention's branch rule in Python (which the
    wrapper counts) equals the library's (which the C entry follows) on
    every shape the kernel takes: C 1-32, odd fs 1-99 where a branch's
    shared memory fits."""
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.nonlocal_kernel import (
        _SMEM_MAX, _smem_bytes, _tc_smem_bytes, neighborhood_attention_branch)
    lib = _cuda.kernels()
    shapes = [(c, fs) for c in range(1, 33) for fs in range(1, 100, 2)
              if min(_smem_bytes(c, fs), _tc_smem_bytes(c, fs)) <= _SMEM_MAX]
    differ = [sh for sh in shapes
              if (neighborhood_attention_branch(*sh) == "tc")
              != bool(lib.lgteun_neighborhood_attention_tc(*sh))]
    n_tc = sum(neighborhood_attention_branch(*sh) == "tc" for sh in shapes)
    print(f"kernel neighborhood_attention branch rule: {len(shapes)} shapes, "
          f"{n_tc} tc, the library agrees on all but {len(differ)}")
    if differ:
        raise AssertionError(f"neighborhood_attention: the library's branch "
                             f"differs at {differ[:5]}")


def check_lightnet_layout(gen: torch.Generator) -> None:
    """LightNet's weight layout (`lightnet_fragments`: the pointwise
    weights split into TF32 hi/lo in the B fragments' order) made on the
    card bit for bit against the same made on the CPU, at 4 and 8 bands,
    with values over many binades."""
    from lgteun_tpu_torch.ops.lightnet_kernel import (lightnet_fragments,
                                                      lightnet_layers)
    floats = 0
    for bands in (4, 8):
        table = lightnet_layers(bands)
        layers = [tuple(torch.randn(*shp, generator=gen) * torch.exp2(
            torch.randint(-40, 40, shp, generator=gen).float())
            for shp in ((cout, cin, 1, 1), (cout,), (cout, 1, 3, 3),
                        (cout,)) * 2) for _n, cin, cout, _r in table]
        want, rows = lightnet_fragments(layers, table)
        got, got_rows = lightnet_fragments(
            [tuple(t.cuda() for t in layer) for layer in layers], table)
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)) or \
                not torch.equal(got_rows, rows):
            raise AssertionError(f"lightnet_fragments at {bands} bands: the "
                                 "card's bits differ from the CPU's")
        floats += want.numel()
    print(f"lightnet_fragments: 4 and 8 bands ({floats} floats) bit-equal "
          "on the card and the CPU")


def check_tail_layout(gen: torch.Generator) -> None:
    """The weight layouts on the card bit for bit against their plain
    versions on the CPU, with values over many binades: the tails'
    (lgteun_tail_fragments vs ffn_kernel.tail_fragments) for each tail
    matrix at C = 12, 32, 40, 64, 96 and 128, and the window attention's
    (lgteun_attention_fragments vs window_attention.attention_fragments)
    at head widths 4 to 32."""
    from lgteun_tpu_torch.ops.ffn_kernel import (_fragments, tail_fragments,
                                                 tail_width)
    from lgteun_tpu_torch.ops.window_attention import (_wqkv_fragments,
                                                       attention_fragments)
    n_cases, launches = 0, _fragments.launches
    for c in (12, 32, 40, 64, 96, 128):
        cp = tail_width(c)
        for n, k in ((c, c), (4 * c, c), (4 * c, 4 * c), (c, 4 * c)):
            w = torch.randn(n, k, generator=gen) * torch.exp2(
                torch.randint(-40, 40, (n, k), generator=gen).float())
            got = _fragments(w.cuda(), c).cpu()
            want = tail_fragments(w, n // c * cp, k // c * cp, cp)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"tail_fragments C {c} [{n}, {k}]: the "
                                     "card's bits differ from the plain ones")
            n_cases += 1
    print(f"tail_fragments: {n_cases} matrices (C 12, 32, 40, 64, 96, 128) "
          f"bit-equal to the plain layout, {_fragments.launches - launches} "
          "launches")
    n_cases, launches = 0, _wqkv_fragments.launches
    for c, heads in ((8, 2), (16, 2), (32, 2), (64, 2), (12, 3), (24, 1)):
        w = torch.randn(3 * c, c, generator=gen) * torch.exp2(
            torch.randint(-40, 40, (3 * c, c), generator=gen).float())
        got = _wqkv_fragments(w.cuda(), heads).cpu()
        want = attention_fragments(w, heads)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"attention_fragments C {c} heads {heads}: "
                                 "the card's bits differ from the plain ones")
        n_cases += 1
    print(f"attention_fragments: {n_cases} matrices (C 8 to 64, 1 to 3 "
          f"heads) bit-equal to the plain layout, "
          f"{_wqkv_fragments.launches - launches} launches")


def dropout_mask(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """A seeded rate-DROP_RATE dropout mask of x's shape (0 or 1/keep)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = 1.0 - DROP_RATE
    return (torch.rand(x.shape, generator=gen, device=x.device) < keep).to(
        x.dtype) * (1.0 / keep)


def synthetic_scene(side: int, bands: int, seed: int,
                    target_too: bool = False):
    """A seeded WV-3-shaped scene in 11-bit DN: a smooth 8-band target
    (a 32-pixel grid of band levels plus N(0, 40) texture), its 4x4
    block mean as LrMS [side/4, side/4, bands] and its band mean as PAN
    [side, side]; float32. With `target_too`, (lr, pan, target)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(200, 1800, (side // 32, side // 32, bands))
    target = np.repeat(np.repeat(coarse, 32, 0), 32, 1) + rng.normal(
        0, 40, (side, side, bands))
    target = np.clip(target, 0, 2047).astype(np.float32)
    lr = target.reshape(side // 4, 4, side // 4, 4, bands).mean(axis=(1, 3))
    out = lr.astype(np.float32), target.mean(axis=-1).astype(np.float32)
    return (*out, target) if target_too else out


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
    if cfg.model_type == "PanFormer":
        check_unclamped(tag, method, cpu, first, abs_tol)
    # where that difference comes from (printed, not checked)
    # (on the plain versions the wrappers count no launch)
    exact = float64_forward(cpu, first)
    d = lambda a, b: (a.double() - b.double()).abs().max().item()
    if per_forward:
        with swapped_kernels(per_forward,
                             lambda name, fn: kernel_fns(name)[1]):
            card_plain = runner.predict(runner.to_device(first)).cpu()
        print(f"{tag} split: max|card kernels - card plain| "
              f"{d(got, card_plain):.3e}  max|card plain - cpu plain| "
              f"{d(card_plain, want):.3e}; vs float64 cpu plain: card "
              f"kernels {d(got, exact):.3e}, card plain "
              f"{d(card_plain, exact):.3e}, cpu plain {d(want, exact):.3e}")
    else:
        print(f"{tag} split (no kernel on this path): vs float64 cpu plain: "
              f"card {d(got, exact):.3e}, cpu plain {d(want, exact):.3e}")

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
          f" (the reference: {REFERENCE_MS[cfg.model_type]} ms/img, RTX "
          f"3090); batch-{cfg.eval_batch_size} {b16_ms:.3f} ms = {ips:.1f} "
          f"images/s; Runner.test {runner.last_time_per_image * 1e3:.3f} "
          f"ms/img  [{card}]")

    if profile:
        for label, batch in (("batch-1", b1),
                             (f"batch-{cfg.eval_batch_size}", b16)):
            print_profile(f"{tag[6:]} {label}",
                          device_profile(lambda: runner.predict(batch)), card)
    return launches


def check_unclamped(tag: str, method, cpu, batch: dict,
                    abs_tol: float) -> None:
    """PanFormer's tail before its clamp, card vs CPU plain on `batch`
    (random weights leave much of the output clamped, where the clamped
    output would hide a difference), and the share of clamped values."""
    nchw = lambda a, dev: torch.as_tensor(np.asarray(a, np.float32)).permute(
        0, 3, 1, 2).to(dev)
    with torch.inference_mode():
        got, want = (m.module.unclamped(nchw(batch["input_lr"], dev),
                                        nchw(batch["input_pan"], dev)).cpu()
                     for m, dev in ((method, "cuda"), (cpu, "cpu")))
    err = (got - want).abs().max().item()
    hi = method.module.hi
    clamped = ((want < 0) | (want > hi)).double().mean().item()
    print(f"{tag}: before the clamp max|card - cpu plain| {err:.3e} (max|cpu|"
          f" {want.abs().max().item():.3f}, bound {abs_tol:g}); clamped share"
          f" of the output {clamped:.3f}")
    if not (torch.isfinite(got).all() and err <= abs_tol):
        raise AssertionError(f"{tag} before the clamp: max-abs {err:.3e} > "
                             f"{abs_tol}")


def run_sixteen_bands(card: str) -> None:
    """The shipped UnlgFormer config at 16 bands (embed 64: four blocks of
    C = 64 and a bottleneck block of C = 128, which the tails run on the
    wide tile) at each level of SIXTEEN: one batch-4 forward on the card,
    its launches and their branches, and its distance from a float64 run
    of the CPU plain path, which may exceed the CPU float32 plain path's
    own distance from it by at most SIXTEEN_TOL max-abs; the card against
    the CPU plain path and the card's plain versions are printed.

    At 16 bands no two float32 runs of the model agree to the 8-band
    paths' 5e-4: the mixer's amplitude bias lifts frequency bins whose
    magnitude is rounding noise to a full amplitude with a noise-given
    phase. On an H100 at level 1 the CPU plain path lay 6.8e-4 from
    float64, the card's plain path (no kernel) 6.2e-4 from the CPU's, and
    at level 2 the card with kernels 7.6e-4 from the card's plain path
    but 4.9e-4 from float64. So each float32 run is held to the exact
    answer, with the CPU float32 run's error as the allowance for
    float32 itself."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import eval_batches
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner

    cfg = load_config(os.path.join(CONFIGS, "unlg_former.py"))
    cfg.ms_chans = 16
    batch = {k: v for k, v in next(eval_batches(SceneDataset(
        4, cfg.ms_chans, SEED + 5), 4))[0].items() if k != "image_id"}
    for env, route, tail in SIXTEEN:
        tag = f"sixteen bands {env}"
        with mock.patch.dict(os.environ, env):
            method = build_model(cfg.model_type, cfg, device="cuda")
            cpu = build_model(cfg.model_type, cfg, device="cpu")
        runner = Runner(cfg, method, "cuda").init(SEED)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             method.module.state_dict().items()})
        runner.predict(runner.to_device(batch))   # warm-up
        torch.cuda.synchronize()
        wrappers = reset_launches()
        got = runner.predict(runner.to_device(batch)).cpu()
        check_launches(tag, wrappers, route, 1)
        want = cpu.apply(batch)
        err = (got - want).abs().max().item()
        branches = {k: dict(wrappers[k].variants) for k in route
                    if hasattr(wrappers[k], "variants")}
        print(f"{tag}: output {tuple(got.shape)} finite "
              f"{bool(torch.isfinite(got).all())}, launches {route}, by "
              f"branch {branches}; max|card - cpu plain| {err:.3e} (max|cpu| "
              f"{want.abs().max().item():.3f})  [{card}]")
        with swapped_kernels(route, lambda name, fn: kernel_fns(name)[1]):
            card_plain = runner.predict(runner.to_device(batch)).cpu()
        exact = float64_forward(cpu, batch)
        d = lambda a, b: (a.double() - b.double()).abs().max().item()
        print(f"{tag} split: max|card kernels - card plain| "
              f"{d(got, card_plain):.3e}  max|card plain - cpu plain| "
              f"{d(card_plain, want):.3e}; vs float64 cpu plain: card kernels "
              f"{d(got, exact):.3e}, card plain {d(card_plain, exact):.3e}, "
              f"cpu plain {d(want, exact):.3e}")
        if wrappers[tail].variants.get("wide") != 1:
            raise AssertionError(f"{tag}: {tail} ran the wide tile "
                                 f"{wrappers[tail].variants.get('wide')} "
                                 "times, want 1 (the bottleneck block)")
        excess = d(got, exact) - d(want, exact)
        print(f"{tag}: max|card - float64| exceeds max|cpu plain - float64| "
              f"by {excess:.3e} (bound {SIXTEEN_TOL:g})")
        if not (torch.isfinite(got).all() and excess <= SIXTEEN_TOL):
            raise AssertionError(f"{tag}: card {d(got, exact):.3e} from "
                                 f"float64, CPU float32 {d(want, exact):.3e}")


def run_autograd(gen: torch.Generator, card: str) -> None:
    """Each differentiable wrapper (B1-B6, and since the zoo trains
    B9-B12) at the main path's shapes: its forward (KERNEL_REL_TOL; the
    searches as `check_search` holds them, outside the float64 near
    ties) and the gradients of a loss linear in its outputs, with
    respect to every input and weight (the dropout mask excepted),
    against plain autograd through its plain version on the card
    (GRAD_REL_TOL). B9-B12 also print the training call's time (the
    kernel forward, then the backward that recomputes the plain version)
    beside the plain version's forward and backward."""
    names = ("ln_mixer_head", "window_attention", "block_tail",
             "block_tail_masked", "global_mixer", "ln_ffn",
             "window_attention_windows") + ZOO_KERNELS
    for name, shape, kernel, plain, args in kernel_cases(gen):
        if name not in names or shape not in AUTOGRAD_SHAPES:
            continue
        leaf = lambda t: t.detach().clone().requires_grad_()
        args = [({k: leaf(v) for k, v in a.items()} if isinstance(a, dict)
                 else [tuple(map(leaf, layer)) for layer in a]
                 if isinstance(a, list)
                 else leaf(a) if isinstance(a, torch.Tensor) and not (
                     name == "block_tail_masked" and i == 3) else a)
                for i, a in enumerate(args)]
        leaves = [t for a in args for t in (
            a.values() if isinstance(a, dict) else
            [t for layer in a for t in layer] if isinstance(a, list)
            else [a]) if isinstance(t, torch.Tensor) and t.requires_grad]
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
        if name in ("texture_match", "patch_match"):
            fwd, _ = check_search(name, shape, k_out, p_out,
                                  [a.detach() for a in args])
        else:
            fwd, _ = rel_err(k_out, p_out)
        grad = max(rel_err([g], [w])[0] for g, w in zip(k_grads, p_grads))
        print(f"autograd {name:24s} {shape:14s} forward rel err {fwd:.3e}  "
              f"grads of {len(leaves)} tensors rel err {grad:.3e} (bounds "
              f"{KERNEL_REL_TOL:g}, {GRAD_REL_TOL:g})")
        if not (fwd <= KERNEL_REL_TOL and grad <= GRAD_REL_TOL):
            raise AssertionError(f"autograd {name} {shape}: forward {fwd:.3e}"
                                 f", grads {grad:.3e}")
        if name in ZOO_KERNELS:
            def step(fn):
                outs = as_tuple(fn(*args))
                return torch.autograd.grad(
                    sum((o * w).sum() for o, w in zip(outs, weights)),
                    leaves)
            with torch.no_grad():
                fwd_ms = time_ms(lambda: kernel(*args), iters=10)
            train_ms, plain_ms = in_turns(lambda: step(plain),
                                          lambda: step(kernel))
            print(f"autograd {name:24s} {shape:14s} training call: kernel "
                  f"forward {fwd_ms:.3f} ms, kernel forward + recompute "
                  f"backward {train_ms:.3f} ms (the backward "
                  f"{train_ms - fwd_ms:.3f}); plain forward + backward "
                  f"{plain_ms:.3f} ms  [{card}]")


def train_method(cfg, env: dict | None = None):
    """The shipped UnlgFormer on the card, built under `env` (fuse level
    2 and the image-layout attention unless it says otherwise)."""
    return zoo_method(cfg, dict(TRAIN_ENV, **(env or {})), "cuda")


def reset_launches() -> dict:
    wrappers = {k: kernel_fns(k)[0] for k in KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()
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
                    test_ds_reduced=test_ds).init(SEED).set_optim()
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
    check_resume(runner, cfg, TRAIN_ENV, train_ds, card)

    # step time at each batch: the device step (forward, backward, Adam)
    from lgteun_tpu_torch.ops.ffn_kernel import _fragments
    from lgteun_tpu_torch.ops.window_attention import _wqkv_fragments
    for bsz in TRAIN_BATCHES:
        batch = runner.to_device(next(train_iterator(
            train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED)))
        times = []
        made, made_attn = _fragments.launches, _wqkv_fragments.launches
        for i in range(3 + TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.train_step(batch, i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times[3:])
        made = (_fragments.launches - made) / (3 + TRAIN_TIMED)
        made_attn = (_wqkv_fragments.launches - made_attn) / (
            3 + TRAIN_TIMED)
        print(f"train step batch {bsz}: median {med * 1e3:.3f} ms (min "
              f"{min(times[3:]) * 1e3:.3f}) of {TRAIN_TIMED} = "
              f"{bsz / med:.1f} images/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"tail_fragments launches a step {made:g}, "
              f"attention_fragments {made_attn:g}  [{card}]")
        if (made, made_attn) != (FRAGMENTS_PER_STEP, ATTN_FRAGMENTS_PER_STEP):
            raise AssertionError(
                f"weight layouts: {made} tail and {made_attn} attention "
                f"launches a step, want {FRAGMENTS_PER_STEP} and "
                f"{ATTN_FRAGMENTS_PER_STEP}")
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
    scale, level = grad_level(exact[1])
    diff = lambda a, b: grad_diff(a, b, level, scale)

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


def grad_level(grads: dict) -> tuple[float, set]:
    """(the largest gradient of all, the tensors whose largest value is
    at least GRAD_LEVEL of it) of {name: gradient}."""
    scale = max(g.abs().max().item() for g in grads.values())
    return scale, {k for k, g in grads.items()
                   if g.abs().max().item() >= GRAD_LEVEL * scale}


def grad_diff(a, b, level: set, scale: float) -> tuple:
    """Two steps' (loss, {name: gradient}): (|loss a - loss b|, the worst
    relative error among the tensors in `level` and its tensor, allclose
    of every tensor: |a - b| <= TRAIN_GRAD_TOL |b|max + GRAD_ATOL
    scale)."""
    assert a[1].keys() == b[1].keys()
    rel = {k: (a[1][k] - b[1][k]).abs().max().item()
           / b[1][k].abs().max().item() for k in level}
    worst = max(rel, key=rel.get)
    close = all(((a[1][k] - b[1][k]).abs() <= TRAIN_GRAD_TOL
                 * b[1][k].abs().max() + GRAD_ATOL * scale).all()
                for k in b[1])
    return abs(a[0] - b[0]), rel[worst], worst, close


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


def zoo_method(cfg, env: dict, device: str):
    """The shipped `cfg`'s method on `device`, built under `env`."""
    from lgteun_tpu_torch.registry import build_model
    with mock.patch.dict(os.environ, env):
        return build_model(cfg.model_type, cfg, device=device)


def run_zoo_training(train_ds, card: str, profile: bool) -> dict:
    """The training blocks of LightNet, MDCUN, INNT, SFIIN and MutInf
    (ZOO_TRAIN): `Runner.train` of the shipped config (its optimisers,
    schedule, loss terms and batch) for ZOO_TRAIN_ITERS iterations on
    the synthetic WV-3 pairs of `run_training`, the loss curve (finite,
    the reconstruction term falling), the launches per training forward,
    one step on the card against the CPU plain path (`zoo_grad_split`),
    MutInf's resume (two modules, two optimisers) and the median step
    time at the config's batch and at 16, with peak memory (and under
    `profile` the step's top device ops and idle share); then a few
    steps of INNT with LGTEUN_FUSED_TM=0 (patch match). Returns the
    launches of each kernel in its block's train() run."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import train_iterator
    from lgteun_tpu_torch.runner import Runner

    launches = {}
    for config, route, env in ZOO_TRAIN:
        cfg = load_config(os.path.join(CONFIGS, config))
        tag = f"train {cfg.model_type}"
        root = os.path.join(REPO, "build", "chip_smoke",
                            f"train_{cfg.model_type}")
        cfg.max_iter, cfg.log_freq, cfg.work_dir = (ZOO_TRAIN_ITERS,
                                                    TRAIN_LOG, root)
        cfg.save_freq = cfg.eval_freq = cfg.test_freq = 0
        bs = cfg.train_set_cfg.batch_size
        runner = Runner(cfg, zoo_method(cfg, env, "cuda"), "cuda",
                        train_ds=train_ds).init(SEED).set_optim()
        print(f"{tag}: {cfg.optim_cfg} {cfg.sched_cfg} {cfg.loss_cfg} batch "
              f"{bs} max_iter {cfg.max_iter}; parameters "
              f"{runner.method.param_counts()}")
        wrappers = reset_launches()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = check_launches(tag, wrappers, route, ZOO_TRAIN_ITERS)
        launches.update({k: counted[k] for k in route})
        print(f"{tag}: {ZOO_TRAIN_ITERS} iterations in {wall:.2f} s "
              f"({wall / ZOO_TRAIN_ITERS * 1e3:.2f} ms an iteration, data "
              f"included); launches per training forward "
              f"{ {k: counted[k] // ZOO_TRAIN_ITERS for k in route} }, "
              f"every other kernel 0  [{card}]")
        for it, parts in runner.loss_log:
            print(f"{tag}: iter {it} " + ", ".join(
                f"{k} {v:.6f}" for k, v in parts.items()))
        rec = [parts["rec_loss"] for _, parts in runner.loss_log]
        full = [parts["full_loss"] for _, parts in runner.loss_log]
        if not (np.isfinite(rec + full).all() and rec[-1] < rec[0]):
            raise AssertionError(f"{tag}: loss curve {runner.loss_log} is "
                                 "not finite with a falling rec_loss")
        if cfg.model_type == "MutInf":
            check_resume(runner, cfg, env, train_ds, card)
        zoo_grad_split(cfg, env, route, train_ds, card)
        for bsz in (bs, 16):
            batch = runner.to_device(next(train_iterator(
                train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED)))
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(3 + ZOO_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.train_step(batch, i)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            med = statistics.median(times[3:])
            print(f"{tag} step batch {bsz}: median {med * 1e3:.3f} ms (min "
                  f"{min(times[3:]) * 1e3:.3f}) of {ZOO_TIMED} = "
                  f"{bsz / med:.1f} images/s; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB"
                  f"  [{card}]")
            if profile:
                print_profile(f"{tag[6:]} train step batch-{bsz}",
                              device_profile(lambda: runner.train_step(
                                  batch, 0), n=3), card)
        del runner, batch
        torch.cuda.empty_cache()

    config, route, env = ZOO_TRAIN_PM
    cfg = load_config(os.path.join(CONFIGS, config))
    runner = Runner(cfg, zoo_method(cfg, env, "cuda"), "cuda").init(
        SEED).set_optim()
    batch = runner.to_device(next(train_iterator(
        train_ds, cfg.train_set_cfg.batch_size, bit_depth=cfg.bit_depth,
        seed=SEED + 4)))
    runner.train_step(batch, 0)     # warm-up outside the count
    wrappers = reset_launches()
    losses = [runner.train_step(batch, i + 1)["full_loss"].item()
              for i in range(3)]
    counted = check_launches(f"train {cfg.model_type} {env}", wrappers,
                             route, 3)
    launches.update({k: counted[k] for k in route})
    print(f"train {cfg.model_type} {env}: 3 steps, l1 "
          f"{', '.join(f'{v:.6f}' for v in losses)}; launches per forward "
          f"{route}  [{card}]")
    if not np.isfinite(losses).all():
        raise AssertionError(f"train {cfg.model_type} {env}: loss not "
                             "finite")
    return launches


def check_resume(runner, cfg, env: dict, train_ds, card: str) -> None:
    """A checkpoint of `runner` at its last iteration, loaded into a new
    Runner (both modules' weights, both optimisers and schedulers); both
    run RESUME_STEPS more iterations: the first resumed step's loss
    equal, the later ones within RESUME_LOSS_REL, each module's weights
    within 2 lr x steps of its own learning rate (the bicubic backward's
    atomic adds are not ordered on CUDA; two resumed runs show the
    card's own spread)."""
    from lgteun_tpu_torch.runner import Runner
    start = runner.last_iter
    path = runner.save(start)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if set(payload.get("modules", {})) != set(
            runner.method.module_names[1:]) or set(
            payload.get("optimizers", {})) != set(runner.method.module_names):
        raise AssertionError(f"resume: the checkpoint holds modules "
                             f"{sorted(payload.get('modules', {}))} and "
                             f"optimizers {sorted(payload.get('optimizers', {}))}")
    cfg.max_iter, cfg.log_freq = start + RESUME_STEPS, 1

    def resume():
        r = Runner(cfg, zoo_method(cfg, env, "cuda"), "cuda",
                   train_ds=train_ds)
        return r.load_checkpoint(path).set_optim().train()

    n0 = len(runner.loss_log)
    runner.train()
    resumed, again = resume(), resume()
    losses = lambda r, n=0: [parts["full_loss"] for _, parts in
                             r.loss_log[n:]]

    def gap(r1, l1, r2, l2):
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(l1, l2))
        w = {}
        for name in r1.method.module_names:
            s1 = r1.method.modules()[name].state_dict()
            s2 = r2.method.modules()[name].state_dict()
            w[name] = max((s1[k] - s2[k]).abs().max().item() for k in s1)
        return loss_rel, w

    a, b = losses(runner, n0), losses(resumed)
    loss_rel, w_err = gap(runner, a, resumed, b)
    spread = gap(resumed, b, again, losses(again))
    lrs = {name: o.param_groups[0]["lr"]
           for name, o in runner.optimizers.items()}
    print(f"resume {cfg.model_type}: {RESUME_STEPS} steps after iteration "
          f"{start} from a checkpoint of modules "
          f"{list(runner.method.module_names)}: first step loss equal "
          f"{a[0] == b[0]}, losses rel err {loss_rel:.3e} (bound "
          f"{RESUME_LOSS_REL:g}), weights max-abs "
          + ", ".join(f"{k} {v:.3e} (bound {2 * lrs[k] * RESUME_STEPS:g})"
                      for k, v in w_err.items())
          + f"; two resumed runs: losses {spread[0]:.3e}, weights "
          + ", ".join(f"{k} {v:.3e}" for k, v in spread[1].items())
          + f"  [{card}]")
    if len(a) != RESUME_STEPS or len(b) != RESUME_STEPS or a[0] != b[0] \
            or not loss_rel <= RESUME_LOSS_REL or any(
                w_err[k] > 2 * lrs[k] * RESUME_STEPS for k in w_err):
        raise AssertionError(f"resume {cfg.model_type}: the resumed run "
                             "departs from the uninterrupted one")


def zoo_grad_split(cfg, env: dict, route: dict, train_ds, card: str) -> None:
    """One step (train mode; no dropout in these methods) from the same
    weights on ZOO_CPU_IMAGES images at iteration max_iter / 2 (MutInf's
    MI term mid-ramp, with noise drawn once on the CPU and injected on
    both sides): the loss and every parameter's gradient of every module
    on the card against the CPU plain path, held as `run_grad_split`
    holds UnlgFormer's (TRAIN_GRAD_TOL of a tensor's largest above
    GRAD_LEVEL of the largest of all, allclose with GRAD_ATOL below).

    SFIIN is held another way: its phase terms (the model's own
    frequency branch and the fre_pha loss) scale a bin's gradient by
    1 / amplitude, so float32's rounding of the spectrum reaches the
    gradients, and the CPU's float32 step itself misses TRAIN_GRAD_TOL
    against float64. So the same step runs in float64 on both devices
    (the card on the plain versions), which must agree to
    ZOO_F64_GRAD_TOL (the same function, cuFFT against pocketfft), and
    the card's float32 step must lie no farther from float64 than
    ZOO_F64_FACTOR times the CPU's float32 step (or within
    TRAIN_GRAD_TOL). Every method prints those float64 lines too, and
    the card on the kernels' plain versions against the CPU, INNT's
    float64 near-tie queries in the card's forward and SFIIN's target
    bins that the two devices put on opposite sides of the phase's
    branch cut (+pi against -pi: a 2 pi jump in that bin's term of the
    fre_pha L1)."""
    import math

    import lgteun_tpu_torch.models as models_pkg
    from lgteun_tpu_torch.data.pipeline import train_iterator
    from lgteun_tpu_torch.models import base
    from lgteun_tpu_torch.models.sfiin import spectrum_amp_phase
    from lgteun_tpu_torch.runner import Runner

    tag = f"train {cfg.model_type} grads"
    method = zoo_method(cfg, env, "cuda")
    Runner(cfg, method, "cuda", train_ds=train_ds).init(SEED + 3)
    cpu = zoo_method(cfg, env, "cpu")
    for name, module in method.modules().items():
        cpu.load_module_state_dict(name, {k: v.cpu() for k, v in
                                          module.state_dict().items()})
    batch = next(train_iterator(train_ds, ZOO_CPU_IMAGES,
                                bit_depth=cfg.bit_depth, seed=SEED + 3))
    iter_id = cfg.max_iter // 2
    gen = torch.Generator().manual_seed(SEED + 7)
    kw = {"noise": tuple(torch.randn(ZOO_CPU_IMAGES, 4, generator=gen)
                         for _ in range(2))} \
        if cfg.model_type == "MutInf" else {}

    def double(m):
        """A float64 copy of method `m` (its modules copied)."""
        d = copy.copy(m)
        d.module = copy.deepcopy(m.module).double()
        if "mi" in m.module_names:
            d.mi = copy.deepcopy(m.mi).double()
        return d

    def step(m):
        dtype = next(m.module.parameters()).dtype
        nchw = lambda a, dev: torch.as_tensor(np.asarray(a)).to(
            device=dev, dtype=dtype).permute(0, 3, 1, 2).contiguous()
        m.train()
        for module in m.modules().values():
            module.zero_grad(set_to_none=True)
        with mock.patch.object(models_pkg, "_nchw", nchw), \
                mock.patch.object(base, "_nchw", nchw):
            total, _ = m.losses(batch, None, iter_id, **kw)
        total.backward()
        return total.item(), {f"{name}.{k}": p.grad.detach().cpu().double()
                              for name, module in m.modules().items()
                              for k, p in module.named_parameters()
                              if p.grad is not None}

    searches = [k for k in route if k in ("texture_match", "patch_match")]
    calls = []

    def recorder(name, fn):
        def call(*args):
            calls.append((name, [a.detach() for a in args]))
            return fn(*args)
        return call

    plain = lambda: swapped_kernels(route, lambda name, fn:
                                    kernel_fns(name)[1])
    t0 = time.perf_counter()
    with swapped_kernels(searches, recorder):
        card_k = step(method)
    with plain():
        card_p = step(method)
        card_64 = step(double(method))
    want = step(cpu)
    exact = step(double(cpu))
    cpu_s = time.perf_counter() - t0
    scale, level = grad_level(exact[1])
    diff = lambda a, b: grad_diff(a, b, level, scale)

    loss_err, grad_err, worst, close = diff(card_k, want)
    n_near = sum(int(near_ties(*search_inputs(k, args)).sum())
                 for k, args in calls)
    print(f"{tag}: step on {ZOO_CPU_IMAGES} images at iteration {iter_id}, "
          f"loss {want[0]:.6f}, {len(want[1])} parameters with a gradient, "
          f"{len(level)} of them above {GRAD_LEVEL:g} of the largest "
          f"({scale:.4g}): |card - cpu plain| loss {loss_err:.3e}, worst "
          f"gradient rel err {grad_err:.3e} ({worst}; bound "
          f"{TRAIN_GRAD_TOL:g}), every tensor allclose (rtol "
          f"{TRAIN_GRAD_TOL:g}, atol {GRAD_ATOL:g} x {scale:.4g}): {close}"
          + (f"; float64 near-tie queries in the card's forward {n_near}"
             if searches else "") + f" (the card's and the CPU's steps, "
          f"float32 and float64, {cpu_s:.1f} s)  [{card}]")
    splits = {"card plain vs cpu plain": (card_p, want),
              "card float64 vs cpu float64": (card_64, exact),
              "card kernels vs cpu float64": (card_k, exact),
              "cpu plain vs cpu float64": (want, exact)}
    d = {k: diff(*v) for k, v in splits.items()}
    for k, (l_err, g_err, g_worst, _) in d.items():
        print(f"{tag} split, {k}: loss {l_err:.3e}, worst rel err "
              f"{g_err:.3e} ({g_worst})")
    if cfg.model_type == "SFIIN":
        pc, pp = (spectrum_amp_phase(base._nchw(batch["target"], m.device))
                  [1].cpu() for m in (method, cpu))
        flips = int(((pc - pp).abs() > math.pi).sum())
        print(f"{tag}: target spectrum bins on opposite sides of the "
              f"phase's branch cut, card vs CPU: {flips} of {pp.numel()} "
              f"(each a 2 pi jump in its fre_pha_rec_loss term, weight "
              f"0.1)")
        card_f64 = d["card kernels vs cpu float64"][1]
        cpu_f64 = d["cpu plain vs cpu float64"][1]
        same = d["card float64 vs cpu float64"][1]
        ok = same <= ZOO_F64_GRAD_TOL and card_f64 <= max(
            TRAIN_GRAD_TOL, ZOO_F64_FACTOR * cpu_f64)
        print(f"{tag}: held to float64: the two devices in float64 agree "
              f"to {same:.3e} (bound {ZOO_F64_GRAD_TOL:g}); the card's "
              f"float32 step {card_f64:.3e} from float64, the CPU's "
              f"{cpu_f64:.3e} (bound max({TRAIN_GRAD_TOL:g}, "
              f"{ZOO_F64_FACTOR:g} x the CPU's)): {ok}")
        if not (ok and loss_err <= 5e-4 * abs(want[0])):
            raise AssertionError(f"{tag}: float64 agreement {same:.3e}, "
                                 f"card {card_f64:.3e} vs CPU "
                                 f"{cpu_f64:.3e} from float64")
    elif not (loss_err <= 5e-4 * abs(want[0])
              and grad_err <= TRAIN_GRAD_TOL and close):
        raise AssertionError(f"{tag}: loss {loss_err:.3e}, gradients "
                             f"{grad_err:.3e} ({worst}), allclose {close}")


def write_main_tree(root: str) -> str:
    """{root}/data/WV-3/test_reduce_res (MAIN_IMAGES seeded Wald scenes
    with targets), .../test_full_res (the LrMS and PAN of MAIN_IMAGES
    other scenes, no target) and .../train_reduce_res (those other
    scenes' triples, with targets: the training pairs of MAIN_TRAINED),
    written by the port's generator; returns the data root."""
    import shutil

    from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset

    made = make_synthetic_dataset(os.path.join(root, "made"), MAIN_IMAGES,
                                  MAIN_IMAGES, bands=8, size=128,
                                  seed=SEED + 5, sensor="WV3")
    data = os.path.join(root, "data")
    shutil.copytree(made["test"], os.path.join(data, "WV-3",
                                               "test_reduce_res"))
    shutil.copytree(made["train"], os.path.join(data, "WV-3",
                                                "train_reduce_res"))
    full = os.path.join(data, "WV-3", "test_full_res")
    os.makedirs(full)
    for name in sorted(os.listdir(made["train"])):
        if not name.endswith("_mul.tif"):
            shutil.copy(os.path.join(made["train"], name), full)
    return data


def main_config(config: str, root: str) -> str:
    """A copy of shipped `config` under {root}/configs with max_iter cut
    to MAIN_TRAIN_ITERS (logged every quarter); returns its path."""
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    path = os.path.join(root, "configs", config)
    with open(os.path.join(CONFIGS, config)) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text + f"\n# cut for the smoke run\nmax_iter = "
                f"{MAIN_TRAIN_ITERS}\nlog_freq = {MAIN_TRAIN_ITERS // 4}\n")
    return path


def check_main_training(tag: str, runner, root: str, card: str) -> None:
    """The training half of a `main` run without --test-only: the loss
    curve finite with a falling rec_loss, and the checkpoint it saved at
    max_iter holding every module of the method (MutInf's `mi` under its
    name) and each module's optimizer state."""
    cfg = runner.cfg
    curve = [(it, round(parts["rec_loss"], 5), round(parts["full_loss"], 5))
             for it, parts in runner.loss_log]
    path = os.path.join(root, cfg.work_dir, cfg.datas, "train_out",
                        f"model_iter_{cfg.max_iter}.pt")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    names = runner.method.module_names
    print(f"{tag}: trained {runner.last_iter} iterations ({cfg.loss_cfg}), "
          f"(iter, rec_loss, full_loss) {curve}; checkpoint "
          f"{os.path.relpath(path, REPO)}: modules "
          f"{['core_module', *sorted(payload.get('modules', {}))]}, "
          f"optimizers {sorted(payload.get('optimizers', {}))}  [{card}]")
    rec = [c[1] for c in curve]
    if not (runner.last_iter == cfg.max_iter and np.isfinite(
            [c[1:] for c in curve]).all() and rec[-1] < rec[0]):
        raise AssertionError(f"{tag}: training curve {curve} is not finite "
                             "with a falling rec_loss")
    if set(payload.get("modules", {})) != set(names[1:]) or set(
            payload.get("optimizers", {})) != set(names):
        raise AssertionError(f"{tag}: the checkpoint lacks a module of "
                             f"{names}")


def oracle_scores(ref: bool, pred: np.ndarray, a: np.ndarray,
                  b: np.ndarray | None) -> dict:
    """The float64 oracle of one saved prediction (normalised [H,W,C]):
    ref, a = the target in DN (`numpy_ref.ref_evaluate`); no-ref, a = the
    normalised LrMS, b = the normalised PAN [H,W,1]
    (`oracle.no_ref_scores`: numpy_ref's D_lambda and D_s with each
    window statistic filtered once, QNR as `numpy_ref.qnr` forms it).
    Runs in a worker."""
    sys.path.insert(0, REPO)
    from lgteun_tpu_torch.metrics import numpy_ref, oracle

    p = pred.astype(np.float64)
    if ref:
        return dict(zip(MAIN_REF_RTOL, numpy_ref.ref_evaluate(
            p * DN_RANGE, a.astype(np.float64))))
    return oracle.no_ref_scores(p, a, b)


def flat_window_inputs(seed: int):
    """8-band inputs with flat windows: a DN pair [2,128,128,8] with
    saturated (2047.5) and zero 24x24 blocks in both and a block flat in
    the prediction only; normalised no-ref inputs [1,...] with a
    saturated 64x64 prediction block and constant LrMS and PAN blocks."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.0, DN_RANGE, (2, 128, 128, 8))
    pred = np.clip(gt + rng.normal(0, 40.0, gt.shape), 0, DN_RANGE)
    for a in (pred, gt):
        a[:, 8:32, 8:32] = DN_RANGE
        a[:, 40:64, 40:64] = 0.0
    pred[:, 80:104, 80:104] = 1800.0
    npred = rng.uniform(0, 1, (1, 128, 128, 8))
    lrms = rng.uniform(0, 1, (1, 32, 32, 8))
    pan = rng.uniform(0, 1, (1, 128, 128, 1))
    npred[:, 16:80, 16:80] = 1.0
    lrms[:, 4:20, 4:20] = 0.5
    pan[:, 16:80, 16:80] = 0.75
    return tuple(x.astype(np.float32) for x in (pred, gt, npred, lrms, pan))


def metric_errors(card: dict, oracle: list, ref: bool) -> dict:
    """{metric: worst |card - oracle| (relative for the reference
    metrics)} over the images."""
    errs = {}
    for k in (MAIN_REF_RTOL if ref else MAIN_NO_REF_ATOL):
        got = np.asarray(card[k], np.float64)
        want = np.asarray([o[k] for o in oracle])
        d = np.abs(got - want)
        errs[k] = float((d / np.abs(want)).max() if ref else d.max())
    return errs


def check_metric_errors(tag: str, errs: dict, ref: bool) -> None:
    bounds = MAIN_REF_RTOL if ref else MAIN_NO_REF_ATOL
    bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
    if bad:
        raise AssertionError(f"{tag}: card vs float64 oracle {bad} over "
                             f"{bounds}")


def main_env(data: str) -> dict:
    """The environment of the main phase's runs on the tree under
    `data`: WV-3, fuse level 2, the image-layout attention, INNT's whole
    chain."""
    return {"LGTEUN_DATA_ROOT": data, "LGTEUN_DATA_INDEX": "2",
            "LGTEUN_FUSE_LEVEL": "2", "LGTEUN_FUSED_ATTENTION": "1",
            "LGTEUN_FUSED_TM": "1"}


def run_main(card: str) -> dict:
    """`main.cli --test-only --device cuda` on each of MAIN_CONFIGS (from
    a working directory under build/, where the configs' relative
    work_dir and log_dir land); then the checks and timings of the
    docstring's main phase. Returns {model type: {"config": the config
    run, "runner": its Runner, "saved": {ref: the saved outputs}}} of the
    DL methods, for the reference phase."""
    import concurrent.futures
    import contextlib
    import multiprocessing
    import shutil

    from lgteun_tpu_torch import main as port_main
    from lgteun_tpu_torch.data.pipeline import eval_batches
    from lgteun_tpu_torch.data.tiff import read_tiff
    from lgteun_tpu_torch.metrics import numpy_ref
    from lgteun_tpu_torch.metrics.torch_metrics import (no_ref_evaluate_batch,
                                                        ref_evaluate_batch)
    from lgteun_tpu_torch.runner import Runner

    t_phase = time.perf_counter()
    root = MAIN_ROOT
    shutil.rmtree(root, ignore_errors=True)
    env = main_env(write_main_tree(root))
    keep_save = Runner._save_outputs
    # (tag, ref, image scores the card logged, oracle arguments, the
    # oracle's futures): a config's oracle runs in the pool (one core
    # left to this process) while the next configs run on the card
    jobs = []
    timing, runs = {}, {}
    pred, gt, npred, lrms, pan = flat_window_inputs(SEED + 6)
    pool = concurrent.futures.ProcessPoolExecutor(
        max(os.cpu_count() - 1, 1),
        mp_context=multiprocessing.get_context("spawn"))
    t_oracle = time.perf_counter()
    flat_fut = pool.submit(oracle_scores, False, npred[0], lrms[0], pan[0])
    try:
        for config in MAIN_CONFIGS:
            saved = {}

            def record(self, outputs, iter_id, ref, saved=saved):
                saved[ref] = outputs
                return keep_save(self, outputs, iter_id, ref)

            trained = config in MAIN_TRAINED
            config_path = (main_config(config, root) if trained else
                           os.path.join(CONFIGS, config))
            args = ["-c", config_path, "--device", "cuda"]
            if not trained:
                args.append("--test-only")
            with mock.patch.dict(os.environ, env), contextlib.chdir(root), \
                    mock.patch.object(Runner, "_save_outputs", record):
                wrappers = reset_launches()
                t0 = time.perf_counter()
                runner = port_main.cli(args)
                wall = time.perf_counter() - t0
                counted = {k: fn.launches for k, fn in wrappers.items()}
            cfg = runner.cfg
            tag = f"main {cfg.model_type}"
            forwards = 2 * -(-MAIN_IMAGES // cfg.eval_batch_size) + (
                MAIN_TRAIN_ITERS if trained else 0)
            check_launches(tag, wrappers, MAIN_ROUTE.get(cfg.model_type, {}),
                           forwards)
            print(f"{tag}: main.cli {' '.join(args[2:])} in {wall:.2f} s "
                  f"(the build and data excluded), {forwards} forwards"
                  + (f" ({MAIN_TRAIN_ITERS} of them training, batch "
                     f"{cfg.train_set_cfg.batch_size})" if trained else "")
                  + f", launches { {k: v for k, v in counted.items() if v} }"
                  f"  [{card}]")
            if trained:
                check_main_training(tag, runner, root, card)
            out_root = os.path.join(root, cfg.work_dir, cfg.datas)
            with open(os.path.join(out_root, "eval_curves.json")) as f:
                curves = json.load(f)
            for ref in (True, False):
                want_keys = {f"{MAIN_TAGS[ref]}/{k}" for k in (
                    MAIN_REF_RTOL if ref else MAIN_NO_REF_ATOL)}
                if not want_keys <= set(curves):
                    raise AssertionError(f"{tag}: eval_curves.json lacks "
                                         f"{sorted(want_keys - set(curves))}")
                ds = runner.test_ds_reduced if ref else runner.test_ds_full
                scores = runner.image_scores[MAIN_TAGS[ref]]
                ids = [i for chunk, _ in saved[ref] for i in chunk]
                preds = np.concatenate([p for _, p in saved[ref]])
                if ids != scores["image_id"] or len(ids) != MAIN_IMAGES:
                    raise AssertionError(
                        f"{tag}: saved {len(ids)} predictions for "
                        f"{len(scores['image_id'])} scored images")
                split = os.path.join(out_root, "test_out",
                                     f"iter_{cfg.max_iter}",
                                     "reduced" if ref else "full")
                tif_err = max(float(np.abs(read_tiff(os.path.join(
                    split, f"{i}_mul_hat.tif")).astype(np.float64)
                    - np.clip(np.round(p.astype(np.float64) * DN_RANGE), 0,
                              65535)).max())
                    for i, p in zip(ids, preds))
                print(f"{tag} {MAIN_TAGS[ref]}: {len(ids)} TIFFs under "
                      f"{os.path.relpath(split, REPO)}, "
                      f"max|TIFF - round(pred)| {tif_err:g} DN (bound 1); "
                      + ", ".join(f"{k} {np.mean(scores[k]):.4f}" for k in (
                          MAIN_REF_RTOL if ref else MAIN_NO_REF_ATOL)))
                if not tif_err <= 1.0:
                    raise AssertionError(f"{tag}: TIFF off by {tif_err} DN")
                items = [ds[j] for j in range(len(ds))]
                args = [(ref, p, it["target"] if ref else
                         it["input_lr"] / np.float32(DN_RANGE),
                         None if ref else
                         it["input_pan"] / np.float32(DN_RANGE))
                        for p, it in zip(preds, items)]
                jobs.append((f"{tag} {MAIN_TAGS[ref]}", ref, scores, args,
                             [pool.submit(oracle_scores, *a) for a in args]))
            if not runner.method.trainable:
                timing[cfg.model_type] = runner
            else:
                runs[cfg.model_type] = {"config": config_path,
                                        "runner": runner, "saved": saved}
    except BaseException:
        pool.shutdown(cancel_futures=True)
        raise

    # every per-image metric's float64 oracle, before the timings below
    # (which want an idle host)
    with pool:
        oracle = {tag: [f.result() for f in futs]
                  for tag, _, _, _, futs in jobs}
        flat_oracle = [flat_fut.result()] + [dict(zip(
            MAIN_REF_RTOL, numpy_ref.ref_evaluate(
                pred[i].astype(np.float64), gt[i].astype(np.float64))))
            for i in range(2)]
    oracle_s = time.perf_counter() - t_oracle

    # the metric suite alone at batch 16 on the card, each split (on
    # UnlgFormer's predictions: jobs 0 and 1)
    for ref in (True, False):
        args = jobs[0 if ref else 1][3][:16]
        pred16, a16, b16 = (None if args[0][j] is None else torch.from_numpy(
            np.stack([a[j] for a in args])).cuda() for j in (1, 2, 3))
        if ref:
            call = lambda: ref_evaluate_batch(pred16 * DN_RANGE, a16,
                                              dynamic_range=DN_RANGE)
        else:
            call = lambda: no_ref_evaluate_batch(pred16, a16, b16)
        ms = time_ms(call, iters=10)
        print(f"main metric suite {MAIN_TAGS[ref]} batch 16: {ms:.3f} ms = "
              f"{ms / 16:.4f} ms/img (CUDA events; TF32 off)  [{card}]")

    # each classical method: batch-16 images/s and batch-1 latency (the
    # models' are the slices')
    for name, runner in timing.items():
        items = next(eval_batches(runner.test_ds_reduced, 16))[0]
        b16 = runner.to_device(items)
        b1 = runner.to_device({k: v[:1] for k, v in items.items()
                               if k != "image_id"})
        for _ in range(3):
            runner.predict(b1)
        lat = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.predict(b1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        b16_ms = time_ms(lambda: runner.predict(b16), iters=10)
        print(f"main {name}: batch-1 latency median "
              f"{statistics.median(lat) * 1e3:.3f} ms (min "
              f"{min(lat) * 1e3:.3f}); batch-16 {b16_ms:.3f} ms = "
              f"{16 / (b16_ms / 1e3):.1f} images/s (the reference: 22-59 "
              f"ms/img for its classical methods, numpy on an RTX 3090 "
              f"host)  [{card}]")

    # the flat-window inputs: card vs CPU (torch) vs float64
    flat_ref = {dev: {k: v.cpu().numpy() for k, v in ref_evaluate_batch(
        torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev),
        dynamic_range=DN_RANGE).items()} for dev in ("cuda", "cpu")}
    flat_no_ref = {dev: {k: v.cpu().numpy() for k, v in
                         no_ref_evaluate_batch(*(torch.from_numpy(x).to(dev)
                                                 for x in (npred, lrms,
                                                           pan))).items()}
                   for dev in ("cuda", "cpu")}
    for tag, ref, scores, _, _ in jobs:
        errs = metric_errors(scores, oracle[tag], ref)
        print(f"{tag}: card vs float64 oracle on the saved predictions, "
              f"worst over {MAIN_IMAGES} images ("
              + ("relative" if ref else "absolute") + "): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"  [{card}]")
        check_metric_errors(tag, errs, ref)
    for dev in ("cuda", "cpu"):
        errs = {**metric_errors(flat_ref[dev], flat_oracle[1:], True),
                **metric_errors(flat_no_ref[dev], flat_oracle[:1], False)}
        print(f"main flat windows ({dev}): vs float64, ref metrics relative"
              f" / no-ref absolute: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"  [{card}]")
        check_metric_errors(f"flat windows {dev}", {
            k: v for k, v in errs.items() if k in MAIN_REF_RTOL}, True)
        check_metric_errors(f"flat windows {dev}", {
            k: v for k, v in errs.items() if k in MAIN_NO_REF_ATOL}, False)
    print(f"main phase: {time.perf_counter() - t_phase:.1f} s; the float64 "
          f"oracle {oracle_s:.1f} s from its first job to its last on "
          f"{max(os.cpu_count() - 1, 1)} processes, beside the card's runs")
    return runs



# the reference phase: the main phase's DL runs again from reference
# checkpoints (whole-module pickles) through the converter's CLI
REFERENCE_SCENE = 512       # PAN side of the WV-3 scene downgrade_images takes
CODEC_REPEATS = 5           # decodes of the main tree's TIFFs a codec


def run_reference(runs: dict, card: str) -> None:
    """Each DL run of the main phase as the reference's users run released
    weights: its modules pickled whole, as classes of the reference's
    module paths declared only while saving
    (`convert.from_reference.write_reference_checkpoint`, MutInf's `mi`
    too, iteration max_iter); converted by `python -m
    lgteun_tpu_torch.convert.from_reference ...` in subprocesses, all
    started together; then `main.cli -c CONFIG --test-only --device cuda
    --checkpoint` (a strict load) from build/chip_smoke/main/reference:
    last_iter restored, each kernel's launches as in the main
    phase's eval forwards, the saved outputs of both splits bit-equal to
    the main phase's from the same weights, every TIFF read by the native
    codec."""
    from lgteun_tpu_torch import main as port_main
    from lgteun_tpu_torch.convert.from_reference import \
        write_reference_checkpoint
    from lgteun_tpu_torch.data import dataset
    from lgteun_tpu_torch.runner import Runner

    t_phase = time.perf_counter()
    work = os.path.join(MAIN_ROOT, "reference")
    os.makedirs(work)
    env = main_env(os.path.join(MAIN_ROOT, "data"))
    files, procs = {}, {}
    t0 = time.perf_counter()
    for name, run in runs.items():
        cfg = run["runner"].cfg
        pth = os.path.join(work, f"{name}_model_iter_{cfg.max_iter}.pth")
        out = os.path.join(work, f"{name}_model_iter_{cfg.max_iter}.pt")
        modules = {k: m for k, m in run["runner"].method.modules().items()
                   if k != "discriminator"}
        write_reference_checkpoint(pth, modules, cfg.max_iter, name,
                                   cfg={"model_type": name,
                                        "ms_chans": cfg.ms_chans})
        files[name] = (pth, out)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, run in runs.items():
        cmd = [sys.executable, "-m",
               "lgteun_tpu_torch.convert.from_reference", "--model-type",
               name, "--torch-ckpt", files[name][0], "--out", files[name][1]]
        procs[name] = subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, **env, "PYTHONPATH": REPO,
                            "CUDA_VISIBLE_DEVICES": ""})
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    convert_s = time.perf_counter() - t0
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"reference {name}: the converter exited "
                                 f"{proc.returncode}:\n{logs[name]}")
    print(f"reference: {len(runs)} whole-module pickles written in "
          f"{write_s:.2f} s, converted by {len(procs)} CLI processes started "
          f"together in {convert_s:.2f} s")

    keep_save = Runner._save_outputs
    dataset.CODEC_READS.clear()
    tiffs = 0
    for name, run in runs.items():
        saved = {}

        def record(self, outputs, iter_id, ref, saved=saved):
            saved[ref] = outputs
            return keep_save(self, outputs, iter_id, ref)

        pth, out = files[name]
        args = ["-c", run["config"], "--test-only", "--device", "cuda",
                "--checkpoint", out]
        with mock.patch.dict(os.environ, env), contextlib.chdir(work), \
                mock.patch.object(Runner, "_save_outputs", record):
            wrappers = reset_launches()
            t0 = time.perf_counter()
            runner = port_main.cli(args)
            wall = time.perf_counter() - t0
        cfg = runner.cfg
        forwards = 2 * -(-MAIN_IMAGES // cfg.eval_batch_size)
        counted = check_launches(f"reference {name}", wrappers,
                                 MAIN_ROUTE.get(name, {}), forwards)
        same = {}
        for ref in (True, False):
            mine, main_run = saved[ref], run["saved"][ref]
            same[ref] = (len(mine) == len(main_run) and all(
                list(a_ids) == list(b_ids) and np.array_equal(a, b)
                for (a_ids, a), (b_ids, b) in zip(mine, main_run)))
        tiffs += sum(len(ds.pairs) * 2 + sum(
            "target" in ds[i] for i in range(len(ds)))
            for ds in (runner.test_ds_reduced, runner.test_ds_full))
        print(f"reference {name}: {os.path.getsize(pth) / 2**20:.2f} MiB "
              f"pickle ({os.path.basename(pth)}) -> the CLI's checkpoint -> "
              f"main.cli {' '.join(args[2:5])} in {wall:.2f} s; last_iter "
              f"{runner.last_iter} (pickled {cfg.max_iter}); outputs of "
              f"both splits bit-equal to the main phase's: reduced "
              f"{same[True]}, full {same[False]}; launches "
              f"{ {k: v for k, v in counted.items() if v} } over {forwards} "
              f"forwards  [{card}]")
        if runner.last_iter != cfg.max_iter or not all(same.values()):
            raise AssertionError(f"reference {name}: last_iter "
                                 f"{runner.last_iter} of {cfg.max_iter}, "
                                 f"outputs bit-equal {same}")
    reads = dict(dataset.CODEC_READS)
    print(f"reference: TIFF reads by codec {reads} ({tiffs} files)")
    if reads != {"native": tiffs}:
        raise AssertionError(f"reference: the native codec did not read "
                             f"every TIFF: {reads} of {tiffs}")
    print(f"reference phase: {time.perf_counter() - t_phase:.1f} s")


def run_data(card: str) -> None:
    """The native TIFF codec (built with g++ at first use) on every TIFF of
    the main phase's tree, bit-equal to the Python codec, and its decode
    rate beside the Python codec's and the batch decoder's (warm file
    cache); then `downgrade_images` of a REFERENCE_SCENE^2 WV-3 scene,
    which must not import PIL (the sensor branch's PAN resize is the
    port's numpy one), held to Pillow's resize where the host has it."""
    import importlib.util

    from lgteun_tpu_torch import native
    from lgteun_tpu_torch.data import synthetic
    from lgteun_tpu_torch.data.tiff import read_tiff as read_tiff_python

    lib = native.get_lib()
    if lib is None:
        raise AssertionError("data: the native TIFF codec did not build")
    data = os.path.join(MAIN_ROOT, "data", "WV-3")
    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(data)
                   for f in fs if f.endswith(".tif"))
    pairs = [(native.read_tiff_native(p), read_tiff_python(p))
             for p in paths]
    equal = all(a is not None and a.dtype == b.dtype
                and np.array_equal(a, b) for a, b in pairs)
    mib = sum(b.nbytes for _, b in pairs) / 2**20
    rates = {}
    for codec, read in (("native", native.read_tiff_native),
                        ("python", read_tiff_python)):
        t0 = time.perf_counter()
        for _ in range(CODEC_REPEATS):
            for p in paths:
                read(p)
        rates[codec] = CODEC_REPEATS * mib / (time.perf_counter() - t0)
    mul = [p for p in paths if p.endswith("_mul.tif")]
    shape = read_tiff_python(mul[0]).shape
    t0 = time.perf_counter()
    for _ in range(CODEC_REPEATS):
        batch = native.read_batch_native(mul, shape, scale=1 / DN_RANGE)
    batch_rate = (CODEC_REPEATS * len(mul) * int(np.prod(shape)) * 2 / 2**20
                  / (time.perf_counter() - t0))
    batch_equal = batch is not None and np.array_equal(
        batch, np.stack([read_tiff_python(p).astype(np.float32)
                         * np.float32(1 / DN_RANGE) for p in mul]))
    print(f"data: native codec {lib._name.rsplit('/', 1)[-1]}: {len(paths)} "
          f"TIFFs ({mib:.2f} MiB of samples) bit-equal to the Python codec: "
          f"{equal}; decode {rates['native']:.1f} MiB/s (Python codec "
          f"{rates['python']:.1f} MiB/s), batch decoder of the {len(mul)} "
          f"{list(shape)} targets {batch_rate:.1f} MiB/s (8 threads, "
          f"equal to the scaled Python decode: {batch_equal}); warm file "
          f"cache, {CODEC_REPEATS} passes  [{card}]")
    if not (equal and batch_equal):
        raise AssertionError("data: the native codec differs from the "
                             "Python codec")
    rng = np.random.default_rng(SEED + 9)
    _, pan, hrms = synthetic.make_synthetic_scene(rng, REFERENCE_SCENE, 8,
                                                  sensor="WV3")
    pil_loaded = "PIL" in sys.modules
    t0 = time.perf_counter()
    ms_lr, pan_lr = synthetic.downgrade_images(hrms, pan, sensor="WV3")
    took = time.perf_counter() - t0
    side = REFERENCE_SCENE // 4
    ok = (ms_lr.shape == (side, side, 8) and pan_lr.shape == (side, side, 1)
          and np.isfinite(ms_lr).all() and np.isfinite(pan_lr).all()
          and 0 < pan_lr.min() and pan_lr.max() < 2048
          and ("PIL" in sys.modules) == pil_loaded)
    pil = "no PIL on this host"
    if importlib.util.find_spec("PIL") is not None:
        # where the host has Pillow after all: the sensor branch's PAN
        # against Pillow's own resize (the JAX package's call)
        from PIL import Image

        padded = np.pad(pan.astype(np.float64), 8, "symmetric")
        want = np.asarray(Image.fromarray(padded.astype(np.float32),
                                          mode="F").resize(
            (padded.shape[1] // 4, padded.shape[0] // 4), Image.BICUBIC),
            np.float64)[2:-2, 2:-2]
        gap = float(np.abs(pan_lr[..., 0] - want).max() / np.abs(want).max())
        pil = f"PAN vs Pillow's resize {gap:.3e} of max|pan| (bound 2e-6)"
        ok = ok and gap <= 2e-6
    print(f"data: downgrade_images of a {REFERENCE_SCENE}^2 WV-3 scene in "
          f"{took:.2f} s on the host, PIL not imported: MS "
          f"{list(ms_lr.shape)}, PAN {list(pan_lr.shape)} in "
          f"[{pan_lr.min():.1f}, {pan_lr.max():.1f}] DN; {pil}")
    if not ok:
        raise AssertionError(f"data: downgrade_images gave {ms_lr.shape} / "
                             f"{pan_lr.shape} out of range, imported PIL or "
                             f"missed Pillow ({pil})")


# ------------------------------------------------------ training modes

# remat: (config, batch or None for the config's, launches a forward;
# every other kernel 0); the checkpoint's replay launches them again
REMAT = (("unlg_former.py", 16, TRAIN_ROUTE),
         ("MDCUN.py", 16, {"neighborhood_attention": 4}),
         ("lightnet.py", None, {"lightnet_stack": 5}),
         ("INNT.py", None, {"texture_match": 1}))
# a bf16 gradient of B10-B12's training entries vs plain autograd: one
# rounding step of bf16 (a float32 sum in another order, then rounded;
# a step is at most 2^-7 of the value)
BF16_GRAD_STEP = 2.0 ** -7
MODE_STEPS = 3              # steps checked with and without a mode
MODE_TIMED = 3              # timed steps a turn (turns A B B A)
# remat vs the run without it after MODE_STEPS steps: each loss within
# REMAT_LOSS_REL (ROADMAP C.24: the backward's atomics in an unfixed
# order), and each parameter tensor within REMAT_PARAM_REL as a relative
# norm, |diff| / |p|, over the elements whose gradient is not near zero:
# Adam's step is lr * m / sqrt(v), which turns a sign flip of a
# rounding-level gradient into an lr-sized move (INNT's two runs without
# remat differ by 0.21-0.44 of a bias's largest), so the elements whose
# sqrt(v) after the steps is below REMAT_NEAR_ZERO of their tensor's
# largest are counted and set aside. The largest element's move is
# printed, not bounded: on UnlgFormer two runs without remat differ by
# 4.7e-4-9.5e-4 of a weight's largest (a few hundredths of an lr step on
# one element), at the 1e-3 itself, where the norm reads 4e-5-7e-5
REMAT_LOSS_REL = 1e-3
REMAT_PARAM_REL = 1e-3
REMAT_NEAR_ZERO = 1e-3
# mixed_precision: (config, environment, launches a training forward);
# UnlgFormer selective (B4 only), the rest the blanket cast
MIXED = (("unlg_former.py", {}, {"global_mixer": 5}),
         ("lightnet.py", {}, {}),
         ("MDCUN.py", {}, {"neighborhood_attention": 4}),
         ("INNT.py", {}, {"texture_match": 1}),
         ("INNT.py", {"LGTEUN_FUSED_TM": "0"}, {"patch_match": 1}),
         ("PanFormer.py", {}, {}),
         ("SFIIN.py", {}, {}),
         ("MutInf.py", {}, {}))
MIXED_BATCH = 4
MIXED_ITERS = 20
MIXED_SPREAD = 1.5          # card vs CPU within this x the CPU's spread
# adversarial: (config, gan type, discriminator) and its weight
ADV_DISC = dict(type="PatchDiscriminator", n_feats=64, n_layers=3,
                norm_type="IN")
ADV = (("unlg_former.py", "LSGAN"), ("lightnet.py", "GAN"),
       ("lightnet.py", "LSGAN"), ("lightnet.py", "WGAN-GP"))
ADV_W = 1e-3
ADV_STEPS = 10
# the discriminator's float32 gradients against float64, of each tensor's
# largest: float32 resolves a weight that feeds an instance norm only so
# far, on either device (an H100 read up to 3.5e-2 on the card and 2.3e-2
# on the CPU, one step of PatchDiscriminator(64, 3) at 128^2)
ADV_D_F32_TOL = 1e-1


def mode_cfg(config: str, drop0: bool = False, **extras):
    """The shipped `config` with `extras` (remat, mixed_precision), the
    dropout at 0 where `drop0` (a card-vs-CPU step: the two devices'
    generators draw other masks)."""
    from lgteun_tpu_torch.config import load_config
    cfg = load_config(os.path.join(CONFIGS, config))
    cfg.extras.update(extras)
    cfg.save_freq = cfg.eval_freq = cfg.test_freq = 0
    if drop0 and "core_module" in cfg.model_cfg:
        cfg.model_cfg = copy.deepcopy(cfg.model_cfg)
        cfg.model_cfg["core_module"]["drop_rate"] = 0.0
    return cfg


def mode_runner(cfg, env: dict, device: str, train_ds=None, like=None):
    """A Runner of `cfg` on `device`, seeded (SEED) or with the weights of
    Runner `like` in every module."""
    from lgteun_tpu_torch.runner import Runner
    method = zoo_method(cfg, env, device)
    runner = Runner(cfg, method, device, train_ds=train_ds)
    if like is None:
        runner.init(SEED)
    else:
        method.init_params(torch.Generator().manual_seed(SEED), (32, 128))
        for name, module in like.method.modules().items():
            method.load_module_state_dict(name, {
                k: v.to(device) for k, v in module.state_dict().items()})
    return runner.set_optim()


def step_grads(runner, batch: dict, iter_id: int = 0) -> tuple:
    """(loss, every module's gradients as one float64 CPU vector) of the
    step's loss at `iter_id` (no optimiser step; remat and the cast as the
    Runner runs them)."""
    runner.method.train()
    for module in runner.method.modules().values():
        module.zero_grad(set_to_none=True)
    total, _ = runner._losses(batch, iter_id)
    total.backward()
    grads = [p.grad.detach().double().cpu().flatten()
             for module in runner.method.modules().values()
             for p in module.parameters() if p.grad is not None]
    return total.item(), torch.cat(grads)


def turns_ms(runners: dict, batch_of: dict) -> tuple[dict, dict]:
    """Median step ms and peak GiB of each Runner of `runners` {label:
    runner}, in turns A B B A of MODE_TIMED steps (peak: the largest
    `max_memory_allocated` over its steps, every runner's weights and
    optimiser states resident)."""
    times, peaks = collections.defaultdict(list), collections.defaultdict(
        float)
    labels = list(runners)
    for label in labels + labels[::-1]:
        runner, batch = runners[label], batch_of[label]
        for i in range(MODE_TIMED):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runner.train_step(batch, 10 + i)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
            peaks[label] = max(peaks[label],
                               torch.cuda.max_memory_allocated() / 2 ** 30)
    return ({k: statistics.median(v) * 1e3 for k, v in times.items()},
            dict(peaks))


def flat_params(runner) -> dict:
    return {f"{m}.{k}": v.detach().double().cpu()
            for m, mod in runner.method.modules().items()
            for k, v in mod.state_dict().items() if v.is_floating_point()}


def adam_rms(runner) -> dict:
    """{flat key: sqrt of Adam's second moment} of each parameter that
    `runner`'s optimisers have stepped."""
    out = {}
    for m, mod in runner.method.modules().items():
        state = runner.optimizers[m].state
        for k, p in mod.named_parameters():
            if p in state:
                out[f"{m}.{k}"] = state[p]["exp_avg_sq"].sqrt().double().cpu()
    return out


def param_gap(a: dict, b: dict,
              rms: dict) -> tuple[dict, dict, int, int]:
    """Over the elements whose sqrt(v) in `rms` is at least
    REMAT_NEAR_ZERO of their tensor's largest (a key that `rms` lacks
    keeps every element): ({key: |a - b| / |a|}, {key: max|a - b| /
    max|a|}, the elements set aside, all elements)."""
    norm, peak, aside, total = {}, {}, 0, 0
    for k in a:
        keep = torch.ones_like(a[k], dtype=torch.bool)
        if k in rms:
            keep = rms[k] >= REMAT_NEAR_ZERO * rms[k].max()
        d = (a[k] - b[k])[keep]
        norm[k] = (d.norm() / a[k][keep].norm().clamp(min=1e-30)).item()
        peak[k] = (d.abs().max() / a[k].abs().max().clamp(min=1e-30)
                   ).item() if d.numel() else 0.0
        aside += int((~keep).sum())
        total += keep.numel()
    return norm, peak, aside, total


def run_remat(train_ds, card: str) -> None:
    """`remat=True` (the loss inside torch.utils.checkpoint) on the card
    for each of REMAT from the same seeded weights as two runs without
    it: the first step's loss bit-equal, each loss within REMAT_LOSS_REL,
    each parameter tensor after MODE_STEPS steps within REMAT_PARAM_REL
    as a relative norm where its gradient is not near zero (`param_gap`;
    the largest element's move and the runs' spread without remat
    printed beside), the kernels launched twice a step (the forward,
    then the backward's replay), and step ms and peak GiB in turns with
    a run without remat."""
    from lgteun_tpu_torch.data.pipeline import train_iterator

    failures = []
    for config, bsz, route in REMAT:
        cfg = mode_cfg(config)
        bsz = bsz or cfg.train_set_cfg.batch_size
        env = TRAIN_ENV if cfg.model_type == "UnlgFormer" else {}
        tag = f"remat {cfg.model_type} batch {bsz}"
        runners, losses, counts = {}, {}, {}
        for label, remat in (("plain", False), ("again", False),
                             ("remat", True)):
            cfg_r = mode_cfg(config, remat=remat)
            runners[label] = mode_runner(cfg_r, env, "cuda")
            batch = runners[label].to_device(next(train_iterator(
                train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED + 11)))
            wrappers = reset_launches()
            losses[label] = [runners[label].train_step(batch, i)[
                "full_loss"].item() for i in range(MODE_STEPS)]
            counts[label] = check_launches(
                f"{tag} remat={remat}", wrappers,
                {k: n * (2 if remat else 1) for k, n in route.items()},
                MODE_STEPS)
        a, b, c = (flat_params(runners[k])
                   for k in ("plain", "remat", "again"))
        rms = adam_rms(runners["plain"])
        rel, moves, aside, total = param_gap(a, b, rms)
        own, own_moves, _, _ = param_gap(a, c, rms)
        worst = max(rel.values())
        bad = worst > REMAT_PARAM_REL
        loss_rel = max(abs(x - y) / abs(x) for x, y in zip(
            losses["plain"], losses["remat"]))
        del runners["again"]
        ms, peak = turns_ms(runners, {"plain": batch, "remat": batch})
        same = losses["plain"][0] == losses["remat"][0]
        print(f"{tag}: first loss {losses['plain'][0]!r} / "
              f"{losses['remat'][0]!r} bit-equal {same}; losses "
              f"{losses['plain']} / {losses['remat']} (worst relative "
              f"{loss_rel:.3e}, bound {REMAT_LOSS_REL:g}; a second run "
              f"without remat {losses['again']}); parameters after "
              f"{MODE_STEPS} steps, where the gradient is not near zero "
              f"(set aside {aside} of {total} elements with sqrt(v) below "
              f"{REMAT_NEAR_ZERO:g} of their tensor's largest): worst "
              f"tensor's |diff| / |p| {worst:.3e} ({max(rel, key=rel.get)}"
              f"; bound {REMAT_PARAM_REL:g}), largest element's max|diff| / "
              f"max|p| {max(moves.values()):.3e}; two runs without remat "
              f"{max(own.values()):.3e} and {max(own_moves.values()):.3e};"
              f" launches "
              f"a step { {k: counts['remat'][k] // MODE_STEPS for k in route}}"
              f" (2x a forward); step {ms['plain']:.3f} ms / remat "
              f"{ms['remat']:.3f} ms ({ms['remat'] / ms['plain']:.3f}x); "
              f"peak {peak['plain']:.2f} / {peak['remat']:.2f} GiB  [{card}]")
        if not (same and loss_rel <= REMAT_LOSS_REL and not bad):
            failures.append(f"{tag}: first loss equal {same}, losses "
                            f"{loss_rel:.3e}, parameters {worst:.3e}")
        del runners
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"remat: {failures}")


def nudge_f32(a: np.ndarray) -> np.ndarray:
    """Each value moved one float32 step up: the selective mode keeps the
    inputs float32, so its spread is taken at a float32 rounding."""
    return np.nextafter(a.astype(np.float32), np.float32(np.inf))


def run_mixed(train_ds, card: str) -> None:
    """`mixed_precision=True` on the card for each of MIXED: UnlgFormer's
    selective mode (batch MIXED_BATCH and 16) and the blanket cast of the
    rest (batch MIXED_BATCH). One drop-0 step's loss and gradients (every
    module) on the card against the CPU plain path in the mode on one
    image, within MIXED_SPREAD x the CPU's own spread at a one-step input
    change (one bf16 step where the cast rounds the inputs, one float32
    step under the selective mode: ROADMAP C.37's form) and the loss
    within a bf16 step; the launches a training forward (every other
    kernel 0: no B1-B3, B5 or B8 under the selective mode); MIXED_ITERS
    iterations of `Runner.train` with a finite loss whose `rec_loss`
    window mean falls; step ms and peak GiB in turns with float32."""
    from lgteun_tpu_torch.data.pipeline import train_iterator

    failures = []
    for config, env, route in MIXED:
        cfg = mode_cfg(config, drop0=True, mixed_precision=True)
        selective = cfg.model_type == "UnlgFormer"
        env = dict(TRAIN_ENV, **env) if selective else env
        tag = (f"mixed {cfg.model_type}"
               + "".join(f" ({k}={v})" for k, v in env.items()
                         if k == "LGTEUN_FUSED_TM")
               + (" selective" if selective else " blanket"))
        card_r = mode_runner(cfg, env, "cuda")
        cpu_r = mode_runner(cfg, env, "cpu", like=card_r)
        one = next(train_iterator(train_ds, 1, bit_depth=cfg.bit_depth,
                                  seed=SEED + 12))
        nudge = nudge_f32 if selective else bf16_step
        moved = {k: nudge(v) if k != "target" else v for k, v in one.items()}
        wrappers = reset_launches()
        card_l, card_g = step_grads(card_r, card_r.to_device(one))
        counted = check_launches(tag, wrappers, route, 1)
        cpu_l, cpu_g = step_grads(cpu_r, cpu_r.to_device(one))
        moved_l, moved_g = step_grads(cpu_r, cpu_r.to_device(moved))
        gap = (card_g - cpu_g).abs().mean().item()
        spread = (moved_g - cpu_g).abs().mean().item()
        dtypes = {str(p.dtype) for m in card_r.method.modules().values()
                  for p in m.parameters()}
        print(f"{tag}: launches a training forward "
              f"{ {k: counted[k] for k in route} } (every other 0); loss "
              f"card {card_l:.6f} cpu {cpu_l:.6f} (moved input "
              f"{moved_l:.6f}); gradients mean|card - cpu| {gap:.3e} = "
              f"{gap / max(spread, 1e-30):.3f} of the cpu's own spread at a "
              f"one-{'float32' if selective else 'bf16'}-step input change "
              f"({spread:.3e}; bound {MIXED_SPREAD}); blanket cast "
              f"{card_r.blanket}; master dtypes {sorted(dtypes)}  [{card}]")
        if not (gap <= MIXED_SPREAD * spread
                and abs(card_l - cpu_l) <= 2 ** -8 * abs(cpu_l)
                and dtypes == {"torch.float32"}):
            failures.append(f"{tag}: card vs cpu {gap:.3e} (spread "
                            f"{spread:.3e}), loss {card_l} / {cpu_l}")
        del cpu_r

        # MIXED_ITERS iterations of the shipped config (its dropout) in
        # the mode
        cfg_t = mode_cfg(config, mixed_precision=True)
        cfg_t.max_iter, cfg_t.log_freq = MIXED_ITERS, TRAIN_LOG
        cfg_t.work_dir = os.path.join(REPO, "build", "chip_smoke",
                                      f"mixed_{cfg.model_type}")
        runner = mode_runner(cfg_t, env, "cuda", train_ds=train_ds)
        cfg_t.train_set_cfg.batch_size = MIXED_BATCH
        runner.train()
        rec = [parts["rec_loss"] for _, parts in runner.loss_log]
        full = [parts["full_loss"] for _, parts in runner.loss_log]
        print(f"{tag}: {MIXED_ITERS} iterations at batch {MIXED_BATCH}: "
              f"rec_loss {', '.join(f'{v:.6f}' for v in rec)}  [{card}]")
        if not (np.isfinite(rec + full).all() and rec[-1] < rec[0]):
            failures.append(f"{tag}: loss curve {runner.loss_log}")
        if not all(p.dtype == torch.float32 and all(
                v.dtype == torch.float32 for k, v in st.items() if k != "step")
                for opt in runner.optimizers.values()
                for g in opt.param_groups for p in g["params"]
                for st in [opt.state.get(p, {})]):
            failures.append(f"{tag}: a master or Adam state not float32")
        del runner

        # speed in turns with float32 (its own seeded weights)
        f32_r = mode_runner(mode_cfg(config, drop0=True), env, "cuda")
        for bsz in ((MIXED_BATCH, 16) if selective else (MIXED_BATCH,)):
            batch = card_r.to_device(next(train_iterator(
                train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED + 13)))
            ms, peak = turns_ms({"float32": f32_r, "mixed": card_r},
                                {"float32": batch, "mixed": batch})
            print(f"{tag} step batch {bsz}: float32 {ms['float32']:.3f} ms, "
                  f"mixed {ms['mixed']:.3f} ms "
                  f"({ms['float32'] / ms['mixed']:.3f}x); peak "
                  f"{peak['float32']:.2f} / {peak['mixed']:.2f} GiB  [{card}]")
        del card_r, f32_r
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"mixed: {failures}")


@contextlib.contextmanager
def float64_batches():
    """Inside it, the models and the Runner take NHWC batches to NCHW
    float64 (a float64 copy of a method)."""
    import lgteun_tpu_torch.models as models_pkg
    from lgteun_tpu_torch import runner as runner_mod
    from lgteun_tpu_torch.models import base

    nchw = lambda a, dev: torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a).to(device=dev, dtype=torch.float64).permute(
        0, 3, 1, 2).contiguous()
    with mock.patch.object(models_pkg, "_nchw", nchw), \
            mock.patch.object(base, "_nchw", nchw), \
            mock.patch.object(runner_mod, "_nchw", nchw):
        yield


def fixed_eps(eps: torch.Tensor):
    """`runner.gan_d_loss` with WGAN-GP's eps given (the same values on
    both devices, whose generators draw other numbers)."""
    from lgteun_tpu_torch import losses

    def call(*args, **kwargs):
        kwargs.pop("generator", None)
        return losses.gan_d_loss(*args, eps=eps.to(args[1].device),
                                 **kwargs)
    return call


def run_adversarial(train_ds, card: str) -> None:
    """Adversarial training (`Runner._adversarial_step`) on the card for
    each of ADV with a PatchDiscriminator(64, 3, IN) and adv weight ADV_W:
    one drop-0 step (batch 2) of both networks from the same weights (one
    WGAN-GP eps on every run) on the card and on the CPU plain path, each
    in float32 and in float64 (the card's float64 run on the kernels'
    plain versions): the two float64 steps agree within ZOO_F64_GRAD_TOL
    (the same function on both devices), the card's float32 loss parts
    within 5e-4 of float64's, its generator's gradients within the
    training bounds of float64's and its discriminator's within
    ADV_D_F32_TOL (float32 resolves the gradient of a weight that feeds an
    instance norm only to a few 1e-2 of its largest on either device: the
    norm's backward has zero mean a channel, so the weight gradient is a
    sum that cancels; card vs CPU float32 printed); the launches of the
    generator's one forward a step; ADV_STEPS steps at the config's batch
    in which both networks move; the step ms. Then a `QNR_loss` step of
    LightNet (l1 + 0.1 QNR) the same way."""
    from lgteun_tpu_torch import runner as runner_mod
    from lgteun_tpu_torch.config import LossCfg
    from lgteun_tpu_torch.data.pipeline import train_iterator

    failures = []
    cases = [(c, g, {"adv_loss": LossCfg(g, ADV_W)}) for c, g in ADV]
    cases.append(("lightnet.py", None, {"QNR_loss": LossCfg("qnr", 0.1)}))
    for config, gan_type, extra in cases:
        cfg = mode_cfg(config, drop0=True)
        cfg.loss_cfg = {**cfg.loss_cfg, **extra}
        if gan_type:
            cfg.model_cfg = {**cfg.model_cfg, "discriminator": ADV_DISC}
        env = TRAIN_ENV if cfg.model_type == "UnlgFormer" else {}
        tag = (f"adversarial {cfg.model_type} {gan_type}" if gan_type
               else f"qnr {cfg.model_type}")
        route = ({"ln_mixer_head": 5, "window_attention": 5,
                  "block_tail": 5} if cfg.model_type == "UnlgFormer"
                 else {"lightnet_stack": 5})
        card_r = mode_runner(cfg, env, "cuda", train_ds=train_ds)
        runs = {"cpu": mode_runner(cfg, env, "cpu", like=card_r),
                "cpu64": mode_runner(cfg, env, "cpu", like=card_r),
                "card64": mode_runner(cfg, env, "cuda", like=card_r)}
        for key in ("cpu64", "card64"):
            for module in runs[key].method.modules().values():
                module.double()
        two = next(train_iterator(train_ds, 2, bit_depth=cfg.bit_depth,
                                  seed=SEED + 14))
        eps = torch.rand((2, 1, 1, 1),
                         generator=torch.Generator().manual_seed(SEED))

        def one_step(r):
            r.method.train()
            with mock.patch.object(runner_mod, "gan_d_loss", fixed_eps(eps)):
                parts = r.train_step(r.to_device(two), 0)
            grads = {f"{m}.{k}": p.grad.detach().cpu().double()
                     for m, mod in r.method.modules().items()
                     for k, p in mod.named_parameters() if p.grad is not None}
            return {k: v.item() for k, v in parts.items()}, grads

        wrappers = reset_launches()
        card_p, card_g = one_step(card_r)
        check_launches(tag, wrappers, route, 1)
        cpu_p, cpu_g = one_step(runs["cpu"])
        with float64_batches():
            exact_p, exact_g = one_step(runs["cpu64"])
            with swapped_kernels(route, lambda name, fn: kernel_fns(name)[1]):
                _, card64_g = one_step(runs["card64"])
        del runs
        scale, level = grad_level(exact_g)
        rel = lambda g, k: ((g[k] - exact_g[k]).abs().max() / exact_g[
            k].abs().max().clamp(min=1e-300)).item()
        same = max(rel(card64_g, k) for k in level)
        card_64 = {k: rel(card_g, k) for k in level}
        cpu_64 = {k: rel(cpu_g, k) for k in level}
        bound = {k: ADV_D_F32_TOL if k.startswith("discriminator.")
                 else TRAIN_GRAD_TOL for k in level}
        beyond = [k for k in level if card_64[k] > bound[k]] + [
            k for k in exact_g if k not in level and (
                card_g[k] - exact_g[k]).abs().max().item()
            > TRAIN_GRAD_TOL * exact_g[k].abs().max().item()
            + GRAD_ATOL * scale]
        loss_rel = max(abs(card_p[k] - exact_p[k]) / max(abs(exact_p[k]),
                                                         1e-30)
                       for k in exact_p)
        _, vs_cpu, worst, _ = grad_diff((0.0, card_g), (0.0, cpu_g), level,
                                        scale)
        far = max(card_64, key=card_64.get)
        gen_worst = max([v for k, v in card_64.items()
                         if k.startswith("core")] or [0.0])
        print(f"{tag}: one step (2 images, drop 0): parts "
              f"{ {k: round(v, 6) for k, v in card_p.items()} }, card vs "
              f"float64 worst relative {loss_rel:.3e}; gradients of "
              f"{sorted({k.split('.')[0] for k in exact_g})}: card float64 "
              f"vs cpu float64 {same:.3e} (bound {ZOO_F64_GRAD_TOL:g}); vs "
              f"float64, card float32 worst {card_64[far]:.3e} ({far}), cpu "
              f"float32 worst {max(cpu_64.values()):.3e} "
              f"({max(cpu_64, key=cpu_64.get)}); generator worst card "
              f"{gen_worst:.3e}"
              f" (bound {TRAIN_GRAD_TOL:g}), discriminator bound "
              f"{ADV_D_F32_TOL:g}; beyond: {beyond}; card vs cpu float32 "
              f"worst {vs_cpu:.3e} ({worst}); launches a step {route}  "
              f"[{card}]")
        if not (loss_rel <= 5e-4 and same <= ZOO_F64_GRAD_TOL
                and not beyond):
            failures.append(f"{tag}: loss {loss_rel:.3e}, float64 "
                            f"{same:.3e}, tensors {beyond}")
        bsz = cfg.train_set_cfg.batch_size
        before = flat_params(card_r)
        batch = card_r.to_device(next(train_iterator(
            train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED + 15)))
        times, last = [], None
        for i in range(ADV_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = card_r.train_step(batch, 1 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        after = flat_params(card_r)
        moved = {m: max((after[k] - before[k]).abs().max().item()
                        for k in before if k.startswith(m + "."))
                 for m in card_r.method.modules()}
        finite = all(np.isfinite(v.item()) for v in last.values())
        print(f"{tag}: {ADV_STEPS} steps at batch {bsz}: median "
              f"{statistics.median(times[3:]) * 1e3:.3f} ms; largest "
              f"parameter move {moved}; last parts "
              f"{ {k: round(v.item(), 6) for k, v in last.items()} }  "
              f"[{card}]")
        if not (finite and all(v > 0 for v in moved.values())):
            failures.append(f"{tag}: moved {moved}, finite {finite}")
        del card_r
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"adversarial: {failures}")


# data parallelism (the `mesh` phase): steps of the shipped UnlgFormer
# held on a process group against the Runner without one; Adam's eps of
# the two-rank runs held by `params_equivalent` (tests/test_multichip.py:
# at 1e-8 the first update is lr * sign(g) for every element)
MESH_STEPS = 3
MESH_ADAM_EPS = 1e-3
# one step on two ranks vs one (tests/test_torch_port_mesh.py): each
# gradient within MESH_GRAD_REL of its tensor's largest plus
# MESH_GRAD_ATOL of the step's largest, each loss part within
# MESH_PART_REL
MESH_GRAD_REL, MESH_GRAD_ATOL, MESH_PART_REL = 1e-4, 1e-5, 1e-5


def params_equivalent(got: dict, want: dict, lr: float) -> tuple:
    """tests/test_multichip.py::_assert_params_equivalent's criterion on
    {key: tensor} dicts: (the share of elements beyond 2e-6 + 1e-4 |want|,
    the mean |got - want| over lr); equivalent below 0.005 and 0.05."""
    a = torch.cat([torch.as_tensor(got[k]).double().flatten()
                   for k in sorted(want)])
    b = torch.cat([torch.as_tensor(want[k]).double().flatten()
                   for k in sorted(want)])
    dev = (a - b).abs()
    return ((dev > 2e-6 + 1e-4 * b.abs()).double().mean().item(),
            dev.mean().item() / lr)


def grads_within(got: dict, want: dict) -> tuple[float, list]:
    """(the worst gradient gap over MESH_GRAD_REL x its tensor's largest +
    MESH_GRAD_ATOL x the step's largest, the tensors beyond 1)."""
    largest = max(float(np.abs(v).max()) for v in want.values()
                  if v is not None)
    worst, beyond = 0.0, []
    for k, w in want.items():
        if w is None or got[k] is None:
            if (w is None) != (got[k] is None):
                beyond.append(k)
            continue
        share = float(np.abs(got[k] - w).max()) / (
            MESH_GRAD_REL * float(np.abs(w).max()) + MESH_GRAD_ATOL * largest)
        worst = max(worst, share)
        if share > 1:
            beyond.append(k)
    return worst, beyond


def run_mesh(train_ds, card: str, extra_jobs: list = ()) -> list:
    """Data parallelism (`parallel/mesh.py`, the Runner on a mesh): the
    shipped UnlgFormer (level 2, dropout 0.1) on a process group of one
    rank under NCCL (file:// rendezvous) against the Runner without one,
    from the same seeded weights on the same batches: the first loss
    bit-equal, MESH_STEPS losses and the parameters as two runs without a
    group agree (the remat bounds: the bicubic backward's atomics, C.24),
    the kernel launches a training forward unchanged, and the step ms at
    batch 4 and 16 in turns (the cost of the reductions). Then two ranks
    spawned on the one card under gloo (NCCL refuses two ranks on one
    device), each rank's rows of every batch, against one rank in this
    process: MESH_STEPS Adam steps (eps MESH_ADAM_EPS; `params_equivalent`,
    both ranks bit-equal), `Runner.test` at the eval batch (the per-image
    scores), a MutInf step at iteration 3 of 4 and its `mi` regulariser
    alone (loss parts, gradients); the step ms of both, the two ranks
    sharing one card (no speed-up). The spawn also runs `extra_jobs`
    (the space phase's), whose results it returns by rank."""
    import dataclasses as dc

    from lgteun_tpu_torch.config import OptimCfg
    from lgteun_tpu_torch.data.pipeline import train_iterator
    from lgteun_tpu_torch.parallel import ranks
    from lgteun_tpu_torch.parallel.mesh import Mesh, make_mesh
    from lgteun_tpu_torch.runner import Runner

    failures = []
    root = os.path.join(REPO, "build", "chip_smoke", "mesh")
    os.makedirs(root, exist_ok=True)
    rendezvous = os.path.join(root, "nccl_rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    cfg = mode_cfg("unlg_former.py")
    mesh = make_mesh(device="cuda", init_method=f"file://{rendezvous}")
    try:
        # the Runner without a group, given a mesh of one rank (one made
        # by default would join this process's group)
        alone = lambda: Runner(cfg, train_method(cfg), "cuda",
                               mesh=Mesh(device=torch.device("cuda")))
        runners = {"no group": alone(), "again": alone(),
                   "nccl": Runner(cfg, zoo_method(cfg, TRAIN_ENV,
                                                  str(mesh.device)),
                                  mesh.device, mesh=mesh)}
        it = train_iterator(train_ds, cfg.train_set_cfg.batch_size,
                            bit_depth=cfg.bit_depth, seed=SEED + 16)
        batches = [next(it) for _ in range(MESH_STEPS)]
        losses, counts = {}, {}
        for label, runner in runners.items():
            runner.init(SEED).set_optim()
            wrappers = reset_launches()
            losses[label] = [runner.train_step(b, i)["full_loss"].item()
                             for i, b in enumerate(batches)]
            counts[label] = check_launches(f"mesh {label}", wrappers,
                                           TRAIN_ROUTE, MESH_STEPS)
        a, b, c = (flat_params(runners[k])
                   for k in ("no group", "nccl", "again"))
        rms = adam_rms(runners["no group"])
        rel, moves, aside, total = param_gap(a, b, rms)
        own, _, _, _ = param_gap(a, c, rms)
        equal = sum(torch.equal(a[k], b[k]) for k in a)
        same = losses["nccl"][0] == losses["no group"][0]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(
            losses["nccl"], losses["no group"]))
        print(f"mesh nccl world 1: backend {mesh.backend}, world "
              f"{mesh.world}, rank {mesh.rank} on {mesh.device}; "
              f"{MESH_STEPS} steps (batch {cfg.train_set_cfg.batch_size}, "
              f"dropout): first loss bit-equal to the Runner without a "
              f"group {same} ({losses['nccl'][0]!r}); losses "
              f"{losses['nccl']} / {losses['no group']} (worst relative "
              f"{loss_rel:.3e}; a second run without a group "
              f"{losses['again']}); parameters bit-equal {equal} of "
              f"{len(a)} tensors, worst |diff| / |p| {max(rel.values()):.3e}"
              f" (set aside {aside} of {total} near-zero elements; two runs "
              f"without a group {max(own.values()):.3e}; bound "
              f"{REMAT_PARAM_REL:g}); launches a training forward "
              f"{ {k: counts['nccl'][k] // MESH_STEPS for k in TRAIN_ROUTE} }"
              f", the same as without a group "
              f"{counts['nccl'] == counts['no group']}  [{card}]")
        if not (same and loss_rel <= REMAT_LOSS_REL
                and max(rel.values()) <= REMAT_PARAM_REL
                and counts["nccl"] == counts["no group"]):
            failures.append(f"nccl world 1: first loss {same}, losses "
                            f"{loss_rel:.3e}, parameters "
                            f"{max(rel.values()):.3e}")
        del runners["again"]
        for bsz in TRAIN_BATCHES:
            batch = runners["nccl"].to_device(next(train_iterator(
                train_ds, bsz, bit_depth=cfg.bit_depth, seed=SEED + 17)))
            ms, _ = turns_ms(runners, {k: batch for k in runners})
            print(f"mesh step batch {bsz}: without a process group "
                  f"{ms['no group']:.3f} ms, NCCL world 1 {ms['nccl']:.3f} "
                  f"ms ({ms['nccl'] / ms['no group']:.3f}x: a loss "
                  f"all-reduce and one gradient all-reduce a step)  "
                  f"[{card}]")
        del runners
    finally:
        mesh.close()
    torch.cuda.empty_cache()

    # two ranks on the one card (gloo) against one rank in this process:
    # run_training's synthetic train/ and test/ splits
    train_dir = train_ds.image_dirs[0]
    dirs = {"train": train_dir,
            "test": os.path.join(os.path.dirname(train_dir), "test")}

    def mesh_cfg(config: str, work: str, **kw):
        c = mode_cfg(config)
        c.optim_cfg = {name: dc.replace(c.optim_cfg.get(name, OptimCfg()),
                                        eps=MESH_ADAM_EPS)
                       for name in ("core_module", "mi")}
        c.train_set_cfg.dataset.image_dirs = [dirs["train"]]
        c.test_set1_cfg.dataset.image_dirs = [dirs["test"]]
        c.test_set0_cfg.dataset.image_dirs = []
        c.log_freq, c.work_dir = 1, os.path.join(root, work)
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    unlg = mesh_cfg("unlg_former.py", "unlg", max_iter=MESH_STEPS)
    mutinf = mesh_cfg("MutInf.py", "mutinf", max_iter=4)
    mi_batch = next(train_iterator(train_ds, mutinf.train_set_cfg.batch_size,
                                   bit_depth=mutinf.bit_depth,
                                   seed=SEED + 18))
    jobs = [(ranks.train_job, dict(cfg=unlg, stops=(1,))),
            (ranks.test_job, dict(cfg=unlg, save=False)),
            (ranks.train_job, dict(cfg=mutinf, start=3)),
            (ranks.mi_job, dict(cfg=mutinf, batch=mi_batch, iter_id=2))]
    with mock.patch.dict(os.environ, TRAIN_ENV):
        one = [job(make_mesh(device="cuda"), **copy.deepcopy(kw))
               for job, kw in jobs]
        t0 = time.perf_counter()
        two = ranks.spawn(jobs + list(extra_jobs), 2,
                          os.path.join(root, "spawn"), device="cuda")
        spawn_s = time.perf_counter() - t0
    extra = [r[len(jobs):] for r in two]
    r0, r1 = two
    lr = unlg.optim_cfg["core_module"].lr
    bits = all(np.array_equal(r0[0]["state"][k], r1[0]["state"][k])
               for k in r0[0]["state"])
    share, mean_dev = params_equivalent(r0[0]["state"], one[0]["state"], lr)
    loss_gaps = [abs(x[1]["full_loss"] - y[1]["full_loss"])
                 / abs(y[1]["full_loss"])
                 for x, y in zip(r0[0]["loss_log"], one[0]["loss_log"])]
    # an iteration's wall time after the first (which takes each new
    # process's one-time costs: CUDA context, library handles)
    steady = lambda r: r[0]["seconds"][MESH_STEPS] / (MESH_STEPS - 1) * 1e3
    print(f"mesh gloo 2 ranks on one card: {MESH_STEPS} steps of the shipped "
          f"UnlgFormer (batch {unlg.train_set_cfg.batch_size}: 2 rows a "
          f"rank, dropout; Adam eps {MESH_ADAM_EPS:g}) against one rank: "
          f"ranks bit-equal {bits}; elements beyond 2e-6 + 1e-4 |p| "
          f"{share:.5f} (bound 0.005), mean |diff| / lr {mean_dev:.3e} "
          f"(bound 0.05); first loss relative {loss_gaps[0]:.3e} (bound "
          f"{MESH_PART_REL:g}), the later ones (after Adam steps) "
          f"{max(loss_gaps):.3e} (bound {REMAT_LOSS_REL:g}); iterations 2-"
          f"{MESH_STEPS} of train() {steady(r0):.1f} / {steady(r1):.1f} ms "
          f"an iteration on the two ranks sharing the card (two processes "
          f"time-sliced on one device; gloo, host-staged collectives), one "
          f"rank {steady(one):.1f} ms (data included; not a speed-up: one "
          f"card); the spawn {spawn_s:.1f} s  [{card}]")
    if not (bits and share < 0.005 and mean_dev < 0.05
            and loss_gaps[0] <= MESH_PART_REL
            and max(loss_gaps) <= REMAT_LOSS_REL):
        failures.append(f"gloo 2 ranks: bits {bits}, share {share}, mean "
                        f"{mean_dev}, losses {loss_gaps}")
    # each per-image score against one rank's, relative (SSIM and Q, in
    # [-1, 1], absolute), within its float32 accuracy against float64
    # (MAIN_REF_RTOL): the forward at 8 rows is not the forward at 16 to
    # the bit wherever a library picks its algorithm by batch size
    tag = "reduced-res (ref)"
    want = one[1]["image_scores"][tag]
    unit = ("ssim", "qindex")
    score_gap = {k: max(max(abs(x - y) / max(abs(y), 1.0 if k in unit
                                             else 1e-30)
                            for x, y in zip(r[1]["image_scores"][tag][k], v))
                        for r in two)
                 for k, v in want.items() if k != "image_id"}
    ids_ok = all(r[1]["image_scores"][tag]["image_id"] == want["image_id"]
                 for r in two)
    print(f"mesh gloo 2 ranks: Runner.test of {len(want['image_id'])} "
          f"images at eval batch {unlg.eval_batch_size} (8 rows a rank): "
          f"ids in order {ids_ok}; per-image scores against one rank, worst "
          f"{ {k: f'{v:.2e}' for k, v in score_gap.items()} } (bounds "
          f"{MAIN_REF_RTOL}); time per image "
          f"{r0[1]['time_per_image'][True] * 1e3:.3f} / one rank "
          f"{one[1]['time_per_image'][True] * 1e3:.3f} ms  [{card}]")
    if not (ids_ok and all(v <= MAIN_REF_RTOL[k]
                           for k, v in score_gap.items())):
        failures.append(f"gloo 2 ranks test: {score_gap}")
    (_, got), = r0[2]["loss_log"]
    (_, ref), = one[2]["loss_log"]
    part_gap = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
                   for k in ref)
    worst, beyond = grads_within(r0[3]["grads"], one[3]["grads"])
    mi_gap = abs(r0[3]["value"] - one[3]["value"]) / abs(one[3]["value"])
    mi_bits = r0[3]["value"] == r1[3]["value"]
    print(f"mesh gloo 2 ranks: MutInf step at iteration 3 of 4, parts "
          f"{ {k: round(v, 6) for k, v in got.items()} } (worst relative "
          f"to one rank {part_gap:.3e}, bound {MESH_PART_REL:g}); its `mi` "
          f"regulariser before the clip {r0[3]['value']:.6f} / one rank "
          f"{one[3]['value']:.6f} (relative {mi_gap:.3e}; the ranks equal "
          f"{mi_bits}), gradients worst {worst:.3f} of the bound, beyond "
          f"{beyond}  [{card}]")
    if not (part_gap <= MESH_PART_REL and mi_gap <= MESH_PART_REL
            and mi_bits and not beyond):
        failures.append(f"gloo 2 ranks MutInf: parts {part_gap}, mi "
                        f"{mi_gap}, gradients {beyond}")
    if failures:
        raise AssertionError(f"mesh: {failures}")
    return extra


# height-sharded eval forwards (the `space` phase): each case's output
# within SPACE_REL of max|out| of the whole forward's
# (tests/test_spatial.py's 1e-5), its launches a forward on each rank
SPACE_REL = 1e-5
SPACE_TIMED = 5     # timed forwards a case, on the ranks and whole
SPACE_ROUTE = {"UnlgFormer": {"ln_mixer_head": 5, "window_attention": 5,
                              "block_tail": 5},
               "lightnet": {"lightnet_stack": 5}, "SFIM": {}, "Wavelet": {},
               "MDCUN": {"neighborhood_attention": 4},
               "INNT": {"texture_match": 1}, "GSA": {}, "MutInf": {},
               "SFIIN": {}, "PanFormer": {}}
# the bf16 entries at a rank's shapes: B12 on a strip of MDCUN's 256^2
# forward on two ranks (its 128 rows and a 7-row halo), B10 / B11 on a
# share of INNT's patch-images
SPACE_STRIP = (1, 8, 135, 256)
SPACE_SHARE = 512
# UnlgFormer's other forms on strips: (LGTEUN_FUSE_LEVEL,
# LGTEUN_FUSED_ATTENTION) -> launches a forward, in each storage mode
SPACE_FORMS = {("1", "1"): {"window_attention": 5, "global_mixer": 5,
                            "ln_ffn": 5},
               ("2", "1"): SPACE_ROUTE["UnlgFormer"],
               ("3", "1"): {"lgb_block": 5},
               ("1", "v2"): {"window_attention_windows": 5,
                             "global_mixer": 5, "ln_ffn": 5},
               ("2", "v2"): {"ln_mixer_head": 5,
                             "window_attention_windows": 5,
                             "block_tail": 5}}


def space_jobs() -> list:
    """The space phase's `ranks.spatial_job`s, [(job, kwargs)]: the
    shipped UnlgFormer (seeded) at pan 128^2 and 240^2 on {"space": 2}
    and at 128^2, batch 2, on {"data": 1, "space": 2} (the batch over
    `data`), LightNet (seeded) at pan 1024^2: crops of the seeded
    synthetic WV-3 scene, normalised; SFIM and Wavelet on a 1024^2 scene
    of U(0.1, 0.9) values, as tests/test_spatial.py's large scene, and
    SFIM on the WV-3 scene too (its float32 conditioning there:
    `run_space`). Since the MDCUN, INNT and UnlgFormer forms' strips: the
    shipped MDCUN and INNT (both routes) at pan 128^2 and 256^2, and
    UnlgFormer at 128^2 at fuse levels 1, 2, 3 and v2 (levels 1, 2) in
    float32, bf16res and bf16 (level 1 float32 at 240^2 too), on
    {"space": 2}. Since the rest of the zoo's strips: GSA, MutInf, SFIIN
    and PanFormer at 128^2 and 256^2, MDCUN and INNT (both routes) under
    LGTEUN_EVAL_DTYPE=bf16 at 128^2 and 256^2, PanFormer and SFIIN under
    it at 128^2, and LightNet's tap path at 512^2 (the cast forms held by
    `space_cast_close`); each case's "route" is its launches a
    forward."""
    from lgteun_tpu_torch.parallel import ranks

    lr, pan, target = synthetic_scene(SCENE, 8, SEED + 19, target_too=True)
    lr, pan = lr / DN_RANGE, pan[..., None] / DN_RANGE
    rng = np.random.default_rng(SEED + 20)
    uniform = {"input_lr": rng.uniform(0.1, 0.9, (1, SCENE // 4, SCENE // 4,
                                                  8)).astype(np.float32),
               "input_pan": rng.uniform(0.1, 0.9, (1, SCENE, SCENE, 1)
                                        ).astype(np.float32)}

    def batch(side, corners=((0, 0),)):
        return {"input_lr": np.stack([lr[y // 4:(y + side) // 4,
                                         x // 4:(x + side) // 4]
                                      for y, x in corners]),
                "input_pan": np.stack([pan[y:y + side, x:x + side]
                                       for y, x in corners]),
                "target": np.stack([target[y:y + side, x:x + side]
                                    for y, x in corners]) / DN_RANGE}

    def case(name, config, b, axis=None, env=None, route=None):
        cfg = mode_cfg(config)
        cfg.seed = SEED
        return dict(name=name, method=cfg.model_type, cfg=cfg,
                    weights=None, batch=b, batch_axis=axis, env=env or {},
                    route=(SPACE_ROUTE[cfg.model_type] if route is None
                           else route))

    def form(side, lvl, att, mode):
        env = {"LGTEUN_FUSE_LEVEL": lvl, "LGTEUN_FUSED_ATTENTION": att,
               "LGTEUN_EVAL_DTYPE": mode}
        return case(f"UnlgFormer {side} L{lvl}{' v2' * (att == 'v2')} "
                    f"{mode or 'float32'}", "unlg_former.py", batch(side),
                    env=env, route=SPACE_FORMS[lvl, att])

    space = [case("UnlgFormer 128", "unlg_former.py", batch(128)),
             case("UnlgFormer 240", "unlg_former.py", batch(240)),
             case("LightNet 1024", "lightnet.py", batch(SCENE)),
             case("SFIM 1024", "SFIM.py", uniform),
             case("Wavelet 1024", "Wavelet.py", uniform),
             dict(case("SFIM 1024 WV-3", "SFIM.py", batch(SCENE)),
                  envelope=True)]
    for side in (128, 256):
        space.append(case(f"MDCUN {side}", "MDCUN.py", batch(side)))
        space.append(case(f"INNT {side}", "INNT.py", batch(side)))
        space.append(case(f"INNT {side} FUSED_TM=0", "INNT.py", batch(side),
                          env={"LGTEUN_FUSED_TM": "0"},
                          route={"patch_match": 1}))
    space += [form(128, lvl, att, mode) for lvl, att in SPACE_FORMS
              for mode in ("", "bf16res", "bf16")
              if (lvl, att, mode) != ("2", "1", "")]
    space.append(form(240, "1", "1", ""))
    # the rest of the zoo (ROADMAP A.9.3): float32, the blanket cast
    # (held by `cast`: the whole cast forward's own spread) and LightNet's
    # tap path
    bf16 = {"LGTEUN_EVAL_DTYPE": "bf16"}
    for side in (128, 256):
        space += [case(f"{m} {side}", f"{m}.py", batch(side))
                  for m in ("GSA", "MutInf", "SFIIN", "PanFormer")]
        space += [dict(case(f"MDCUN {side} bf16", "MDCUN.py", batch(side),
                            env=bf16), cast=True),
                  dict(case(f"INNT {side} bf16", "INNT.py", batch(side),
                            env=bf16), cast=True),
                  dict(case(f"INNT {side} bf16 FUSED_TM=0", "INNT.py",
                            batch(side), env={**bf16, "LGTEUN_FUSED_TM": "0"},
                            route={"patch_match": 1}), cast=True)]
    space += [dict(case(f"{m} 128 bf16", f"{m}.py", batch(128), env=bf16),
                   cast=True) for m in ("PanFormer", "SFIIN")]
    space.append(dict(case("LightNet 512 tap path", "lightnet.py",
                           batch(512), env={"LGTEUN_LIGHTNET_DTYPE": "bf16"},
                           route={}), cast=True))
    hybrid = [case("UnlgFormer 128 x2", "unlg_former.py",
                   batch(128, ((0, 0), (256, 384))), "data")]
    return [(ranks.spatial_job, dict(mesh_shape={"space": 2}, cases=space,
                                     timed=SPACE_TIMED)),
            (ranks.spatial_job, dict(mesh_shape={"data": 1, "space": 2},
                                     cases=hybrid, timed=SPACE_TIMED))]


def space_near_ties(method, batch: dict) -> int:
    """The float64 near-tie queries of an INNT forward's search on the
    card (`near_ties`): where another summation order of its inputs may
    pick another sub-patch (ROADMAP C.15)."""
    names = ("texture_match", "patch_match")
    calls = []

    def recorder(name, fn):
        def call(*args):
            calls.append((name, args))
            return fn(*args)
        return call

    with swapped_kernels(names, recorder):
        method.apply(batch)
    return sum(int(near_ties(*search_inputs(k, args)).sum())
               for k, args in calls)


def space_cast_close(name: str, case: dict, method, inputs: dict,
                     got: np.ndarray, want: np.ndarray, card: str) -> bool:
    """A cast form's sharded output against its whole forward on the
    card, as the rest of the zoo under bf16 is held (`run_bf16_zoo`):
    mean|sharded - whole| within BF16_SPREAD of the whole forward's own
    spread at a one-bf16-step input change (`bf16_step`), and the
    sharded output's drift from the float32 whole forward inside
    BF16_DRIFT_*."""
    moved = method.apply({k: bf16_step(v) for k, v in inputs.items()})
    env = {k: v for k, v in case["env"].items()
           if k not in ("LGTEUN_EVAL_DTYPE", "LGTEUN_LIGHTNET_DTYPE")}
    f32 = zoo_method(case["cfg"], {**TRAIN_ENV, **env}, "cuda")
    f32.init_params(torch.Generator().manual_seed(case["cfg"].seed))
    ref = f32.eval().apply(inputs).cpu().numpy()
    spread = float(np.abs(moved.cpu().numpy() - want).mean())
    gap = float(np.abs(got - want).mean())
    scale = float(np.abs(ref).max())
    drift = np.abs(got - ref)
    print(f"space {name}: mean|sharded - whole| {gap:.3e} = "
          f"{gap / max(spread, 1e-30):.3f} of the whole cast forward's own "
          f"spread at a one-bf16-step input change ({spread:.3e}; bound "
          f"{BF16_SPREAD}); drift from the float32 whole forward mean "
          f"{drift.mean() / scale:.3e} max {drift.max() / scale:.3e} of "
          f"max|out| {scale:.4f} (bounds {BF16_DRIFT_MEAN:g}, "
          f"{BF16_DRIFT_MAX:g})  [{card}]")
    return bool(gap <= BF16_SPREAD * spread
                and drift.mean() <= BF16_DRIFT_MEAN * scale
                and drift.max() <= BF16_DRIFT_MAX * scale)


def run_space(jobs: list, results: list, card: str) -> None:
    """Height-sharded eval forwards (`parallel/spatial.py`, the `space`
    phase): the jobs of `space_jobs`, run by the mesh phase's spawn of
    two gloo ranks sharing the card, against the whole forward of the
    same seeded method (built under the case's switches) on the same
    batch in this process: each output within SPACE_REL of max|out|
    (bit-equality printed), `gather_h` on rank 0 equal to the ranks' rows
    in order, each rank's launches of every kernel a forward (the case's
    route; any other kernel 0), the collectives a forward by kind, and
    the ms of a sharded forward on each rank (the two ranks time-sliced
    on one card: no speed-up) beside the whole forward's alone.

    SFIM divides by the box lowpass of its histogram-matched PAN, which
    comes near 0 on the dark bands of the WV-3 scene: there the float32
    whole forward lies about 1e-4 from float64, and the other order of
    the sharded sums moves its output by as much. That case (`envelope`)
    is held to float64 instead: the sharded output's distance within
    2x the whole float32 forward's. INNT's searches pick a first maximum:
    the float64 near-tie queries of the whole forward are printed, and
    where a case misses SPACE_REL with near ties (another summation
    order of the strips' convs or of m_hr may flip one, ROADMAP C.15),
    its PSNR against the scene's target is held within PSNR_TOL_DB of
    the whole forward's, as the INNT slice is."""
    from lgteun_tpu_torch.data.pipeline import data_denormalize
    from lgteun_tpu_torch.metrics.torch_metrics import psnr_batch
    from lgteun_tpu_torch.models.classical import sfim_fuse
    from lgteun_tpu_torch.parallel.ranks import SPATIAL_WRAPPERS

    failures = []
    for job, (_, kw) in enumerate(jobs):
        shape = kw["mesh_shape"]
        for case in kw["cases"]:
            name = case["name"]
            r0, r1 = (r[job][name] for r in results)
            method = zoo_method(case["cfg"], {**TRAIN_ENV, **case["env"]},
                                "cuda")
            method.init_params(torch.Generator().manual_seed(
                case["cfg"].seed))
            method.eval()
            inputs = {k: v for k, v in case["batch"].items()
                      if k != "target"}
            want = method.apply(inputs)
            whole_ms = time_ms(lambda: method.apply(inputs),
                               iters=SPACE_TIMED, warmup=1)
            want = want.cpu().numpy()
            got = r0["whole"]
            # the ranks' rows in rank order: H, then (hybrid) the batch
            rows = np.concatenate([r0["rows"], r1["rows"]], axis=1)
            scale = float(np.abs(want).max())
            diff = float(np.abs(got - want).max())
            bits = bool(np.array_equal(got, want))
            route = dict.fromkeys(SPATIAL_WRAPPERS, 0)
            route.update(case["route"])
            counts = [r0["launches"], r1["launches"]]
            fired = [{n: c for n, c in launched.items() if c}
                     for launched in counts]
            print(f"space {name} on {shape} {list(want.shape)}: against the "
                  f"whole forward max|diff| {diff:.3e} = "
                  f"{diff / scale:.3e} of max|out| {scale:.4f} (bound "
                  f"{SPACE_REL:g}), bit-equal {bits}; gather_h = the "
                  f"ranks' rows {np.array_equal(rows, got)}; launches a "
                  f"forward rank 0 {fired[0]}, rank 1 {fired[1]}"
                  f" (want {case['route']}); collectives a "
                  f"forward {r0['exchanges']}; sharded forward "
                  f"{r0['ms']:.3f} / {r1['ms']:.3f} ms on the two ranks "
                  f"(wall; time-sliced on one card, gloo host-staged "
                  f"halos), the whole forward alone {whole_ms:.3f} ms (CUDA "
                  f"events)  [{card}]")
            close = diff <= SPACE_REL * scale
            if case.get("cast"):
                close = bits or space_cast_close(name, case, method, inputs,
                                                 got, want, card)
            if case.get("envelope"):
                exact = sfim_fuse(*(torch.as_tensor(
                    inputs[key], dtype=torch.float64, device="cuda")
                    for key in ("input_lr", "input_pan"))).cpu().numpy()
                own = float(np.abs(want - exact).max())
                far = float(np.abs(got - exact).max())
                close = far <= 2 * own
                print(f"space {name}: float64 forward on the card: the "
                      f"whole float32 forward {own:.3e} from it, the "
                      f"sharded {far:.3e} (bound 2x the whole's)  [{card}]")
            if case["method"] == "INNT":
                n_near = space_near_ties(method, inputs)
                note = ""
                if not close and n_near:
                    score = lambda pred: psnr_batch(
                        data_denormalize(torch.from_numpy(pred), 11),
                        data_denormalize(torch.from_numpy(
                            case["batch"]["target"]), 11),
                        dynamic_range=DN_RANGE).item()
                    d_psnr = abs(score(got) - score(want))
                    close = d_psnr <= PSNR_TOL_DB
                    note = (f"; over the bound with near ties: |psnr sharded"
                            f" - psnr whole| {d_psnr:.5f} dB (bound "
                            f"{PSNR_TOL_DB} dB)")
                print(f"space {name}: float64 near-tie queries of the whole "
                      f"forward's search {n_near}{note}  [{card}]")
            if not (got.shape == want.shape and np.isfinite(got).all()
                    and close and np.array_equal(rows, got)
                    and all(c == route for c in counts)):
                failures.append(f"{name}: diff {diff:.3e} of {scale:.3e}, "
                                f"launches {counts}")
            del method
            torch.cuda.empty_cache()
        print(f"space {shape}: a 1-row halo exchange of a [1, 8, 1, 128] "
              f"tensor alone {results[0][job]['exchange_ms']:.3f} / "
              f"{results[1][job]['exchange_ms']:.3f} ms on the two ranks "
              f"(gloo, host-staged, two contexts on one card)  [{card}]")
    if failures:
        raise AssertionError(f"space: {failures}")


def run_bf16_train_entries(gen: torch.Generator, card: str) -> None:
    """The bf16 training entries of B10-B12 (the blanket cast's
    training) at their batch-4 shapes on bf16 inputs and weights: the
    gradients of a loss linear in the outputs against plain autograd of
    `*_ref` on the same bf16 inputs (the backward is that graph): bit-equal,
    within GRAD_REL_TOL, or every element within one bf16 step
    (BF16_GRAD_STEP), since the searches' backward scatter-adds in an
    order CUDA does not fix and then rounds to bf16 (two plain runs are
    printed); the outputs bf16 and within PR 16's bound of the plain
    version's float32 outputs (`bf16_outputs`, as the bf16 eval entries
    are held); and the training call's time (kernel forward + recompute
    backward) beside the plain version's forward + backward."""
    names = ("neighborhood_attention", "texture_match", "patch_match")
    for name, shape, kernel, plain, args in kernel_cases(gen):
        if name not in names or shape not in AUTOGRAD_SHAPES:
            continue
        args = [a.detach().to(BF16).requires_grad_()
                if isinstance(a, torch.Tensor) and a.is_floating_point()
                else a for a in args]
        leaves = [a for a in args if isinstance(a, torch.Tensor)]
        weights = None
        results = []
        for fn in (kernel, plain):
            outs = as_tuple(fn(*args))
            if weights is None:
                weights = [torch.randn(o.shape, generator=gen).cuda()
                           for o in outs]
            loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
            results.append(([o.detach() for o in outs],
                            torch.autograd.grad(loss, leaves)))
        (k_out, k_grads), (p_out, p_grads) = results
        again = torch.autograd.grad(sum(
            (o.float() * w).sum() for o, w in zip(as_tuple(plain(*args)),
                                                  weights)), leaves)
        equal = all(torch.equal(g, w) for g, w in zip(k_grads, p_grads))
        grad = max(rel_err([g.float()], [w.float()])[0]
                   for g, w in zip(k_grads, p_grads))
        spread = max(rel_err([g.float()], [w.float()])[0]
                     for g, w in zip(again, p_grads))
        one_step = all(((g.float() - w.float()).abs() <= BF16_GRAD_STEP * (
            torch.maximum(g.float().abs(), w.float().abs())
            + 1e-4 * w.float().abs().max())).all()
            for g, w in zip(k_grads, p_grads))
        same_out = sum(torch.equal(a, b) for a, b in zip(k_out, p_out))
        with torch.no_grad():
            p32 = as_tuple(plain(*[a.detach() if isinstance(a, torch.Tensor)
                                   else a for a in args],
                                 out_dtype=torch.float32))
        worst, shares, _within, near, ties_ok = bf16_outputs(
            name, [a.detach() for a in leaves], k_out, p32)
        out_ok = (all(o.dtype == BF16 for o in k_out) and worst <= 0
                  and ties_ok and all(v >= BF16_EQUAL for v in shares))

        def step(fn):
            outs = as_tuple(fn(*args))
            return torch.autograd.grad(
                sum((o.float() * w).sum() for o, w in zip(outs, weights)),
                leaves)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: kernel(*args), iters=10)
        train_ms, plain_ms = in_turns(lambda: step(plain),
                                      lambda: step(kernel))
        print(f"autograd {name + ' bf16':24s} {shape:14s} grads of "
              f"{len(leaves)} bf16 tensors bit-equal to plain autograd of "
              f"the ref: {equal} (rel err {grad:.3e}; two plain runs "
              f"{spread:.3e}; every element within a bf16 step {one_step})"
              f"; outputs {[str(o.dtype) for o in k_out]}, "
              f"{same_out}/{len(k_out)} bit-equal to the plain forward; "
              f"against its float32 outputs: |k - p| beyond {BF16_REL:.3e} "
              f"|p| + {KERNEL_REL_TOL:g} max|p| at most {worst:.3e} max|p|, "
              f"equal to bf16(p) {', '.join(f'{v:.5f}' for v in shares)}"
              f"{near}; training call: kernel forward {fwd_ms:.3f} ms, "
              f"kernel forward + recompute backward {train_ms:.3f} ms; "
              f"plain forward + backward "
              f"{plain_ms:.3f} ms  [{card}]")
        if not ((equal or grad <= GRAD_REL_TOL or one_step) and out_ok):
            raise AssertionError(f"autograd {name} bf16 {shape}: grads "
                                 f"{grad:.3e}, outputs {worst:.3e} "
                                 f"{shares} ties {ties_ok}")


# ------------------------------------------------------------------ large

# The `large` phase: planes above 240^2 (ROADMAP A.12). The FFT mixer of
# B1 and B4 takes its cluster route there up to 512^2 and its global route
# above (`spectral_kernel.mixer_route`), and B8 runs level 2's chain
# (`lgb_block_kernel.lgb_route`).
# 1x32x256^2 / 1x64x512^2: cluster; 1x32x1024^2: global; 32x32x256^2:
# `fuse --tile 256`'s batch of 32 tiles (cluster)
LARGE_HEAD = ((1, 32, 256, 256), (1, 32, 1024, 1024), (1, 64, 512, 512),
              (32, 32, 256, 256))
# odd parts 3 and 11 at 264^2; a 2048^2 plane; two non-square ones (the
# second on a cluster of 16); the tile-256 scene's batch (level 1)
LARGE_MIXER = ((1, 16, 264, 264), (1, 16, 1024, 1024), (1, 4, 2048, 2048),
               (1, 4, 1024, 2048), (1, 4, 1024, 512), (32, 16, 256, 256))
# odd sides and prime factors above 512 (ROADMAP A.12.2) on each route
# by shape: one block (15x21; 521 rows: fft_pass_prime), a cluster (W/2
# = 521; 255x257; the strip's bottleneck, 4168 = 8 x 521), the global
# route (1023x1025; the strip's full resolution, 8336 = 16 x 521; 2062 =
# 2 x 1031); the largest prime the limits take, 14,503, as H (the global
# route) and as odd W (a cluster of 16)
LARGE_ODD = (("global_mixer", (2, 8, 15, 21)),
             ("global_mixer", (1, 4, 521, 64)),
             ("global_mixer", (1, 4, 64, 1042)),
             ("global_mixer", (1, 16, 255, 257)),
             ("ln_mixer_head", (1, 64, 4168, 64)),
             ("global_mixer", (1, 4, 1023, 1025)),
             ("ln_mixer_head", (1, 32, 8336, 128)),
             ("global_mixer", (1, 4, 2062, 2062)),
             ("global_mixer", (1, 1, 14503, 16)),
             ("global_mixer", (1, 1, 16, 14503)))
LARGE_CONST = 256           # the constant-plane and bf16 cases' side
# B4's constant planes at odd sides and at a factor of 521
LARGE_CONST_ODD = ((1, 16, 255, 257), (1, 4, 521, 64))
# the bf16 entries' planes: LARGE_CONST^2, odd sides, a factor of 521
LARGE_BF16 = ((LARGE_CONST, LARGE_CONST), (255, 257), (521, 64))
# UnlgFormer on a strip (PAN H x W, LrMS a quarter): its full-resolution
# planes (H = 16 x 521) on the global route, the bottleneck's on a
# cluster; a forward's mixer launches by route at every level
LARGE_STRIP = (8336, 128)
LARGE_STRIP_ROUTES = {"global": 4, "cluster": 1}
LARGE_BLOCK = (1, 32, 1024, 1024)   # B2 and B3 at a whole 1024^2 tile
LARGE_TABLES = ((1024, 1024), (2048, 2048))
# the cluster route forced at each size and the global route forced
# (`lgteun_global_mixer_cluster_route`, `_global_route`) on planes the
# one-block body takes, against that body
LARGE_SAME_BODY = ((4, 16, 128, 128), (1, 4, 240, 240), (2, 8, 15, 21),
                   (1, 4, 521, 64))
LARGE_CLUSTERS = (2, 4, 8, 16)
LARGE_SIDE = 512            # UnlgFormer's PAN side at every level
LARGE_FORMS = {             # (level, attention) -> launches a forward
    ("2", "1"): {"ln_mixer_head": 5, "window_attention": 5,
                 "block_tail": 5},
    ("1", "1"): {"window_attention": 5, "global_mixer": 5, "ln_ffn": 5},
    # every block's planes (512^2 and the 256^2 bottleneck) above B8's:
    # level 2's chain
    ("3", "1"): {"ln_mixer_head": 5, "window_attention": 5,
                 "block_tail": 5},
    ("2", "v2"): {"ln_mixer_head": 5, "window_attention_windows": 5,
                  "block_tail": 5}}
# a forward's mixer launches by route at PAN LARGE_SIDE^2 (every form)
# and on whole LARGE_TILES tiles (level 2: four blocks on the tile's side,
# the bottleneck on half of it)
LARGE_ROUTES_A_FORWARD = {512: {"cluster": 5}, 1024: {"global": 4,
                                                      "cluster": 1},
                          2048: {"global": 5}}
LARGE_TILES = (1024, 2048)  # whole tiles, UnlgFormer level 2, batch 1
LARGE_TIMED = 3             # timed calls of each large case
LARGE_TILING = (256, 16, 480)   # fuse_scene's tile, halo, crop
LARGE_GRAD = (1, 32, 256, 256)  # B1's training entry
# the mixer's two routes in the `kernels` line: name -> (source,
# replaces, main shape, why no library call computes it)
LARGE_ROUTES = {
    "fft_mixer_cluster": ("lgteun_tpu_torch/csrc/fft_mixer.cuh",
                          "lgteun_tpu/ops/spectral_kernel.py:281",
                          "ln_mixer_head 32x32x256x256",
                          "LN + FFT + amp/phase affine + inverse FFT is no "
                          "single call"),
    "fft_mixer_global": ("lgteun_tpu_torch/csrc/spectral_head.cu",
                         "lgteun_tpu/ops/spectral_kernel.py:221",
                         "global_mixer 1x16x1024x1024",
                         "FFT + amp/phase affine + inverse FFT is no "
                         "single call")}


def large_kernel_cases(gen: torch.Generator):
    """(name, shape, kernel, plain, args) of the large phase's cases:
    B1 and B4 at LARGE_HEAD / LARGE_MIXER (the cluster and the global
    route), their constant-plane cases at LARGE_CONST, B2 and B3 at
    LARGE_BLOCK."""
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail, block_tail_ref
    from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                      global_mixer_ref,
                                                      ln_mixer_head,
                                                      ln_mixer_head_ref)
    from lgteun_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_ref)

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def head_w(c):
        c2 = c // 2
        return (1 + 0.1 * n(c), 0.1 * n(c), n(c2), 0.1 * n(c2), n(c2),
                0.1 * n(c2))

    def mix_w(c):
        return (n(c), 0.1 * n(c), n(c), 0.1 * n(c))

    label = lambda shape: "x".join(map(str, shape))
    for shape in LARGE_HEAD:
        yield ("ln_mixer_head", label(shape), ln_mixer_head,
               ln_mixer_head_ref, (n(*shape),) + head_w(shape[1]))
    for shape in LARGE_MIXER:
        yield ("global_mixer", label(shape), global_mixer, global_mixer_ref,
               (n(*shape),) + mix_w(shape[1]))
    for name, shape in LARGE_ODD:
        head = name == "ln_mixer_head"
        yield (name, label(shape), ln_mixer_head if head else global_mixer,
               ln_mixer_head_ref if head else global_mixer_ref,
               (n(*shape),) + (head_w if head else mix_w)(shape[1]))
    for b, c, h, w in LARGE_CONST_ODD:
        for axis in "HW":
            x = (n(b, c, 1, w) if axis == "H" else n(b, c, h, 1)).expand(
                b, c, h, w).contiguous()
            yield ("global_mixer", f"{label((b, c, h, w))}-const{axis}",
                   global_mixer, global_mixer_ref, (x,) + mix_w(c))
    hw = LARGE_CONST
    for axis in "HW":
        const = lambda c: (n(1, c, 1, hw) if axis == "H" else n(1, c, hw, 1)
                           ).expand(1, c, hw, hw).contiguous()
        yield ("ln_mixer_head", f"1x32x{hw}x{hw}-const{axis}", ln_mixer_head,
               ln_mixer_head_ref, (const(32),) + head_w(32))
        yield ("global_mixer", f"1x16x{hw}x{hw}-const{axis}", global_mixer,
               global_mixer_ref, (const(16),) + mix_w(16))
    b, c, h, w = LARGE_BLOCK
    c2, c4 = c // 2, 4 * c
    yield ("window_attention", label(LARGE_BLOCK), window_attention,
           window_attention_ref,
           (n(b, c2, h, w), n(3 * c2, c2, scale=c2 ** -0.5), 0.1 * n(3 * c2),
            n(2, 64, 64), 2, 8))
    ffn = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
           "w1": n(c4, c, scale=c ** -0.5), "b1": 0.1 * n(c4),
           "w2": n(c4, c4, scale=c4 ** -0.5), "b2": 0.1 * n(c4),
           "dw": n(c4, 3, 3, scale=1 / 3), "bdw": 0.1 * n(c4),
           "w3": n(c, c4, scale=c4 ** -0.5), "b3": 0.1 * n(c)}
    yield ("block_tail", label(LARGE_BLOCK), block_tail, block_tail_ref,
           (n(b, c, h, w), n(b, c2, h, w), n(b, c2, h, w),
            n(c, c, scale=c ** -0.5), 0.1 * n(c), ffn))


def large_turns(plain, kernel) -> tuple[float, float]:
    """(kernel ms, plain ms) by CUDA events, LARGE_TIMED calls each,
    timed plain, kernel, kernel, plain."""
    timed = lambda f: time_ms(f, iters=LARGE_TIMED, warmup=1)
    p1, k1, k2, p2 = (timed(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def large_device_ms(call, bound_ms: float, event_ms: float) -> tuple:
    """(device ms a call of `call`, its source): the profiler's busy time
    over LARGE_TIMED calls, traced again (up to 3 times) where it falls
    below `bound_ms`, or below half of `event_ms` (CUDA events around
    LARGE_TIMED calls) where that is above 1 ms and so not the host's.
    CUPTI dropped a long call's events here (B3 at 1024^2 read 0.76 ms of
    its 3.5 ms in one run and no device time at all in another): where
    no trace holds, the events' time is the device time, so labelled."""
    for _attempt in range(3):
        with contextlib.suppress(RuntimeError):   # no device activity
            ms = device_profile(call, n=LARGE_TIMED)["busy_ms_per_call"]
            if ms >= bound_ms and (event_ms < 1.0 or ms >= 0.5 * event_ms):
                return ms, "device"
    return event_ms, "CUDA events: the profiler lost the device time"


def large_profile(tag: str, call, card: str) -> None:
    """`print_profile` of two calls of `call`, or a line saying that the
    profiler recorded no device activity (printed, not a failure: the
    profile is not a check)."""
    try:
        print_profile(tag, device_profile(call, n=2), card)
    except RuntimeError as err:
        print(f"profile {tag}: not measured ({err})")


def mixer_route_of(name: str, x: torch.Tensor) -> dict:
    """`mixer_route` of a B1 (`name` "ln_mixer_head": the second half of
    the channels) or B4 call on x, on this card's SMs."""
    from lgteun_tpu_torch.ops.spectral_kernel import mixer_route
    head = name == "ln_mixer_head"
    planes = x.shape[0] * x.shape[1] // (2 if head else 1)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return mixer_route(*x.shape[-2:], planes, head=head, sms=sms)


def forced_global(name: str, args) -> tuple:
    """The outputs of the B1 or B4 case `name` on `args` with its mixer
    forced onto the global route (`lgteun_ln_mixer_head_global_route`,
    `lgteun_global_mixer_global_route`; checks only)."""
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.spectral_kernel import (fft_global_plan,
                                                      fft_tables)
    x = args[0]
    b, c, h, w = x.shape
    planes = b * c // (2 if name == "ln_mixer_head" else 1)
    scratch = torch.empty(planes * fft_global_plan(h, w)["plane_bytes"] // 4,
                          device=x.device)
    tables = fft_tables(h, w, x.device)
    if name == "ln_mixer_head":
        y1 = torch.empty(b, c // 2, h, w, device=x.device)
        x2 = torch.empty_like(y1)
        _cuda.launch("lgteun_ln_mixer_head_global_route", x.device, x,
                     *args[1:], tables, scratch, y1, x2, b, c, h, w, 1e-5)
        return y1, x2
    out = torch.empty_like(x)
    _cuda.launch("lgteun_global_mixer_global_route", x.device, x, *args[1:],
                 tables, scratch, out, b, c, h, w)
    return (out,)


def check_mixer_route_rule() -> None:
    """The mixer's route in Python (`mixer_route`: which route, and the
    cluster's size, that the wrappers count and the scratch follows)
    equals the library's (`lgteun_fft_mixer_route`, which the launches
    follow) on even squares 2-4096, a 62-step grid of sides 64-2046, a
    grid of odd and even sides 3-2097, sides with a factor 521 or 1031,
    the largest sides and one past them, and 1, 16 and 512 planes on this
    card's SMs."""
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.spectral_kernel import (FFT_MAX_H, FFT_MAX_W,
                                                      FFT_MAX_W_ODD,
                                                      mixer_route)
    lib = _cuda.kernels()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    primes = [521 * k for k in (1, 2, 3, 8, 16)] + [1031, 2062]
    shapes = [(h, h) for h in range(2, 4098, 2)] + [
        (h, w) for h in range(64, 2048, 62) for w in range(64, 2048, 62)] + [
        (h, w) for h in range(3, 2100, 97) for w in range(4, 2100, 89)] + [
        (h, w) for h in primes for w in (15, 64, 128, 257, 1042)] + [
        (w, h) for h in primes for w in (15, 64, 128, 257)] + [
        (FFT_MAX_H + d, 2) for d in (0, 1)] + [
        (2, FFT_MAX_W + d) for d in (0, 2)] + [
        (3, FFT_MAX_W_ODD + d) for d in (0, 2)]
    code = {"smem": 0, "global": -1}
    differ, counts = [], collections.Counter()
    for h, w in shapes:
        for planes in (1, 16, 512):
            r = mixer_route(h, w, planes, sms=sms)
            want = -2 if r is None else code.get(r["route"], r["k"])
            counts[want] += 1
            if lib.lgteun_fft_mixer_route(h, w, planes, sms) != want:
                differ.append((h, w, planes))
    print(f"large mixer route rule: {len(shapes)} shapes x 3 plane counts "
          f"on {sms} SMs, by route (0 one block, K a cluster, -1 global, "
          f"-2 none) {dict(sorted(counts.items()))}; the library agrees on "
          f"all but {len(differ)}")
    if differ:
        raise AssertionError(f"mixer route rule differs at {differ[:5]}")


def large_bf16(nb, h: int, w: int, rec_of, card: str) -> list:
    """The bf16 entries of B1 (C 32) and B4 (C 16) on H x W planes, x
    float32 and bf16, each against the plain version's float32 value
    under the bf16 entries' bound (BF16_REL) over every plane; the rows
    go into `rec_of(name, route)`. Returns the failures."""
    from lgteun_tpu_torch.ops.norm import channel_layer_norm
    from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                      global_mixer_ref,
                                                      ln_mixer_head,
                                                      ln_mixer_head_ref)
    f32, failures = torch.float32, []
    c, c2 = 32, 16
    head = (1 + 0.1 * nb(c), 0.1 * nb(c), nb(c2), 0.1 * nb(c2), nb(c2),
            0.1 * nb(c2))
    x, xp = nb(1, c, h, w), nb(1, c2, h, w)
    cases = []
    for xs in (x, x.to(BF16)):
        cases.append(("ln_mixer_head", f"{str(xs.dtype)[6:]}>bf16", xs,
                      lambda xs=xs: ln_mixer_head(xs, *head, out_dtype=BF16),
                      lambda xs=xs: ln_mixer_head_ref(xs, *head,
                                                      out_dtype=f32)))
    for xs in (xp, xp.to(BF16)):
        cases.append(("global_mixer", f"{str(xs.dtype)[6:]}>bf16", xs,
                      lambda xs=xs: global_mixer(xs, *head[2:],
                                                 out_dtype=BF16),
                      lambda xs=xs: global_mixer_ref(xs, *head[2:],
                                                     out_dtype=f32)))
    for name, lab, xs, kernel, plain in cases:
        got, p = as_tuple(kernel()), as_tuple(plain())
        planes = xs.double()
        if name == "ln_mixer_head":
            planes = channel_layer_norm(planes, head[0].double(),
                                        head[1].double())[:, c2:]
        # every plane counts: a 256^2 plane is likelier than the kernels
        # phase's to hold a bin near zero or the branch cut (the planes
        # that bf16_outputs would set aside are printed, not set aside)
        cut = mixer_cut_planes(planes)
        worst, shares, within, _near, _ok = bf16_outputs(
            name, (xs,) + (head if name == "ln_mixer_head" else head[2:]),
            got, p)
        ok = worst <= 0 and all(v >= BF16_EQUAL for v in shares)
        ms, source = large_device_ms(kernel, 0.0, time_ms(
            kernel, iters=LARGE_TIMED, warmup=1))
        print(f"large {name:17s} 1x{xs.shape[1]}x{h}x{w} bf16 {lab:14s} "
              f"{'ok' if ok else 'FAILED'}: |k - p| beyond {BF16_REL:.3e} "
              f"|p| + {KERNEL_REL_TOL:g} max|p| at most {worst:.3e} max|p|; "
              f"equal to bf16(p) {', '.join(f'{v:.5f}' for v in shares)} "
              f"over every plane (planes with a bin within BF16_CUT of zero "
              f"or the cut: {int(cut.sum())} of {cut.numel()})  kernel "
              f"{ms:.4f} ms ({source})  [{card}]")
        rec = rec_of(name, mixer_route_of(name, xs)["route"])
        rec["by_shape"][f"{name} 1x{xs.shape[1]}x{h}x{w} {lab}"] = {
            "ms": ms, "worst": worst, "equal_share": shares}
        if not ok:
            failures.append(f"bf16 {name} {lab}")
    return failures


def run_large_kernels(gen: torch.Generator, record: dict, card: str) -> None:
    """The kernel cases of the large phase against their plain versions
    on the card (KERNEL_REL_TOL; the constant planes against the CPU
    plain version, as the kernels phase holds them), each with its
    device ms, plain ms, bytes or operations bound and share, the mixer
    cases with their route (each case's first launch counted on the
    route the mirror names), the cuFFT rfft2 + irfft2 yardstick and
    their bits over REPEATS more launches; on each cluster case the
    global route forced on the same inputs, bit-equal and timed (the
    time before the cluster route); the cluster route forced at each of
    LARGE_CLUSTERS and the global route forced on planes the one-block
    body takes, bit-equal to that body; the route rule; the bf16
    entries of B1 and B4 at LARGE_CONST under the bf16 entries' bound
    (BF16_REL) over every plane. The mixer rows go into `record["fft_mixer_cluster"]` or
    `record["fft_mixer_global"]` by route (by wrapper and shape), B2's
    and B3's into theirs."""
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.spectral_kernel import (fft_tables,
                                                      global_mixer,
                                                      global_mixer_ref,
                                                      ln_mixer_head,
                                                      ln_mixer_head_ref)
    wrappers = reset_launches()
    failures = []
    route_recs = {name: record.setdefault(name, {"max_abs_err": 0.0,
                                                 "by_shape": {}})
                  for name in LARGE_ROUTES}

    def rec_of(name: str, route: str) -> dict:
        """The record of a mixer case: its route's, or on the one-block
        body the wrapper's own."""
        if route == "smem":
            return record.setdefault(name, {"max_abs_err": 0.0,
                                            "by_shape": {}})
        return route_recs[f"fft_mixer_{route}"]
    for name, shape, kernel, plain, args in large_kernel_cases(gen):
        mixer = name in ("ln_mixer_head", "global_mixer")
        if mixer:
            route = mixer_route_of(name, args[0])
            before = collections.Counter(wrappers[name].variants)
        got, want = as_tuple(kernel(*args)), as_tuple(plain(*args))
        if mixer:
            first = {layout if layout in ("cluster", "global") else "smem": n
                     for layout, n in (collections.Counter(
                         wrappers[name].variants) - before).items()}
            if first != {route["route"]: 1}:
                failures.append(f"{name} {shape}: launched {first}, the "
                                f"mirror names {route['route']}")
        if "-const" in shape:
            cpu, evidence = const_plane_cpu(name, shape, kernel, plain,
                                            args, got, want)
            print(f"large {name:17s} {shape:18s} card plain vs CPU plain "
                  f"{rel_err(want, cpu)[0]:.3e}")
            print(evidence)
            want = cpu
        rel, ab = rel_err(got, want)
        event_ms, plain_ms = large_turns(lambda: plain(*args),
                                         lambda: kernel(*args))
        bound_ms, bound_by = bound(name, args, want)
        ms, source = large_device_ms(lambda: kernel(*args), bound_ms,
                                     event_ms)
        line = (f"large {name:17s} {shape:18s} rel err {rel:.3e} (max-abs "
                f"{ab:.3e})  kernel {ms:.4f} ms ({source}; events "
                f"{event_ms:.4f})  plain {plain_ms:.4f} ms  bound "
                f"{bound_ms:.4f} ms ({bound_by}; roofline share "
                f"{bound_ms / ms:.3f})")
        row = {"rel_err": rel, "ms": ms, "ms_source": source,
               "event_ms": event_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if mixer:
            row.update(launches_a_call=route["launches"], k=route["k"])
            line += (f"  route {route['route']}"
                     + (f" k {route['k']}" if route["k"] else "")
                     + f": {route['launches']} launches a call, scratch "
                     f"{route['scratch_bytes'] / 2**20:.1f} MiB, "
                     f"{route['rows']} rows and {route['cols']} columns a "
                     f"block")
            if "-" not in shape:
                planes = mixer_planes(name, args)
                fft = lambda: torch.fft.irfft2(torch.fft.rfft2(planes),
                                               s=planes.shape[-2:])
                yard, ysource = large_device_ms(fft, 0.0, time_ms(
                    fft, iters=LARGE_TIMED, warmup=1))
                line += (f"  cuFFT rfft2 + irfft2 on the same planes "
                         f"{yard:.4f} ms ({ysource}; a yardstick only)")
                row["cufft_ms"] = yard
            if route["route"] in ("cluster", "smem") and "-" not in shape:
                routed = forced_global(name, args)
                same_bits = all(map(torch.equal, routed, got))
                g_ms, g_source = large_device_ms(
                    lambda: forced_global(name, args), bound_ms,
                    time_ms(lambda: forced_global(name, args),
                            iters=LARGE_TIMED, warmup=1))
                line += (f"  global route forced: {g_ms:.4f} ms ({g_source}"
                         f"; share {bound_ms / g_ms:.3f}), bit-equal "
                         f"{same_bits}; cluster / global {ms / g_ms:.3f}")
                row.update(global_ms=g_ms, global_bit_equal=same_bits)
                if not same_bits:
                    failures.append(f"{name} {shape}: the cluster route "
                                    f"differs from the global route")
            same = all(all(map(torch.equal, as_tuple(kernel(*args)), got))
                       for _ in range(REPEATS))
            line += f"  {REPEATS} more launches bit-identical: {same}"
            if not same:
                failures.append(f"{name} {shape}: not deterministic")
            rec = rec_of(name, route["route"])
            rec["max_abs_err"] = max(rec["max_abs_err"], ab)
            rec["by_shape"][f"{name} {shape}"] = row
        else:
            rec = record.setdefault(name, {"max_abs_err": 0.0,
                                           "by_shape": {}})
            rec["max_abs_err"] = max(rec["max_abs_err"], ab)
            rec["by_shape"][shape] = row
        print(line + f"  [{card}]")
        if not rel <= KERNEL_REL_TOL:
            failures.append(f"{name} {shape}: rel err {rel:.3e}")
    for name in ("ln_mixer_head", "global_mixer"):
        got = dict(wrappers[name].variants)
        print(f"large {name:17s} launches by layout {got}")
        if not {"cluster", "global"} <= set(got):
            failures.append(f"{name}: layouts {got}, want cluster and "
                            f"global")

    # the routes forced on planes the one-block body also takes: the
    # cluster at every size, the global route
    gen_same = torch.Generator().manual_seed(SEED + 31)
    for shape in LARGE_SAME_BODY:
        b, c, h, w = shape
        x = torch.randn(*shape, generator=gen_same).cuda()
        mix = tuple(torch.randn(c, generator=gen_same).cuda() * s
                    for s in (1.0, 0.1, 1.0, 0.1))
        body = global_mixer(x, *mix)
        plain_err = lambda out: rel_err([out], [global_mixer_ref(x, *mix)])[0]
        tag = "x".join(map(str, shape))
        for k in LARGE_CLUSTERS:
            routed = torch.empty_like(x)
            _cuda.launch("lgteun_global_mixer_cluster_route", x.device, x,
                         *mix, fft_tables(h, w, x.device), routed, b, c, h,
                         w, k)
            same = torch.equal(routed, body)
            print(f"large cluster route forced at {tag} on {k} blocks "
                  f"against the one-block body: bit-equal {same} (rel err "
                  f"{rel_err([routed], [body])[0]:.3e}); against the plain "
                  f"version {plain_err(routed):.3e}")
            if not same:
                failures.append(f"forced cluster {shape} k {k}")
        routed = forced_global("global_mixer", (x,) + mix)[0]
        rel = rel_err([routed], [body])[0]
        print(f"large global route forced at {tag} against the one-block "
              f"body: rel err {rel:.3e}, bit-equal "
              f"{torch.equal(routed, body)}; against the plain version "
              f"{plain_err(routed):.3e}")
        if not rel <= KERNEL_REL_TOL:
            failures.append(f"forced route {shape}: {rel:.3e}")
    check_mixer_route_rule()

    # the bf16 entries on the cluster route at LARGE_BF16 (the bf16
    # entries' bound)
    gen_bf = torch.Generator().manual_seed(SEED + 32)
    nb = lambda *s, scale=1.0: (torch.randn(*s, generator=gen_bf)
                                * scale).cuda()
    for h, w in LARGE_BF16:
        failures += large_bf16(nb, h, w, rec_of, card)
    if failures:
        raise AssertionError(f"large kernels: {failures}")


def large_method(env: dict, device: str):
    """The shipped UnlgFormer (WV-3, 8 bands), seeded (SEED), built
    under `env` on `device`, in eval mode."""
    cfg = mode_cfg("unlg_former.py")
    method = zoo_method(cfg, {**TRAIN_ENV, **env}, device)
    method.init_params(torch.Generator().manual_seed(SEED))
    method.eval()
    return method


def large_batch(side: int, seed: int) -> dict:
    """A crop of the seeded synthetic WV-3 scene at PAN side `side` (batch
    1), normalised."""
    lr, pan = synthetic_scene(max(side, SCENE), 8, seed)
    return {"input_lr": (lr[None, :side // 4, :side // 4] / DN_RANGE),
            "input_pan": (pan[None, :side, :side, None] / DN_RANGE)}


def mixer_routes(wrappers: dict) -> dict:
    """The mixer's launches by route ("cluster", "global", and "smem" for
    the one-block layouts) in both wrappers since `wrappers` were reset."""
    got = collections.Counter()
    for name in ("ln_mixer_head", "global_mixer"):
        for layout, n in wrappers[name].variants.items():
            got[layout if layout in ("cluster", "global") else "smem"] += n
    return dict(got)


def run_large_forwards(card: str) -> dict:
    """UnlgFormer at PAN LARGE_SIDE^2, batch 1, at each of LARGE_FORMS:
    launches a forward (the route; every other kernel 0; the mixer's by
    route, LARGE_ROUTES_A_FORWARD) and the output against the CPU plain
    path (level 2's, the function every level computes) within 5e-4,
    with the split line at level 2; then whole LARGE_TILES tiles at
    level 2: median ms of LARGE_TIMED forwards, MP/s, peak GiB and the
    mixer's launches a forward by route. Returns the mixer's launches a
    forward by path and route ({path: {route: n}})."""
    batch = large_batch(LARGE_SIDE, SEED + 33)
    cpu = large_method({}, "cpu")
    with torch.inference_mode():
        want = cpu.apply(batch)
    state = {k: v.cpu() for k, v in cpu.module.state_dict().items()}
    failures, routed = [], {}
    for (lvl, att), route in LARGE_FORMS.items():
        tag = (f"large UnlgFormer {LARGE_SIDE}^2 level {lvl}"
               f"{' v2' if att == 'v2' else ''}")
        method = large_method({"LGTEUN_FUSE_LEVEL": lvl,
                               "LGTEUN_FUSED_ATTENTION": att}, "cuda")
        method.module.load_state_dict(state)
        method.apply(batch)
        torch.cuda.synchronize()
        wrappers = reset_launches()
        got = method.apply(batch).cpu()
        counted = {k: fn.launches for k, fn in wrappers.items()
                   if fn.launches}
        layouts = {k: dict(wrappers[k].variants) for k in
                   ("ln_mixer_head", "global_mixer") if wrappers[k].launches}
        routes = routed[tag] = mixer_routes(wrappers)
        err = (got - want).abs().max().item()
        ms = time_ms(lambda: method.apply(batch), iters=LARGE_TIMED,
                     warmup=1)
        print(f"{tag}: launches a forward {counted} (want {route}), mixer "
              f"layouts {layouts}; max|card - cpu plain| {err:.3e} (bound "
              f"5e-4; max|cpu| {want.abs().max().item():.3f}); {ms:.3f} ms "
              f"a forward  [{card}]")
        if (lvl, att) == ("2", "1"):
            names = tuple(route)
            with swapped_kernels(names, lambda name, fn: kernel_fns(name)[1]):
                card_plain = method.apply(batch).cpu()
            print(f"{tag} split: max|card kernels - card plain| "
                  f"{(got - card_plain).abs().max().item():.3e}  max|card "
                  f"plain - cpu plain| "
                  f"{(card_plain - want).abs().max().item():.3e}")
            large_profile(tag, lambda: method.apply(batch), card)
        if counted != route or routes != LARGE_ROUTES_A_FORWARD[
                LARGE_SIDE] or not err <= 5e-4 or not bool(
                torch.isfinite(got).all()):
            failures.append(f"{tag}: launches {counted}, mixer routes "
                            f"{routes}, err {err:.3e}")
        del method
    # whole tiles
    method = large_method({}, "cuda")
    method.module.load_state_dict(state)
    for side in LARGE_TILES:
        tile = large_batch(side, SEED + 34)
        out = method.apply(tile)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_launches()
        times = []
        for _ in range(LARGE_TIMED):
            t0 = time.perf_counter()
            out = method.apply(tile)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(times)
        tag = f"large UnlgFormer whole tile {side}"
        routes = routed[tag] = {k: n // LARGE_TIMED for k, n in
                                mixer_routes(wrappers).items()}
        ok = tuple(out.shape) == (1, side, side, 8) and bool(
            torch.isfinite(out).all())
        print(f"large UnlgFormer whole tile {side}x{side}x8 (level 2, batch "
              f"1): {med * 1e3:.2f} ms median of {LARGE_TIMED} = "
              f"{side * side / med / 1e6:.2f} MP/s, peak {peak:.2f} GiB, "
              f"finite {ok}; mixer launches a forward by route {routes} "
              f"(want {LARGE_ROUTES_A_FORWARD[side]})  [{card}]")
        large_profile(tag, lambda: method.apply(tile), card)
        if not ok or routes != LARGE_ROUTES_A_FORWARD[side]:
            failures.append(f"whole tile {side}: routes {routes}")
        del out
    del method
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"large forwards: {failures}")
    return routed


def run_large_grad(card: str) -> None:
    """B1's training entry on the cluster route at LARGE_GRAD: forward and
    the gradients of a loss linear in its outputs against plain autograd
    on the card (KERNEL_REL_TOL, GRAD_REL_TOL)."""
    from lgteun_tpu_torch.ops.spectral_kernel import (ln_mixer_head,
                                                      ln_mixer_head_ref)
    gen = torch.Generator().manual_seed(SEED + 35)
    b, c, h, w = LARGE_GRAD
    c2 = c // 2
    n = lambda *s: torch.randn(*s, generator=gen).cuda()
    args = tuple(a.requires_grad_() for a in (
        n(b, c, h, w), 1 + 0.1 * n(c), 0.1 * n(c), n(c2), 0.1 * n(c2),
        n(c2), 0.1 * n(c2)))
    weights = [torch.randn(b, c2, h, w, generator=gen).cuda()
               for _ in range(2)]
    results = []
    for fn in (ln_mixer_head, ln_mixer_head_ref):
        outs = fn(*args)
        loss = sum((o * wt).sum() for o, wt in zip(outs, weights))
        results.append(([o.detach() for o in outs],
                        torch.autograd.grad(loss, args)))
    (k_out, k_grads), (p_out, p_grads) = results
    fwd = rel_err(k_out, p_out)[0]
    grad = max(rel_err([g], [p])[0] for g, p in zip(k_grads, p_grads))
    print(f"large autograd ln_mixer_head {'x'.join(map(str, LARGE_GRAD))} "
          f"(cluster route): forward rel err {fwd:.3e}  grads of {len(args)} "
          f"tensors rel err {grad:.3e} (bounds {KERNEL_REL_TOL:g}, "
          f"{GRAD_REL_TOL:g})  [{card}]")
    if not (fwd <= KERNEL_REL_TOL and grad <= GRAD_REL_TOL):
        raise AssertionError(f"large autograd: forward {fwd:.3e}, grads "
                             f"{grad:.3e}")


def run_large_scene(card: str) -> None:
    """`fuse_scene` on the seeded 1024^2 WV-3 scene at LARGE_TILING
    (256^2 tiles, batch SCENE_BATCH: four of a forward's five B1 calls
    on the mixer's cluster route, the bottleneck's on one block): MP/s
    (median of 3) and the mixer's launches a forward by route, a crop
    against the CPU plain path within 5e-4 (its tiles in one forward);
    then `python -m lgteun_tpu_torch.fuse --tile 0` on the scene's TIFFs
    against `method.apply` on the whole scene within 1 DN. Returns the
    mixer's launches a forward by route."""
    from lgteun_tpu_torch import fuse
    from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
    from lgteun_tpu_torch.parallel.scene import fuse_scene
    from lgteun_tpu_torch.runner import Runner

    tile, halo, crop = LARGE_TILING
    cfg, method = unlgformer("cuda")
    Runner(cfg, method, "cuda").init(SEED)
    _, cpu = unlgformer("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    lr, pan = synthetic_scene(SCENE, cfg.ms_chans, SEED)
    lr_n, pan_n = lr / DN_RANGE, pan / DN_RANGE
    lr_d, pan_d = torch.from_numpy(lr_n).cuda(), torch.from_numpy(pan_n).cuda()
    run = lambda: fuse_scene(method, lr_d, pan_d, tile=tile, halo=halo,
                             batch=SCENE_BATCH)
    out = run()
    torch.cuda.synchronize()
    wrappers = reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counted = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    forwards = counted.get("ln_mixer_head", 0) // 5
    routes = {k: n // max(forwards, 1) for k, n in
              mixer_routes(wrappers).items()}
    med = statistics.median(times)
    ok = (tuple(out.shape) == (SCENE, SCENE, 8) and bool(
        torch.isfinite(out).all()) and forwards > 0
        and routes == {"cluster": 4, "smem": 1}
        and sum(mixer_routes(wrappers).values()) == 5 * forwards)
    print(f"large scene {SCENE}x{SCENE}x8 tile {tile} halo {halo} batch "
          f"{SCENE_BATCH}: {med * 1e3:.2f} ms median of 3 = "
          f"{SCENE * SCENE / med / 1e6:.2f} MP/s, launches in 3 scenes "
          f"{counted} ({forwards} forwards), mixer layouts "
          f"{dict(wrappers['ln_mixer_head'].variants)}, a forward by route "
          f"{routes} (want cluster 4, smem 1)  [{card}]")
    lc, pc = lr_n[:crop // 4, :crop // 4], pan_n[:crop, :crop]
    n_crop = (-(-(crop - tile) // (tile - 2 * halo)) + 1) ** 2
    got = fuse_scene(method, lc, pc, tile=tile, halo=halo,
                     batch=n_crop).cpu()
    want = fuse_scene(cpu, lc, pc, tile=tile, halo=halo, batch=n_crop)
    err = (got - want).abs().max().item()
    print(f"large scene tile {tile}: {crop}x{crop} crop ({n_crop} tiles in "
          f"one forward) max|card - cpu plain| {err:.3e} (bound 5e-4)")
    # the CLI on the whole scene in one forward
    out_dir = os.path.join(REPO, "build", "chip_smoke", "large")
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"{k}.tif") for k in ("lr", "pan",
                                                            "fused")}
    write_tiff(paths["lr"], np.round(lr).astype(np.uint16))
    write_tiff(paths["pan"], np.round(pan).astype(np.uint16))
    fuse.cli(["--lr", paths["lr"], "--pan", paths["pan"], "-o",
              paths["fused"], "--tile", "0", "--device", "cuda"])
    cli_out = read_tiff(paths["fused"]).astype(np.float64)
    whole = method.apply({"input_lr": (np.round(lr) / DN_RANGE)[None],
                          "input_pan": (np.round(pan) / DN_RANGE)[None, ...,
                                                                  None]})
    whole = np.clip(np.round(whole[0].cpu().numpy() * DN_RANGE), 0, 2047)
    dn = float(np.abs(cli_out - whole).max())
    print(f"large cli --tile 0: {paths['fused']} {cli_out.shape} max|cli - "
          f"method.apply on the whole scene| {dn:g} DN (bound 1)  [{card}]")
    if not (ok and err <= 5e-4 and cli_out.shape == (SCENE, SCENE, 8)
            and dn <= 1.0):
        raise AssertionError(f"large scene: crop {err:.3e}, cli {dn} DN, "
                             f"routes {routes}")
    return routes


def strip_scene(h: int, w: int, bands: int, seed: int):
    """`synthetic_scene`'s recipe on an h x w strip (h, w multiples of
    4): LrMS [h/4, w/4, bands] and PAN [h, w] in 11-bit DN, float32."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(200, 1800, (-(-h // 32), -(-w // 32), bands))
    target = np.repeat(np.repeat(coarse, 32, 0), 32, 1)[:h, :w] + rng.normal(
        0, 40, (h, w, bands))
    target = np.clip(target, 0, 2047).astype(np.float32)
    lr = target.reshape(h // 4, 4, w // 4, 4, bands).mean(axis=(1, 3))
    return lr.astype(np.float32), target.mean(axis=-1).astype(np.float32)


def run_large_strip(card: str) -> dict:
    """UnlgFormer (the shipped WV-3 config, seeded as `fuse` seeds it) on
    the LARGE_STRIP strip, whose full-resolution planes have a prime
    factor 521 (ROADMAP A.12.2): `python -m lgteun_tpu_torch.fuse --tile
    0` on its TIFFs against `method.apply` on the same inputs within 1
    DN, with the mixer's launches by route; then a direct forward at
    levels 2, 3 and 1: level 2 within 5e-4 of the CPU plain path, level 3
    bit-equal to level 2, level 1 within 5e-4 of both; each with its
    launches a forward, the mixer's by route (LARGE_STRIP_ROUTES), and
    its ms. Returns the mixer's launches a forward by route at level 2."""
    from lgteun_tpu_torch import fuse
    from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
    from lgteun_tpu_torch.runner import Runner
    h, w = LARGE_STRIP
    cfg, method = unlgformer("cuda")
    Runner(cfg, method, "cuda").init(SEED)
    state = {k: v.cpu() for k, v in method.module.state_dict().items()}
    lr, pan = strip_scene(h, w, cfg.ms_chans, SEED + 37)
    lr, pan = np.round(lr), np.round(pan)
    batch = {"input_lr": (lr / DN_RANGE)[None],
             "input_pan": (pan / DN_RANGE)[None, ..., None]}
    failures = []
    # the CLI on the strip's TIFFs, in one forward
    out_dir = os.path.join(REPO, "build", "chip_smoke", "strip")
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"{k}.tif") for k in ("lr", "pan",
                                                            "fused")}
    write_tiff(paths["lr"], lr.astype(np.uint16))
    write_tiff(paths["pan"], pan.astype(np.uint16))
    wrappers = reset_launches()
    t0 = time.perf_counter()
    fuse.cli(["--lr", paths["lr"], "--pan", paths["pan"], "-o",
              paths["fused"], "--tile", "0", "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    cli_routes = mixer_routes(wrappers)
    cli_out = read_tiff(paths["fused"]).astype(np.float64)
    whole = np.clip(np.round(method.apply(batch)[0].cpu().numpy()
                             * DN_RANGE), 0, 2047)
    dn = float(np.abs(cli_out - whole).max())
    print(f"large strip cli --tile 0: PAN {h}x{w}, LrMS {h // 4}x{w // 4}: "
          f"{paths['fused']} {cli_out.shape} in {cli_s:.2f} s (with the "
          f"build of the method); max|cli - method.apply| {dn:g} DN (bound "
          f"1); mixer launches by route {cli_routes} (want "
          f"{LARGE_STRIP_ROUTES})  [{card}]")
    if not (cli_out.shape == (h, w, cfg.ms_chans) and dn <= 1.0
            and cli_routes == LARGE_STRIP_ROUTES):
        failures.append(f"cli: {cli_out.shape}, {dn} DN, {cli_routes}")
    del method
    cpu = large_method({}, "cpu")
    cpu.module.load_state_dict(state)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu.apply(batch)
    cpu_s = time.perf_counter() - t0
    del cpu
    outs, routed = {}, {}
    for lvl in ("2", "3", "1"):
        method = large_method({"LGTEUN_FUSE_LEVEL": lvl,
                               "LGTEUN_FUSED_ATTENTION": "1"}, "cuda")
        method.module.load_state_dict(state)
        method.apply(batch)
        torch.cuda.synchronize()
        wrappers = reset_launches()
        got = outs[lvl] = method.apply(batch).cpu()
        counted = {k: fn.launches for k, fn in wrappers.items()
                   if fn.launches}
        routes = routed[lvl] = mixer_routes(wrappers)
        ms = time_ms(lambda: method.apply(batch), iters=LARGE_TIMED,
                     warmup=1)
        err = (got - want).abs().max().item()
        vs2 = (got - outs["2"]).abs().max().item()
        print(f"large strip UnlgFormer PAN {h}x{w} level {lvl}: launches a "
              f"forward {counted}, mixer by route {routes}; max|card - cpu "
              f"plain| {err:.3e} (bound 5e-4; max|cpu| "
              f"{want.abs().max().item():.3f}; the CPU forward "
              f"{cpu_s:.1f} s); max|level {lvl} - level 2| {vs2:.3e}, "
              f"bit-equal {torch.equal(got, outs['2'])}; {ms:.3f} ms a "
              f"forward = {h * w / ms / 1e3:.2f} MP/s  [{card}]")
        ok = (tuple(got.shape) == (1, h, w, cfg.ms_chans)
              and bool(torch.isfinite(got).all()) and err <= 5e-4
              and routes == LARGE_STRIP_ROUTES
              and (torch.equal(got, outs["2"]) if lvl == "3"
                   else vs2 <= 5e-4))
        if not ok:
            failures.append(f"level {lvl}: err {err:.3e}, vs level 2 "
                            f"{vs2:.3e}, routes {routes}")
        del method
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"large strip: {failures}")
    return routed["2"]


def large_space_jobs() -> list:
    """The large phase's height-sharded cases, run by the mesh phase's
    spawn: UnlgFormer (seeded) at PAN LARGE_SIDE^2 on {"space": 2}, level
    2 float32 and level 1 bf16res (B1 / B4 on the gathered whole plane:
    the cluster route)."""
    from lgteun_tpu_torch.parallel import ranks
    batch = large_batch(LARGE_SIDE, SEED + 36)
    cases = []
    for lvl, mode in (("2", ""), ("1", "bf16res")):
        cfg = mode_cfg("unlg_former.py")
        cfg.seed = SEED
        cases.append(dict(
            name=f"UnlgFormer {LARGE_SIDE} L{lvl} {mode or 'float32'}",
            method=cfg.model_type, cfg=cfg, weights=None, batch=batch,
            batch_axis=None,
            env={"LGTEUN_FUSE_LEVEL": lvl, "LGTEUN_FUSED_ATTENTION": "1",
                 "LGTEUN_EVAL_DTYPE": mode},
            route=LARGE_FORMS[lvl, "1"]))
    return [(ranks.spatial_job, dict(mesh_shape={"space": 2}, cases=cases,
                                     timed=SPACE_TIMED))]


def run_large(card: str, space_jobs_: list, space_results: list) -> tuple:
    """The `large` phase (module docstring): (the mixer's launches a
    forward by path and route; the kernel cases' rows by kernel, as
    main's `record` holds them)."""
    record = {}
    run_large_kernels(torch.Generator().manual_seed(SEED + 30), record,
                      card)
    check_fft_tables(LARGE_TABLES)
    routed = run_large_forwards(card)
    run_large_grad(card)
    routed[f"large scene tile {LARGE_TILING[0]}"] = run_large_scene(card)
    routed[f"large strip {LARGE_STRIP[0]}x{LARGE_STRIP[1]} level 2"] = \
        run_large_strip(card)
    run_space(space_jobs_, space_results, card)
    return routed, record


if __name__ == "__main__":
    sys.exit(main())
