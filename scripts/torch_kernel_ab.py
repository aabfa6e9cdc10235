"""A/B of two versions of the port's kernels on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py A B [--batch 4] [--sizes 128,64,144,72]
                                       [--tol REL] [--only TEXT]
                                       [--innt] [--lightnet] [--mdcun]
    python3 scripts/torch_kernel_ab.py --mma-rate
    python3 scripts/torch_kernel_ab.py --phases [--batch 4]
    python3 scripts/torch_kernel_ab.py --b8-phases [CSRC]
    python3 scripts/torch_kernel_ab.py --search-phases [CSRC] [--batch 4]
    python3 scripts/torch_kernel_ab.py --cluster-sizes
    python3 scripts/torch_kernel_ab.py --global-parts [CSRC]

A and B are two versions either of `lgteun_tpu_torch/csrc/
texture_match.cu` (the INNT searches `lgteun_texture_match` and
`lgteun_patch_match`, at INNT's shapes: N = 256 patch-images an image,
C = 4, side 24, a quarter of the images with PatchFusion's zero rims;
and 64 patch-images at C = 8, which the FP32-core body takes),
or of the whole `lgteun_tpu_torch/csrc` directory (then also the LGB
kernels at the UnlgFormer block shapes and the scene engine's 144^2 /
72^2: every case whose C entry both versions have; `--sizes` picks the
planes, e.g. 128,64 for a version whose mixer takes only powers of
two, or 256,264,512 (C 32) for the mixer's routes above one block:
`--only mixer` runs its two entries there, each library given the
global route's scratch, which a version that runs those planes on a
thread-block cluster ignores). Each is built with
the port's nvcc flags into a shared library of its own; both run on the
same inputs, each tail's matrices in the layout its library declares
(`lgteun_block_tail_layout` 3: TF32 slabs in wgmma's core-matrix order,
as the block tail and the whole block take them; without it, the
[in][out] rows of earlier versions), and the window attention's qkv
weights likewise (`lgteun_window_attention_layout` 2: the tensor-core
body's TF32 fragments, `window_attention.attention_fragments`, as the
window attention and the whole block take them; without it, the [3C][C]
rows). The LGB cases are the mixer head, the global mixer,
the window attention, the block tail with and without a seeded dropout
mask and LN + FFN at every size, and the whole block (whose scratch is
not compared) at 128^2 and 64^2. Then LightNet's stack (all its
launches: [4,9,128,128], 4 bands [4,5,128,128], ragged [1,9,72,100]),
its weights in the layout each library declares
(`lgteun_lightnet_layout` 2: `lightnet_fragments`, five launches of two
layers; without it: the packed FP32 rows and launches of 4, 3 and 3
layers), and the neighbourhood attention at MDCUN's shapes
([4,8,128,128], [1,8,72,100], [4,4,128,128]), at C = 16 and 32 (fs 13)
and on its FP32-core branch ([1,16,40,40], fs 25) (`--only lightnet`,
`--only neighborhood`). The searches and the neighbourhood attention also
run their bf16 entries on the same values rounded to bf16 (cases `bf16
...`, `--only bf16`; the zoo's blanket cast in eval and training), held
bit-equal like the LGB cases.
The script checks that B's outputs equal A's bit for bit or, with `--tol
REL`, that max|B - A| / max|A| <= REL (and prints that figure); for the
two searches, whose picks may flip at float64 near ties (`chip_smoke.
near_ties`, a gap of 1e-5), that the transferred values are bit-equal
outside the near ties' footprint and s within KERNEL_REL_TOL relative
(or REL), printing the near ties and the masked share. It times
both in turns A, B, B, A with CUDA events (mean of 20 calls after 3
warm-up calls each), and prints one line per case with the card's name
and power limit. It exits non-zero without a CUDA device or when the
outputs differ (after printing every case).

`--mma-rate` instead measures the card's rate of the TF32 tensor-core
instructions with FP32 accumulation, as TFLOP/s and as instructions a
clock an SM (at the card's maximum SM clock): mma.sync m16n8k8, a loop
of independent products (1, 4 or 8 accumulators a warp) at 1 to 16 warps
an SM; and wgmma m64nNk8 (N = 16 and 32, the block tail's halo products)
with A from registers and B from shared memory, in groups of 12 issued
back to back and waited for, as the tail issues them, at 1 to 4
warpgroups an SM.

`--phases` instead shows where the block tail's and the FFT mixer's time
goes: it copies `lgteun_tpu_torch/csrc`, adds clock64() stamps to the
tail's tile (`block_tail.cuh::block_tail_tile_tc`) at its phase
boundaries (halo loads, proj, LN, W1, and per hidden chunk W2, depthwise
+ GELU, W3; then the output) and around the two waits of each weight
slab (the cp.async wait and the barrier after it), and to the mixer's
plane (`fft_mixer.cuh::fft_mixer_plane`) at the barrier that ends each
of its phases (MIXER_PHASES), builds that copy and runs
`lgteun_block_tail` at the UnlgFormer block shapes (C 32 at 128^2, C 64
at 64^2) and `lgteun_ln_mixer_head` at those and the scene engine's
(144^2, 72^2). Thread 0 of each block adds up the clocks of each phase;
the line gives the mean over the blocks of one launch, in clocks a tile
or a plane and as shares of it. The stamps cost time themselves, so read
the shares; where blocks share an SM, a phase's clocks include the other
blocks' issue.

`--b8-phases` shows where the whole block's time goes (B8,
`csrc/lgb_block.cu`, of CSRC, default the port's): it builds a copy whose
kernel adds up, in thread 0 of each block, the clocks of each kind of
work (LN, mixer planes, window items, tail items, the waits on the grid
barrier or the dependency counters, taking an item; B8_PHASES) and
counts them, through the stamps the kernel declares under
LGTEUN_LGB_STAMPS or, in the earlier grid-barrier kernel, at the anchors of
B8_GRID_STAMPS. It runs `lgb_block` at 128^2/C32, 64^2/C64 and
[B,128,64,64], batch 4 and 16, and prints each kind's clocks a block,
its share and its share of the device time of an unstamped launch,
beside the device times of B1, B2 and B3 (the level-2 chain) on the same
inputs. `--only TEXT` runs the A/B cases whose label contains TEXT (or
one of comma-separated TEXTs).
`--innt` instead times INNT's eval forward (batch 16 and 1, with and
without LGTEUN_FUSED_TM=0) with A's and B's searches in turns;
`--lightnet` and `--mdcun` LightNet's and MDCUN's (each library's
LightNet weights in its own layout).

`--cluster-sizes` times the FFT mixer's cluster route (the port's
csrc) forced at each cluster size of 2, 4, 8, 16 that holds the plane,
the global route forced on the same planes and the route the launch
picks by shape, by the profiler's device time, at 256^2, 264^2, 384^2,
512^2 and 1024x512 and 1 to 512 planes (CLUSTER_SHAPES); every forced
output must equal the route by shape bit for bit.

`--global-parts` times the FFT mixer's global route (of CSRC, default
the port's csrc) forced on B1 at [1,32,1024^2] and B4 at [1,16,1024^2],
[1,4,2048^2] and [1,4,1024x2048] (GLOBAL_SHAPES) kernel by kernel: the
LN split and each launch of the route, by the profiler's device time,
beside cuFFT's rfft2 + irfft2 on the mixed planes.

`--search-phases` shows where the INNT searches' time goes on their
tensor-core branch (`csrc/texture_match_tc.cuh`, of CSRC, default the
port's): a copy built with LGTEUN_SEARCH_STAMPS, whose kernels add up
in thread 0 of each block the clocks of each phase (SEARCH_PHASES) and
record the block's span on the global timer and its SM. It runs
`lgteun_texture_match` and `lgteun_patch_match` at INNT's shapes and
prints each phase's clocks a block, its share and that share of an
unstamped launch's device time, the clocks a chunk of the products and
of the fold, and the blocks' clock rate, blocks an SM and the gaps
between them.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(src: str, out_dir: str, tag: str) -> ctypes.CDLL:
    """A source file, or a csrc directory (built as the port builds
    it), into a library with the C signatures it has declared."""
    from lgteun_tpu_torch.ops import _cuda
    if os.path.isdir(src):
        csrc, _cuda.CSRC = _cuda.CSRC, Path(src)
        try:
            lib = str(_cuda.build_library(Path(out_dir) / tag))
        finally:
            _cuda.CSRC = csrc
    else:
        lib = os.path.join(out_dir, f"lib_{tag}.so")
        subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                        "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    old = ({} if hasattr(dll, "lgteun_fft_mixer_layout")
           else MIXER_WITHOUT_TABLES)
    if not hasattr(dll, "lgteun_lgb_block_layout"):
        old = {**LGB_WITHOUT_SCHEDULE, **old}
    for name, argtypes in {**_cuda.SIGNATURES, **old}.items():
        if hasattr(dll, name):
            getattr(dll, name).argtypes = argtypes
            getattr(dll, name).restype = ctypes.c_int
    return dll


# the mixer entries of a library without lgteun_fft_mixer_layout (no
# tables argument)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MIXER_WITHOUT_TABLES = {
    "lgteun_ln_mixer_head": [_P] * 9 + [_I] * 4 + [_F, _P],
    "lgteun_global_mixer": [_P] * 6 + [_I] * 4 + [_P],
    "lgteun_lgb_block": [_P] * 25 + [_I] * 7 + [_F, _F, _P]}
# the whole block of a library without lgteun_lgb_block_layout (one
# counter it zeroes itself; no work-list numbers, no block count)
LGB_WITHOUT_SCHEDULE = {
    "lgteun_lgb_block": [_P] * 26 + [_I] * 7 + [_F, _F, _P]}


def caller(dll: ctypes.CDLL, name: str, *args):
    """A no-argument function that launches C entry `name` of `dll` on
    the current stream and raises on its error. It holds `args`, so the
    tensors whose pointers it passes (a host table too) live as long as
    it does."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = getattr(dll, name)

    def call():
        err = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} of {dll._name}: CUDA error {err}")
    call.args = args
    return call


def lgb_cases(batch: int, sizes, gen: torch.Generator) -> dict:
    """label -> (C entry, inputs(layouts), output allocator, trailing
    arguments) of the LGB kernels at the UnlgFormer block shapes (C 32 at
    128^2, C 64 at 64^2) and the scene engine's (C 32 at 144^2, C 64 at
    72^2). `layouts` is a library's (tail, attention, tables) layouts (see
    `layouts`): tail 1 gives the tails' matrices as [in][out] rows, 3 as
    TF32 wgmma slabs; attention 1 gives wqkv as [3C][C] rows, 2 as the
    tensor-core body's fragments; tables, where not None, makes the FFT
    mixer's tables of an (H, W), which the mixer entries then take after
    pha_b; lgb 2 passes the whole block the work list's numbers, zeroed
    counters and a block count (0), 1 one counter. `dims` is a tuple, or
    a function of the layouts for the whole block."""
    from lgteun_tpu_torch.ops.ffn_kernel import _fragments
    from lgteun_tpu_torch.ops.lgb_block_kernel import (_schedule_ints,
                                                       lgb_schedule)
    from lgteun_tpu_torch.ops.window_attention import _wqkv_fragments

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def mixer(lay, hw, planes):
        return () if lay[2] is None else (lay[2](hw, hw),) + \
            lay[2].scratch(hw, planes)

    cases = {}
    # C 32 on the UnlgFormer block's planes (128^2, and 256^2 / 512^2 at
    # PAN 256^2 / 512^2: the mixer's cluster route; 264^2 its odd radices;
    # 1024^2 a whole tile's, the global route) and the scene engine's
    # 144^2, C 64 at 64^2 and 72^2, C 8 at 2048^2 (the global route)
    channels = {128: 32, 64: 64, 144: 32, 72: 64, 256: 32, 264: 32, 512: 32,
                1024: 32, 2048: 8}
    for hw in sizes:
        c = channels[hw]
        b, c2, c4 = batch, c // 2, 4 * c
        tag = f"{b}x{c}x{hw}x{hw}"
        x = n(b, c, hw, hw)
        half = lambda s=(b, c2, hw, hw): torch.empty(s, device="cuda")
        full = lambda s=(b, c, hw, hw): (torch.empty(s, device="cuda"),)
        mix = (n(c2), 0.1 * n(c2), n(c2), 0.1 * n(c2))
        head = (1 + 0.1 * n(c), 0.1 * n(c)) + mix
        cases[f"ln_mixer_head {tag}"] = (
            "lgteun_ln_mixer_head",
            lambda lay, x=x, head=head, hw=hw, p=b * c2: (x,) + head
            + mixer(lay, hw, p),
            lambda half=half: (half(), half()), (b, c, hw, hw, 1e-5))
        cases[f"global_mixer {b}x{c2}x{hw}x{hw}"] = (
            "lgteun_global_mixer",
            lambda lay, x=n(b, c2, hw, hw), mix=mix, hw=hw, p=b * c2: (x,)
            + mix + mixer(lay, hw, p),
            lambda half=half: (half(),), (b, c2, hw, hw))
        if hw >= 1024:   # the mixer's global route alone
            continue
        # the whole block at the block shapes (B8 takes planes up to
        # 240^2), the window attention and the tails at the others too
        block = hw in (128, 64)
        wqkv = n(3 * c2, c2, scale=c2 ** -0.5)
        rest = (0.1 * n(3 * c2), n(2, 64, 64))
        attn = {1: (wqkv,) + rest, 2: (_wqkv_fragments(wqkv, 2),) + rest}
        y1 = n(b, c2, hw, hw)
        cases[f"window_attention {b}x{c2}x{hw}x{hw}"] = (
            "lgteun_window_attention",
            lambda lay, y1=y1, attn=attn: (y1,) + attn[lay[1]],
            lambda half=half: (half(),),
            (b, c2, hw, hw, 2, 8, (c2 // 2) ** -0.5))
        # torch conv layout [out, in]
        w = {"p": n(c, c, scale=c ** -0.5), "1": n(c4, c, scale=c ** -0.5),
             "2": n(c4, c4, scale=c4 ** -0.5),
             "3": n(c, c4, scale=c4 ** -0.5)}
        rows = {k: v.t().contiguous() for k, v in w.items()}
        slabs = {k: _fragments(v, c) for k, v in w.items()}
        vec = (1 + 0.1 * n(c), 0.1 * n(c), 0.1 * n(c4), 0.1 * n(c4),
               n(c4, 3, 3, scale=1 / 3), 0.1 * n(c4), 0.1 * n(c))
        mats = {1: rows, 3: slabs}
        ffn = {lay: (vec[0], vec[1], m["1"], vec[2], m["2"], vec[3], vec[4],
                     vec[5], m["3"], vec[6]) for lay, m in mats.items()}
        x1, x2, bp = n(b, c2, hw, hw), n(b, c2, hw, hw), 0.1 * n(c)
        mask = (torch.rand(b, c, hw, hw, generator=gen) >= 0.1).float() \
            .cuda() / 0.9
        for label, m in (("block_tail", None), ("block_tail_masked", mask)):
            cases[f"{label} {tag}"] = (
                "lgteun_block_tail",
                lambda lay, m=m, mats=mats, ffn=ffn, x=x, x1=x1, x2=x2, bp=bp:
                (x, x1, x2, m, mats[lay[0]]["p"], bp) + ffn[lay[0]],
                full, (b, c, c4, hw, hw, 1e-5))
        cases[f"ln_ffn {tag}"] = (
            "lgteun_ln_ffn", lambda lay, x=x, ffn=ffn: (x,) + ffn[lay[0]],
            full, (b, c, c4, hw, hw, 1e-5))
        if block:
            cases[f"lgb_block {tag}"] = (
                "lgteun_lgb_block",
                lambda lay, x=x, head=head, attn=attn, mats=mats, bp=bp,
                ffn=ffn, hw=hw: (x,) + head + mixer(lay, hw, 0) + attn[lay[1]]
                + (mats[lay[0]]["p"], bp) + ffn[lay[0]],
                # the scratch's size bound now, not at the call (after the
                # loop, b, c2 and hw would be the last size's)
                lambda s=(b, c, hw, hw), size=3 * b * c2 * hw * hw: (
                    torch.empty(size, device="cuda"),
                    torch.zeros((1 + 3 * s[0]) * 32, device="cuda",
                                dtype=torch.int32),
                    torch.empty(s, device="cuda")),
                lambda lay, d=(b, c, c4, hw, hw, 2, 8), sched=torch.tensor(
                    _schedule_ints(lgb_schedule(b, c, hw, hw)),
                    dtype=torch.int32), scale=(c2 // 2) ** -0.5: d + (
                    (sched, 0) if lay[3] == 2 else ()) + (scale, 1e-5))
    return cases


def lightnet_packed_fp32(layers, table):
    """(weights, groups) in the layout of a library without
    `lgteun_lightnet_layout` (the FP32-core body): per layer at
    `offset` floats pw [cin][2][coutp], pb [2][coutp], dw [2][coutp][9],
    db [2][coutp] (coutp = cout rounded up to 8), launches of 4, 3 and 3
    layers; groups as `lightnet_kernel._groups` gives them."""
    parts, rows, off = [], [], 0
    for layer, (_n, cin, cout, relu) in zip(layers, table, strict=True):
        pw1, pb1, dw1, db1, pw2, pb2, dw2, db2 = layer
        dev, coutp = pw1.device, -(-cout // 8) * 8
        pw = torch.zeros(cin, 2, coutp, device=dev)
        pb = torch.zeros(2, coutp, device=dev)
        dw = torch.zeros(2, coutp, 9, device=dev)
        db = torch.zeros(2, coutp, device=dev)
        for br, (w, bias, k, kb) in enumerate(((pw1, pb1, dw1, db1),
                                               (pw2, pb2, dw2, db2))):
            pw[:, br, :cout] = w.reshape(cout, cin).t()
            pb[br, :cout] = bias
            dw[br, :cout] = k.reshape(cout, 9)
            db[br, :cout] = kb
        parts += [pw.flatten(), pb.flatten(), dw.flatten(), db.flatten()]
        rows.append((cin, cout, coutp, int(relu), off))
        off += 2 * coutp * (cin + 11)
    rows = torch.tensor(rows, dtype=torch.int32)
    groups = [(rows[a:b], b - a, table[b - 1][2])
              for a, b in ((0, 4), (4, 7), (7, 10))]
    return torch.cat(parts), groups


def lightnet_weights(layers, table, lay: int):
    """(weights, groups) of the stack in a library's layout `lay`."""
    from lgteun_tpu_torch.ops import lightnet_kernel
    if lay == 1:
        return lightnet_packed_fp32(layers, table)
    weights, rows = lightnet_kernel.lightnet_fragments(layers, table)
    return weights, lightnet_kernel._groups(rows, table)


def stack_cases(gen: torch.Generator) -> dict:
    """label -> (C entry, inputs(layouts), output allocator, trailing
    arguments, launcher) of LightNet's stack (8 bands [4,9,128,128], 4
    bands [4,5,128,128], ragged [1,9,72,100]; `launcher(dll, lay, out)`
    gives the calls of the launches of the library's layout and grouping,
    in order) and of the
    neighbourhood attention at MDCUN's shapes ([4,8,128,128],
    [1,8,72,100], 4 bands [4,4,128,128]) and at C = 16 and 32 (fs 13)."""
    from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_layers

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    cases = {}
    for b, bands, h, w in ((4, 8, 128, 128), (4, 4, 128, 128),
                           (1, 8, 72, 100)):
        table = lightnet_layers(bands)
        layers = [tuple(t for _br in range(2) for t in (
            n(cout, cin, 1, 1, scale=(2 / cout) ** 0.5), 0.1 * n(cout),
            n(cout, 1, 3, 3, scale=(2 / 9 / cout) ** 0.5), 0.1 * n(cout)))
            for _n, cin, cout, _r in table]
        lms = n(b, bands, h, w)
        x = torch.cat([n(b, 1, h, w), lms], dim=1)

        def launcher(dll, lay, out, x=x, lms=lms, layers=layers,
                     table=table, b=b, h=h, w=w):
            weights, groups = lightnet_weights(layers, table, lay[4])
            acts = [torch.empty(b, cout, h, w, device="cuda")
                    for _rows, _n, cout in groups[:-1]] + [out[0]]
            calls = [caller(dll, "lgteun_lightnet_group", act, act.shape[1],
                            lms if k == len(groups) - 1 else None, weights,
                            dst, rows, nl, b, h, w)
                     for k, ((rows, nl, _c), act, dst) in enumerate(zip(
                         groups, [x] + acts[:-1], acts))]
            return calls
        cases[f"lightnet_stack {b}x{bands + 1}x{h}x{w}"] = (
            "lgteun_lightnet_group", None,
            lambda b=b, bands=bands, h=h, w=w: (
                torch.empty(b, bands, h, w, device="cuda"),), None, launcher)
    # (C = 32 at fs 13: the FP32-core body of earlier versions takes no
    # larger window there)
    # (and C = 16 at fs 25: the FP32-core branch of the redesigned body)
    for shape, fs in (((4, 8, 128, 128), 15), ((1, 8, 72, 100), 15),
                      ((4, 4, 128, 128), 15), ((2, 16, 40, 56), 15),
                      ((2, 32, 24, 40), 13), ((1, 16, 40, 40), 25)):
        c = shape[1]
        args = (n(*shape),) + tuple(n(c, c, scale=c ** -0.5)
                                    for _ in range(4))
        label = "x".join(map(str, shape)) + ("" if fs == 15 else f"-fs{fs}")
        cases[f"neighborhood_attention {label}"] = (
            "lgteun_neighborhood_attention", lambda lay, args=args: args,
            lambda shape=shape: (torch.empty(shape, device="cuda"),),
            shape + (fs,), None)
        # the bf16 entry (x and out bf16, the weights float32)
        bf = (args[0].to(torch.bfloat16),) + args[1:]
        cases[f"bf16 neighborhood_attention {label}"] = (
            "lgteun_neighborhood_attention_bf16", lambda lay, a=bf: a,
            lambda shape=shape: (torch.empty(shape, device="cuda",
                                             dtype=torch.bfloat16),),
            shape + (fs,), None)
    return cases


def layouts(dll: ctypes.CDLL) -> tuple:
    """(tail, attention, tables, lgb, lightnet): the layouts of the tails'
    matrices and of the window attention's wqkv that `dll` takes, for a
    library whose mixer entries take tables (`lgteun_fft_mixer_layout` 2,
    or 3: then a scratch after them, `tables.scratch(hw, planes)`) a
    function (H, W) -> the tables, made by its `lgteun_fft_tables`, else
    None, the whole block's arguments (`lgteun_lgb_block_layout`, 1
    without it; see lgb_cases) and LightNet's weights
    (`lgteun_lightnet_layout` 2: `lightnet_fragments`; 1 without it: the
    packed FP32 rows of `lightnet_packed_fp32`)."""
    got = []
    for entry, default in (("lgteun_block_tail_layout", 1),
                           ("lgteun_window_attention_layout", 1),
                           ("lgteun_fft_mixer_layout", 1),
                           ("lgteun_lgb_block_layout", 1),
                           ("lgteun_lightnet_layout", 1)):
        fn = getattr(dll, entry, None)
        if fn is not None:
            fn.restype = ctypes.c_int
        got.append(fn() if fn is not None else default)
    if got[2] < 2:
        return got[0], got[1], None, got[3], got[4]
    from lgteun_tpu_torch.ops.spectral_kernel import (FFT_SMEM_BYTES,
                                                      fft_mixer_plan)
    made = {}

    def tables(h, w):
        if (h, w) not in made:
            floats = fft_mixer_plan(h, w)["floats"]
            made[h, w] = torch.empty(floats, device="cuda")
            caller(dll, "lgteun_fft_tables", made[h, w], floats, h, w)()
        return made[h, w]
    def scratch(hw, planes):
        """Layout 3: the global route's scratch after the tables, for
        `planes` hw^2 planes above one block's shared memory (a version
        whose route there is the cluster's ignores it), else null."""
        if got[2] < 3:
            return ()
        if planes == 0 or fft_mixer_plan(hw, hw)["smem"] <= FFT_SMEM_BYTES:
            return (None,)
        # as large as any version's: [planes][H][ld] float2
        return (torch.empty(planes * 2 * hw * fft_mixer_plan(hw, hw)["ld"],
                            device="cuda"),)
    tables.scratch = scratch
    return got[0], got[1], tables, got[3], got[4]


def rel_diff(a, b) -> float:
    """max|b - a| / max|a| over the outputs."""
    diff = max((y.double() - x.double()).abs().max().item()
               for x, y in zip(a, b))
    scale = max(x.double().abs().max().item() for x in a)
    return diff / max(scale, 1e-30)


MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tc_tf32.cuh"
template <int NA>
__global__ void mma_loop(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  float d[NA][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j) mma_tf32(d[j], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NA; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// one warpgroup a block: groups of 12 wgmma m64n(8 NJ)k8 into one
// accumulator (B: NJ n-groups x 8 k of zeros in shared memory), each
// group committed and waited for
template <int NJ>
__global__ void wgmma_loop(float* out, int iters) {
  __shared__ __align__(128) float b[NJ * 64];
  for (int i = threadIdx.x; i < NJ * 64; i += blockDim.x) b[i] = 0.f;
  fence_proxy_async();
  __syncthreads();
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint64_t desc = wgmma_desc(b, 128, 256);
  float d[NJ][4] = {};
  for (int i = 0; i < iters; ++i) {
    wgmma_fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 12; ++u) wgmma_tf32(d, a, desc);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(d);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(int na, float* out, int blocks, int threads,
                        int iters, cudaStream_t stream) {
  if (na == 1) mma_loop<1><<<blocks, threads, 0, stream>>>(out, iters);
  else if (na == 4) mma_loop<4><<<blocks, threads, 0, stream>>>(out, iters);
  else mma_loop<8><<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
extern "C" int wgmma_rate(int n, float* out, int blocks, int iters,
                          cudaStream_t stream) {
  if (n == 16) wgmma_loop<2><<<blocks, 128, 0, stream>>>(out, iters);
  else wgmma_loop<4><<<blocks, 128, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate(card: str, tmp: str) -> None:
    """Print the rates of mma.sync m16n8k8 and wgmma m64nNk8 TF32 on
    this card."""
    from chip_smoke import sh, time_ms
    from lgteun_tpu_torch.ops import _cuda
    src = os.path.join(tmp, "mma_rate.cu")
    with open(src, "w") as f:
        f.write(MMA_RATE_SRC)
    lib = os.path.join(tmp, "libmma_rate.so")
    subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I",
                    str(_cuda.CSRC), "-shared", "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.mma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.wgmma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clock = float(sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits").splitlines()[0]) * 1e6
    iters = 4096
    for na in (1, 4, 8):
        for warps in (1, 2, 4, 8, 16):
            # up to 4 blocks an SM of warps / 4 warps each
            blocks = sms * min(warps, 4)
            threads = 32 * warps // min(warps, 4)
            out = torch.empty(blocks * threads, device="cuda")
            call = caller(dll, "mma_rate", na, out, blocks, threads, iters)
            ms = time_ms(call, iters=3, warmup=1)
            mma = blocks * threads // 32 * na * iters
            print(f"mma.sync m16n8k8 tf32: {na} accumulators a warp, "
                  f"{warps} warps an SM: {mma / (ms * 1e-3 * clock * sms):.3f}"
                  f" a clock an SM, {mma * 2048 / ms / 1e9:.1f} TFLOP/s  "
                  f"[{card}, max SM clock {clock / 1e6:g} MHz]")
    for n in (16, 32):
        for groups in (1, 2, 4):
            blocks = sms * groups
            out = torch.empty(blocks * 128, device="cuda")
            call = caller(dll, "wgmma_rate", n, out, blocks, iters // 4)
            ms = time_ms(call, iters=3, warmup=1)
            ops = blocks * 12 * (iters // 4)
            print(f"wgmma m64n{n}k8 tf32 (12 a group, waited): {groups} "
                  f"warpgroups an SM: {ops / (ms * 1e-3 * clock * sms):.3f} "
                  f"a clock an SM, {ops * 2 * 64 * n * 8 / ms / 1e9:.1f} "
                  f"TFLOP/s  [{card}, max SM clock {clock / 1e6:g} MHz]")


# --phases: the stamps, read back for at most MAX_BLOCKS blocks
MAX_BLOCKS = 1024
PHASES = ("halo", "proj", "LN", "W1", "W2", "depthwise", "W3", "out")
WAITS = ("cp.async wait", "barrier")
N = len(PHASES) + len(WAITS)

# (file, anchor, replacement): each anchor occurs once in the source
STAMPS = [
    ("block_tail.cuh", "namespace {\n\nconstexpr int kTailT",
     f"namespace {{\n__device__ long long lgteun_stamps[{MAX_BLOCKS}][{N}];\n"
     "#define ST(i) { long long n_ = clock64(); ph[i] += n_ - tp; tp = n_; }\n"
     "constexpr int kTailT"),
    ("block_tail.cuh", "  int slab = 0;\n",
     f"  long long tp = clock64(), ph[{N}] = {{}};\n  int slab = 0;\n"),
    ("block_tail.cuh", "    cp_async_wait_all();\n",
     "    long long w0 = clock64();\n    cp_async_wait_all();\n"
     "    ph[8] += clock64() - w0;\n"),
    ("block_tail.cuh", "    Group::sync();\n    issue(slab + 1);",
     "    long long w1 = clock64();\n    Group::sync();\n"
     "    ph[9] += clock64() - w1;\n    issue(slab + 1);"),
    ("block_tail.cuh",
     "    if (kMask) mk[p * LDC + c] = mv;\n  }\n  Group::sync();\n",
     "    if (kMask) mk[p * LDC + c] = mv;\n  }\n  Group::sync();\n"
     "  ST(0)\n"),
    ("block_tail.cuh", "  // channel LayerNorm per pixel",
     "  ST(1)\n  // channel LayerNorm per pixel"),
    ("block_tail.cuh", "  // h1 = GELU(W1 yln + b1)",
     "  ST(2)\n  // h1 = GELU(W1 yln + b1)"),
    ("block_tail.cuh", "  float acc3[NJ3][4] = {};",
     "  ST(3)\n  float acc3[NJ3][4] = {};"),
    ("block_tail.cuh", "    Group::sync();\n    // depthwise 3x3",
     "    ST(4)\n    Group::sync();\n    // depthwise 3x3"),
    ("block_tail.cuh", "    // acc3 += W3[:, chunk] g",
     "    ST(5)\n    // acc3 += W3[:, chunk] g"),
    ("block_tail.cuh", "                          n3);\n  }\n",
     "                          n3);\n    ST(6)\n  }\n"),
    ("block_tail.cuh",
     "        (x0 + 1 + pi % kTailT)] = xmi[pi * LDC + c] + "
     "__ldg(wt.b3 + c);\n  }\n",
     "        (x0 + 1 + pi % kTailT)] = xmi[pi * LDC + c] + "
     "__ldg(wt.b3 + c);\n  }\n  ST(7)\n"
     f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS})\n"
     f"    for (int i = 0; i < {N}; ++i) lgteun_stamps[blockIdx.x][i] = "
     "ph[i];\n"),
    ("block_tail.cu", 'extern "C" int lgteun_block_tail_layout()',
     'extern "C" int lgteun_read_stamps(long long* h) {\n'
     "  return (int)cudaMemcpyFromSymbol(h, lgteun_stamps,\n"
     "                                   sizeof(lgteun_stamps));\n}\n"
     'extern "C" int lgteun_block_tail_layout()'),
]


# the FFT mixer's passes (fft_mixer.cuh::FftPlane), thread 0 of each block
# stamping at the start of each phase into global arrays (the phases lie
# in three functions): the W forward passes (the first one reading the
# plane from global memory), the split into the half spectrum, the H
# forward passes, the amp/phase chain, the H inverse passes, the c2r
# combination (on a cluster of two blocks, with the exchange before it),
# the W inverse passes (the last one writing global memory; stamped after
# a barrier)
MIXER_PHASES = ("W forward", "split", "H forward", "amp/phase", "H inverse",
                "c2r", "W inverse")
NM = len(MIXER_PHASES)
_FST = (f"if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{ long long n_ = "
        "clock64(); lgteun_fft_stamps[blockIdx.x][i] += n_ - "
        "lgteun_fft_t0[blockIdx.x]; lgteun_fft_t0[blockIdx.x] = n_; }")
_FST0 = (f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n"
         "    lgteun_fft_t0[blockIdx.x] = clock64();\n"
         f"    for (int i = 0; i < {NM}; ++i) lgteun_fft_stamps[blockIdx.x][i] "
         "= 0;\n  }\n")
MIXER_STAMPS = [
    ("fft_mixer.cuh", "namespace {\n\n__device__ __forceinline__ float2 cadd",
     f"namespace {{\n__device__ long long lgteun_fft_stamps[{MAX_BLOCKS}]"
     f"[{NM}];\n__device__ long long lgteun_fft_t0[{MAX_BLOCKS}];\n"
     f"#define FST(i) {_FST}\n\n__device__ __forceinline__ float2 cadd"),
    ("fft_mixer.cuh", "  const FftPlane plane(tab, sm);\n  plane.load_plan();\n"
     "  __syncthreads();\n",
     "  const FftPlane plane(tab, sm);\n" + _FST0 + "  plane.load_plan();\n"
     "  __syncthreads();\n"),
    ("fft_mixer.cuh",
     "  float2* peer = cluster.map_shared_rank(A, rank ^ 1);\n",
     "  float2* peer = cluster.map_shared_rank(A, rank ^ 1);\n" + _FST0),
    ("fft_mixer.cuh", "    // split: the half spectrum",
     "    FST(0)\n    // split: the half spectrum"),
    ("fft_mixer.cuh", "    // H forward on the columns",
     "    FST(1)\n    // H forward on the columns"),
    ("fft_mixer.cuh", "    // amp/phase, one bin a thread",
     "    FST(2)\n    // amp/phase, one bin a thread"),
    ("fft_mixer.cuh", "    // H inverse: the passes transposed",
     "    FST(3)\n    // H inverse: the passes transposed"),
    ("fft_mixer.cuh", "    // c2r: Z'[k]", "    FST(4)\n    // c2r: Z'[k]"),
    ("fft_mixer.cuh", "    // W inverse: the row passes",
     "    FST(5)\n    // W inverse: the row passes"),
    ("fft_mixer.cuh",
     "        outr[i] = make_float2(fabsf(z.x * norm), fabsf(z.y * norm));\n"
     "      }\n  }\n",
     "        outr[i] = make_float2(fabsf(z.x * norm), fabsf(z.y * norm));\n"
     "      }\n    __syncthreads();\n    FST(6)\n  }\n"),
    ("spectral_head.cu", 'extern "C" int lgteun_fft_mixer_layout()',
     'extern "C" int lgteun_read_fft_stamps(long long* h) {\n'
     "  return (int)cudaMemcpyFromSymbol(h, lgteun_fft_stamps,\n"
     "                                   sizeof(lgteun_fft_stamps));\n}\n"
     'extern "C" int lgteun_fft_mixer_layout()'),
]


def stamped_copy(dst: Path) -> None:
    """csrc with the stamps of STAMPS and MIXER_STAMPS, into dst."""
    from lgteun_tpu_torch.ops import _cuda
    shutil.copytree(_cuda.CSRC, dst)
    for name, anchor, text in STAMPS + MIXER_STAMPS:
        f = dst / name
        src = f.read_text()
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} occurs "
                               f"{src.count(anchor)} times")
        f.write_text(src.replace(anchor, text))


def read_stamps(dll: ctypes.CDLL, entry: str, blocks: int, cols: int,
                mean: bool = True):
    """(the mean, the number of blocks averaged) over the first `blocks`
    blocks with stamps of the [MAX_BLOCKS, cols] stamps that C entry
    `entry` of `dll` copies out; with mean=False those blocks' rows."""
    fn = getattr(dll, entry)
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    h = torch.zeros(MAX_BLOCKS, cols, dtype=torch.int64)
    err = fn(ctypes.c_void_p(h.data_ptr()))
    if err:
        raise RuntimeError(f"reading the stamps: CUDA error {err}")
    h = h[:min(blocks, MAX_BLOCKS)]
    h = h[h.sum(1) > 0]
    return (h.double().mean(0).tolist(), h.shape[0]) if mean else h


def phases(card: str, batch: int, tmp: str) -> None:
    """Print the block tail's clocks a tile and the FFT mixer's clocks a
    plane by phase (see --phases)."""
    stamped_copy(Path(tmp) / "csrc")
    dll = build(str(Path(tmp) / "csrc"), tmp, "stamped")
    cases = lgb_cases(batch, (128, 64, 144, 72),
                      torch.Generator().manual_seed(19971118))
    lay = layouts(dll)
    labels = [f"block_tail {batch}x32x128x128", f"block_tail {batch}x64x64x64",
              f"ln_mixer_head {batch}x32x128x128",
              f"ln_mixer_head {batch}x64x64x64",
              f"ln_mixer_head {batch}x32x144x144",
              f"ln_mixer_head {batch}x64x72x72"]
    for label in labels:
        entry, ins, alloc, dims = cases[label]
        outs = alloc()
        call = caller(dll, entry, *ins(lay), *outs, *dims)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        _b, c, _h, hw = (int(v) for v in label.split()[1].split("x"))
        if entry == "lgteun_block_tail":
            m, blocks = read_stamps(dll, "lgteun_read_stamps",
                                    batch * (hw // 8) ** 2, N)
            total, names, unit = sum(m[:len(PHASES)]), PHASES + WAITS, "tile"
        else:   # one or two blocks a plane
            m, blocks = read_stamps(dll, "lgteun_read_fft_stamps",
                                    batch * c, NM)
            total, names, unit = sum(m), MIXER_PHASES, "plane"
        parts = "  ".join(f"{p} {v:.0f} ({v / total:.3f})"
                          for p, v in zip(names, m))
        print(f"phases {label}: {total:.0f} clocks a {unit} (thread 0, mean "
              f"of {blocks} blocks): {parts}  [{card}]")


# --b8-phases: the whole block's kinds of work (csrc/lgb_block.cu), thread
# 0 of each block adding up the clocks of each and counting its events:
# the LN, the mixer planes, the windows, the tail items, the waits (a grid
# barrier, or a spin on an image's dependency counters) and taking an
# item from the work list
B8_PHASES = ("LN", "planes", "windows", "tails", "waits", "take")
NB8 = len(B8_PHASES)
B8_STAMP_DEFS = (
    f"__device__ long long lgteun_lgb_stamps[{MAX_BLOCKS}][{2 * NB8}];\n"
    "#define LGB_STAMP_INIT long long tp_ = clock64(), "
    f"ph_[{2 * NB8}] = {{}};\n"
    "#define LGB_STAMP(i) { const long long n_ = clock64(); "
    f"ph_[i] += n_ - tp_; ph_[{NB8} + (i)] += 1; tp_ = n_; }}\n"
    f"#define LGB_STAMP_END if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) "
    f"for (int i_ = 0; i_ < {2 * NB8}; ++i_) "
    "lgteun_lgb_stamps[blockIdx.x][i_] = ph_[i_];\n")
B8_READ = ('extern "C" int lgteun_read_lgb_stamps(long long* h) {\n'
           "  return (int)cudaMemcpyFromSymbol(h, lgteun_lgb_stamps,\n"
           "                                   sizeof(lgteun_lgb_stamps));\n"
           "}\n")
# the earlier kernel, whose phases were separated by grid.sync(): anchors
B8_GRID_STAMPS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n" + B8_STAMP_DEFS),
    ("  // A. LN + split\n", "  LGB_STAMP_INIT\n  // A. LN + split\n"),
    ("                   a.eps);\n  grid.sync();\n",
     "                   a.eps);\n  LGB_STAMP(0)\n  grid.sync();\n"
     "  LGB_STAMP(4)\n"),
    ("    const int it = *item;\n    __syncthreads();\n",
     "    const int it = *item;\n    __syncthreads();\n    LGB_STAMP(5)\n"),
    ("                                    w / nwin, w % nwin);\n    }\n  }\n"
     "  grid.sync();\n",
     "                                    w / nwin, w % nwin);\n    }\n"
     "    LGB_STAMP(it < planes ? 1 : 2)\n  }\n  grid.sync();\n"
     "  LGB_STAMP(4)\n"),
    ("    __syncthreads();  // shared memory is reused by the next tile\n"
     "  }\n}\n",
     "    __syncthreads();  // shared memory is reused by the next tile\n"
     "    LGB_STAMP(3)\n  }\n  LGB_STAMP_END\n}\n"),
]


def b8_stamped_copy(src: Path, dst: Path, only: int = 0) -> None:
    """csrc dir `src` into dst with clock stamps in lgb_block.cu: through
    the stamps that a kernel declares under LGTEUN_LGB_STAMPS (and, with
    `only`, its LGTEUN_LGB_ONLY: 1 the LN and plane items alone, 2 the
    tail items alone), or, in the grid-barrier kernel, at the anchors of
    B8_GRID_STAMPS."""
    shutil.copytree(src, dst)
    f = dst / "lgb_block.cu"
    text = f.read_text()
    if "LGTEUN_LGB_STAMPS" in text:
        text = (f"#define LGTEUN_LGB_STAMPS {MAX_BLOCKS}\n"
                f"#define LGTEUN_LGB_ONLY {only}\n" + text)
    else:
        for anchor, new in B8_GRID_STAMPS:
            if text.count(anchor) != 1:
                raise RuntimeError(f"lgb_block.cu: anchor {anchor!r} occurs "
                                   f"{text.count(anchor)} times")
            text = text.replace(anchor, new)
        text += B8_READ
    f.write_text(text)


def b8_inputs(b: int, c: int, hw: int, gen: torch.Generator) -> tuple:
    """x [b, c, hw, hw] and the block's weights (2 heads, 8x8 windows),
    seeded, on the card."""
    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()
    c2, c4 = c // 2, 4 * c
    blk = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c), "amp_w": n(c2),
           "amp_b": 0.1 * n(c2), "pha_w": n(c2), "pha_b": 0.1 * n(c2),
           "wqkv": n(3 * c2, c2, scale=c2 ** -0.5), "bqkv": 0.1 * n(3 * c2),
           "pos": n(2, 64, 64), "proj_w": n(c, c, scale=c ** -0.5),
           "proj_b": 0.1 * n(c),
           "ffn": {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
                   "w1": n(c4, c, scale=c ** -0.5), "b1": 0.1 * n(c4),
                   "w2": n(c4, c4, scale=c4 ** -0.5), "b2": 0.1 * n(c4),
                   "dw": n(c4, 3, 3, scale=1 / 3), "bdw": 0.1 * n(c4),
                   "w3": n(c, c4, scale=c4 ** -0.5), "b3": 0.1 * n(c)}}
    return n(b, c, hw, hw), blk


B8_SHAPES = ((32, 128), (64, 64), (128, 64))


def b8_phases(card: str, tmp: str, src: str | None, only: int = 0) -> None:
    """Print the whole block's clocks by kind of work beside the device
    times of B1, B2 and B3 (the level-2 chain) on the same inputs, at
    B8_SHAPES and batch 4 and 16 (see --b8-phases); with `only`, of the
    stamped build that runs some kinds of item alone (b8_stamped_copy),
    whose device time is then the one given."""
    from chip_smoke import device_profile
    from lgteun_tpu_torch.ops import _cuda, lgb_block_kernel
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail
    from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head
    from lgteun_tpu_torch.ops.window_attention import window_attention
    b8_stamped_copy(Path(src) if src else _cuda.CSRC, Path(tmp) / "csrc",
                    only)
    stamped = build(str(Path(tmp) / "csrc"), tmp, "b8stamped")
    plain_lib = _cuda.kernels()
    gen = torch.Generator().manual_seed(19971118)
    dev_ms = lambda call: device_profile(call, n=20)["busy_ms_per_call"]
    for b in (4, 16):
        for c, hw in B8_SHAPES:
            x, blk = b8_inputs(b, c, hw, gen)
            mix = [blk[k] for k in ("ln_w", "ln_b", "amp_w", "amp_b",
                                    "pha_w", "pha_b")]
            y1, x2 = ln_mixer_head(x, *mix)
            x1 = window_attention(y1, blk["wqkv"], blk["bqkv"], blk["pos"],
                                  2, 8)
            chain = {
                "B1": dev_ms(lambda: ln_mixer_head(x, *mix)),
                "B2": dev_ms(lambda: window_attention(
                    y1, blk["wqkv"], blk["bqkv"], blk["pos"], 2, 8)),
                "B3": dev_ms(lambda: block_tail(x, x1, x2, blk["proj_w"],
                                                blk["proj_b"], blk["ffn"]))}
            whole = (dev_ms(lambda: lgb_block_kernel.lgb_block(x, blk))
                     if not only else None)
            _cuda.kernels = lambda: stamped
            try:
                if only:
                    whole = dev_ms(lambda: lgb_block_kernel.lgb_block(x, blk))
                for _ in range(3):
                    lgb_block_kernel.lgb_block(x, blk)
                torch.cuda.synchronize()
                m, blocks = read_stamps(stamped, "lgteun_read_lgb_stamps",
                                        MAX_BLOCKS, 2 * NB8)
            finally:
                _cuda.kernels = lambda: plain_lib
            total = sum(m[:NB8])
            per_us = total / (whole * 1e3)   # clocks a microsecond
            each = [v / max(n, 1e-9) / per_us
                    for v, n in zip(m[:NB8], m[NB8:])]   # us an event
            parts = "  ".join(
                f"{p} {v:.0f} ({v / total:.3f}, {v / total * whole:.4f} ms; "
                f"{m[NB8 + i]:.1f} a block, {each[i]:.2f} us each)"
                for i, (p, v) in enumerate(zip(B8_PHASES, m)))
            print(f"b8 phases{f' (only {only})' if only else ''} "
                  f"{b}x{c}x{hw}x{hw}: lgb_block {whole:.4f} ms "
                  f"(device), {total:.0f} clocks a block (thread 0, mean of "
                  f"{blocks} blocks): {parts}  |  chain B1 {chain['B1']:.4f} "
                  f"+ B2 {chain['B2']:.4f} + B3 {chain['B3']:.4f} = "
                  f"{sum(chain.values()):.4f} ms  B8 / chain "
                  f"{whole / sum(chain.values()):.3f}  [{card}]")


SEARCH_PHASES = ("staging", "A fragments", "products", "fold", "merge",
                 "end barrier", "fold/transfer")


def search_phases(card: str, batch: int, tmp: str, src: str | None) -> None:
    """Print the INNT searches' clocks by phase on the tensor-core branch
    (thread 0 of each block, warpgroup 0's; see --search-phases): a copy
    of CSRC built with LGTEUN_SEARCH_STAMPS, `lgteun_texture_match` and
    `lgteun_patch_match` at INNT's shapes (N = 256 patch-images an image,
    C = 4, side 24), each phase's clocks a block, its share and that
    share of the device time of an unstamped launch."""
    from chip_smoke import device_profile
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.texture_match_kernel import row_normalize
    dst = Path(tmp) / "csrc"
    shutil.copytree(Path(src) if src else _cuda.CSRC, dst)
    f = dst / "texture_match.cu"
    f.write_text(f"#define LGTEUN_SEARCH_STAMPS {MAX_BLOCKS}\n"
                 + f.read_text())
    stamped = build(str(dst), tmp, "searchstamped")
    plain = build(src, tmp, "search") if src else _cuda.kernels()
    gen = torch.Generator().manual_seed(19971118)
    n, c, side = 256 * batch, 4, 24
    q = side * side
    lr, ref = (torch.randn(n, c, q, generator=gen).cuda() for _ in range(2))
    unf = lambda v: F.unfold(v.view(n, c, side, side), 3, padding=1)
    ref_u = unf(ref)
    lr_n = row_normalize(unf(lr), 1).transpose(1, 2).contiguous()
    ref_n = row_normalize(ref_u, 1).transpose(1, 2).contiguous()
    t, s = torch.empty(n, c, q, device="cuda"), torch.empty(n, q,
                                                            device="cuda")
    tt = torch.empty(n, 9 * c, q, device="cuda")
    cases = {"texture_match": ("lgteun_texture_match", (lr, ref, t, s, n, c,
                                                        side)),
             "patch_match": ("lgteun_patch_match", (lr_n, ref_n, ref_u, tt,
                                                    s, n, q, 9 * c))}
    for name, (entry, args) in cases.items():
        whole = device_profile(caller(plain, entry, *args),
                               n=20)["busy_ms_per_call"]
        run = caller(stamped, entry, *args)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        h = read_stamps(stamped, "lgteun_read_search_stamps", MAX_BLOCKS,
                        12, mean=False)
        m = h.double().mean(0).tolist()
        total = sum(m[:7])
        parts = "  ".join(f"{p} {v:.0f} ({v / total:.3f}, "
                          f"{v / total * whole:.4f} ms)"
                          for p, v in zip(SEARCH_PHASES, m))
        # per SM: the blocks' global-timer spans, the gaps between them,
        # and the clock rate (clocks / ns)
        span = (h[:, 9] - h[:, 8]).double()
        ghz = (h[:, 11].double() / span).mean().item()
        gaps, per_sm = [], []
        for sm in h[:, 10].unique():
            b = h[h[:, 10] == sm]
            b = b[b[:, 8].argsort()]
            gaps += (b[1:, 8] - b[:-1, 9]).tolist()
            per_sm.append(len(b))
        launch_ns = (h[:, 9].max() - h[:, 8].min()).item()
        print(f"search phases {name} {n}x{c}x{q}: {whole:.4f} ms (device), "
              f"{total:.0f} clocks a block (thread 0, mean of {len(h)} "
              f"blocks; {m[7]:.0f} chunks: products {m[2] / m[7]:.0f}, fold "
              f"{m[3] / m[7]:.0f} clocks a chunk): {parts}; a block "
              f"{span.mean().item() / 1e3:.2f} us at {ghz:.3f} GHz, "
              f"{min(per_sm)}-{max(per_sm)} blocks an SM, gaps between "
              f"them {sum(gaps) / max(len(gaps), 1) / 1e3:.2f} us, first "
              f"start to last end {launch_ns / 1e6:.4f} ms  [{card}]")


LIGHTNET_PHASES = ("staging", "products", "barrier 1", "depthwise",
                   "barrier 2")
NA_PHASES = ("staging", "theta", "logits", "softmax", "P.g", "epilogue")


def stack_phases(card: str, tmp: str, src: str | None) -> None:
    """Print where LightNet's stack and the neighbourhood attention spend
    their time (see --stack-phases): a copy of CSRC built with
    LGTEUN_LIGHTNET_STAMPS and LGTEUN_NA_STAMPS; the stack at
    [4,9,128,128], launch by launch, and the attention at [4,8,128,128]
    and [1,8,72,100]: each phase's clocks a block (thread 0), its share,
    that share of an unstamped launch's device time, the blocks' clock
    rate, blocks an SM and the span from the first block's start to the
    last one's end."""
    from chip_smoke import device_profile
    from lgteun_tpu_torch.ops import _cuda
    dst = Path(tmp) / "csrc"
    shutil.copytree(Path(src) if src else _cuda.CSRC, dst)
    for name, macro in (("lightnet.cu", "LGTEUN_LIGHTNET_STAMPS"),
                        ("neighborhood_attention.cu", "LGTEUN_NA_STAMPS")):
        f = dst / name
        f.write_text(f"#define {macro} {MAX_BLOCKS}\n" + f.read_text())
    stamped = build(str(dst), tmp, "stackstamped")
    plain = build(src, tmp, "stack") if src else _cuda.kernels()
    gen = torch.Generator().manual_seed(19971118)
    cases = stack_cases(gen)

    def report(label, entry, cols, phases, run_plain, run_stamped, blocks):
        whole = device_profile(run_plain, n=20)["busy_ms_per_call"]
        for _ in range(3):
            run_stamped()
        torch.cuda.synchronize()
        # this launch's blocks only: the rows past them hold an earlier
        # launch's stamps
        h = read_stamps(stamped, entry, blocks, cols, mean=False)
        m = h.double().mean(0).tolist()
        n = len(phases)
        total = sum(m[:n])
        parts = "  ".join(f"{p} {v:.0f} ({v / total:.3f}, "
                          f"{v / total * whole:.4f} ms)"
                          for p, v in zip(phases, m))
        t0, t1, sm, clk = (cols - 4, cols - 3, cols - 2, cols - 1)
        span = (h[:, t1] - h[:, t0]).double()
        ghz = (h[:, clk].double() / span).mean().item()
        per_sm = [int((h[:, sm] == k).sum()) for k in h[:, sm].unique()]
        launch_ns = (h[:, t1].max() - h[:, t0].min()).item()
        print(f"stack phases {label}: {whole:.4f} ms (device), {total:.0f} "
              f"clocks a block (thread 0, mean of {len(h)} blocks, "
              f"{m[n]:.0f} steps): {parts}; a block "
              f"{span.mean().item() / 1e3:.2f} us at {ghz:.3f} GHz, "
              f"{min(per_sm)}-{max(per_sm)} blocks an SM, first start to "
              f"last end {launch_ns / 1e6:.4f} ms  [{card}]")

    for label, (entry, ins, alloc, dims, launcher) in cases.items():
        if label.startswith("lightnet_stack 4x9"):
            out = alloc()
            plain_calls = launcher(plain, layouts(plain), out)
            stamped_calls = launcher(stamped, layouts(stamped), out)
            for c in plain_calls:   # every launch's input, once
                c()
            b, _c, h, w = out[0].shape
            tiles = b * -(-h // 16) * -(-w // 16)
            for k, (cp, cs) in enumerate(zip(plain_calls, stamped_calls)):
                report(f"{label} launch {k}", "lgteun_read_lightnet_stamps",
                       10, LIGHTNET_PHASES, cp, cs, tiles)
        elif label in ("neighborhood_attention 4x8x128x128",
                       "neighborhood_attention 1x8x72x100"):
            args = ins(None)
            run = {tag: caller(dll, entry, *args, *alloc(), *dims)
                   for tag, dll in (("plain", plain), ("stamped", stamped))}
            # csrc/neighborhood_attention.cu::launch_na_tc's grid: 8 runs a
            # block where that gives 3 blocks an SM, else 4
            b, _c, h, w = dims[:4]
            runs = -(-w // 16)
            rows = 8 if b * -(-h // 8) * runs >= 3 * 132 else 4
            report(label, "lgteun_read_na_stamps", 11, NA_PHASES,
                   run["plain"], run["stamped"], b * -(-h // rows) * runs)


def forward_ab(card: str, libs: dict, config: str, envs) -> None:
    """A method's eval forward (the shipped config `config`, seeded
    weights, seeded WV-3 images) with library A's and B's kernels in
    turns A B B A twice, under each environment of `envs`: batch-16 ms
    (CUDA events, 10 calls), batch-1 latency (median of 15 synchronised
    calls), device busy time and the top device kernels (profiler) and
    max|A - B| of the output (for INNT near-tie picks may move it). A
    library without `lgteun_lightnet_layout` gets LightNet's weights in
    its own packed FP32 layout (`lightnet_packed_fp32`)."""
    import statistics
    import time
    from chip_smoke import CONFIGS, SEED, SceneDataset, device_profile, \
        time_ms
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import eval_batches
    from lgteun_tpu_torch.ops import _cuda, lightnet_kernel
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner
    from unittest import mock
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    own, own_packed = _cuda.kernels, lightnet_kernel._packed

    def packed_for(lib):
        if layouts(lib)[4] != 1:
            return own_packed
        return lambda layers, table, device: _cuda.weight_layout(
            "lightnet_fp32", [t for layer in layers for t in layer],
            lambda: lightnet_packed_fp32(layers, table))
    try:
        for env in envs:
            cfg = load_config(os.path.join(CONFIGS, config))
            with mock.patch.dict(os.environ, env):
                method = build_model(cfg.model_type, cfg, device="cuda")
            runner = Runner(cfg, method, "cuda").init(SEED)
            items = next(eval_batches(SceneDataset(16, cfg.ms_chans, SEED),
                                      16))[0]
            b16 = runner.to_device(items)
            b1 = runner.to_device({k: v[:1] for k, v in items.items()
                                   if k != "image_id"})
            ms, lat, prof, out = {"A": [], "B": []}, {"A": [], "B": []}, \
                {}, {}
            for tag in "ABBAABBA":
                _cuda.kernels = (lambda lib: lambda: lib)(libs[tag])
                lightnet_kernel._packed = packed_for(libs[tag])
                for _ in range(3):
                    runner.predict(b16)
                ms[tag].append(time_ms(lambda: runner.predict(b16), iters=10))
                for _ in range(15):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runner.predict(b1)
                    torch.cuda.synchronize()
                    lat[tag].append((time.perf_counter() - t0) * 1e3)
                if tag not in prof:
                    prof[tag] = device_profile(lambda: runner.predict(b16))
                    out[tag] = runner.predict(b16).cpu()
            for tag in "AB":
                p, med = prof[tag], statistics.median(ms[tag])
                top = "; ".join(f"{share:.3f} {name[:40]}"
                                for name, share in p["top"][:6])
                print(f"{cfg.model_type} {env} {tag}: batch-16 "
                      f"{[round(x, 3) for x in ms[tag]]} ms, median {med:.3f}"
                      f" = {16e3 / med:.1f} images/s; batch-1 median "
                      f"{statistics.median(lat[tag]):.3f} ms; device busy "
                      f"{p['busy_ms_per_call']:.3f} of "
                      f"{p['wall_ms_per_call']:.3f} ms (idle "
                      f"{p['idle_share']:.3f}); top: {top}  [{card}]")
            print(f"{cfg.model_type} {env}: max|B - A| of the batch-16 "
                  f"output {(out['A'] - out['B']).abs().max().item():.3e}")
    finally:
        _cuda.kernels, lightnet_kernel._packed = own, own_packed


# the cluster route's sizes timed by --cluster-sizes: B4 on [B, C, H, W]
# (16 planes at batch 1 is B1's at C 32; the tile-256 scene's batch 32)
CLUSTER_SHAPES = ((1, 16, 256, 256), (1, 32, 256, 256), (4, 16, 256, 256),
                  (32, 16, 256, 256), (1, 16, 264, 264), (1, 16, 512, 512),
                  (1, 32, 512, 512), (4, 16, 512, 512), (1, 4, 1024, 512),
                  (1, 8, 384, 384))


def cluster_sizes(card: str) -> None:
    """The FFT mixer's cluster route (the port's csrc) forced at each
    cluster size that holds the plane (`lgteun_global_mixer_cluster_
    route`), beside the global route forced on the same planes and the
    route the launch picks by shape (`spectral_kernel.mixer_route`):
    device ms by the profiler, each forced output bit-equal to the route
    by shape, at CLUSTER_SHAPES."""
    from chip_smoke import device_profile
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.spectral_kernel import (FFT_CLUSTERS,
                                                      fft_cluster_plan,
                                                      fft_global_plan,
                                                      fft_tables,
                                                      global_mixer,
                                                      mixer_route)
    gen = torch.Generator().manual_seed(3)
    n = lambda *s: torch.randn(*s, generator=gen).cuda()
    dev = lambda f: device_profile(f, n=20)["busy_ms_per_call"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
    for shape in CLUSTER_SHAPES:
        b, c, h, w = shape
        x, mix = n(*shape), (n(c), 0.1 * n(c), n(c), 0.1 * n(c))
        by_shape = global_mixer(x, *mix)
        tab, out = fft_tables(h, w, x.device), torch.empty_like(x)
        scratch = torch.empty(b * c * fft_global_plan(h, w)["plane_bytes"]
                              // 4, device="cuda")
        calls = {"global": lambda: _cuda.launch(
            "lgteun_global_mixer_global_route", x.device, x, *mix, tab,
            scratch, out, b, c, h, w)}
        for k in FFT_CLUSTERS:
            if fft_cluster_plan(h, w, k) is not None:
                calls[f"k {k}"] = lambda k=k: _cuda.launch(
                    "lgteun_global_mixer_cluster_route", x.device, x, *mix,
                    tab, out, b, c, h, w, k)
        row = []
        for tag, call in calls.items():
            call()
            torch.cuda.synchronize()
            same = torch.equal(out, by_shape)
            row.append(f"{tag} {dev(call):.4f}{'' if same else ' DIFFERS'}")
            if not same:
                failed.append(f"{shape} {tag}")
        k = mixer_route(h, w, b * c, sms=sms)["k"]
        row.append(f"by shape (k {k}) "
                   f"{dev(lambda: global_mixer(x, *mix)):.4f}")
        print(f"cluster sizes {'x'.join(map(str, shape))} ({b * c} planes): "
              f"device ms {' | '.join(row)}  [{card}]")
    if failed:
        raise AssertionError(f"forced routes differ: {failed}")


# the FFT mixer's global route timed part by part by --global-parts: B1
# (its LN split and the mixer on the second half of the channels) and B4
# on [B, C, H, W] (the four shapes of PERF.md §6 rows 1 and 4)
GLOBAL_SHAPES = (("ln_mixer_head", (1, 32, 1024, 1024)),
                 ("global_mixer", (1, 16, 1024, 1024)),
                 ("global_mixer", (1, 4, 2048, 2048)),
                 ("global_mixer", (1, 4, 1024, 2048)))


def global_parts(card: str, tmp: str, src: str | None) -> None:
    """The FFT mixer's global route (of csrc CSRC, default the port's)
    forced at GLOBAL_SHAPES (`lgteun_ln_mixer_head_global_route`,
    `lgteun_global_mixer_global_route`): the device ms a call of each of
    its kernels by name (torch.profiler over 20 calls, the kernels' own
    intervals), the call's busy ms, and cuFFT's rfft2 + irfft2 on the
    mixed planes beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_profile
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.spectral_kernel import fft_mixer_plan
    dll = build(src or str(_cuda.CSRC), tmp, "parts")
    gen = torch.Generator().manual_seed(7)
    n = lambda *s: torch.randn(*s, generator=gen).cuda()
    for entry, (b, c, h, w) in GLOBAL_SHAPES:
        head = entry == "ln_mixer_head"
        c2 = c // 2 if head else c
        plan = fft_mixer_plan(h, w)
        tab = torch.empty(plan["floats"], device="cuda")
        caller(dll, "lgteun_fft_tables", tab, plan["floats"], h, w)()
        # as large as any version's scratch: [planes][H][ld] float2
        scratch = torch.empty(b * c2 * 2 * h * plan["ld"], device="cuda")
        x = n(b, c, h, w)
        mix = (n(c2), 0.1 * n(c2), n(c2), 0.1 * n(c2))
        if head:
            y1, x2 = (torch.empty(b, c2, h, w, device="cuda")
                      for _ in range(2))
            call = caller(dll, "lgteun_ln_mixer_head_global_route", x,
                          1 + 0.1 * n(c), 0.1 * n(c), *mix, tab, scratch,
                          y1, x2, b, c, h, w, 1e-5)
        else:
            call = caller(dll, "lgteun_global_mixer_global_route", x, *mix,
                          tab, scratch, torch.empty_like(x), b, c, h, w)
        call()
        torch.cuda.synchronize()
        iters = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        parts = collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.search(r"(\w+)(<[^()]*>)?\(", e.name)
                parts[name.group(1) if name else e.name[:40]] += (
                    e.time_range.end - e.time_range.start) / iters / 1e3
        planes = (x[:, c2:] if head else x).contiguous()
        fft = lambda: torch.fft.irfft2(torch.fft.rfft2(planes),
                                       s=planes.shape[-2:])
        busy = device_profile(call, n=iters)["busy_ms_per_call"]
        yard = device_profile(fft, n=iters)["busy_ms_per_call"]
        print(f"global parts {entry} {b}x{c}x{h}x{w}: busy {busy:.4f} ms a "
              f"call; by kernel "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"; cuFFT rfft2 + irfft2 {yard:.4f} ms  [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--mma-rate", action="store_true",
                    help="measure the TF32 tensor-core rates instead")
    ap.add_argument("--phases", action="store_true",
                    help="time the block tail's and the FFT mixer's phases "
                         "instead")
    ap.add_argument("--b8-phases", nargs="?", const="", default=None,
                    metavar="CSRC",
                    help="time the whole block's kinds of work instead, "
                         "in CSRC (default: the port's csrc)")
    ap.add_argument("--search-phases", nargs="?", const="", default=None,
                    metavar="CSRC",
                    help="time the INNT searches' phases instead, in CSRC "
                         "(default: the port's csrc)")
    ap.add_argument("--stack-phases", nargs="?", const="", default=None,
                    metavar="CSRC",
                    help="time LightNet's stack's and the neighbourhood "
                         "attention's phases instead, in CSRC (default: the "
                         "port's csrc)")
    ap.add_argument("--cluster-sizes", action="store_true",
                    help="time the FFT mixer's cluster route forced at each "
                         "cluster size instead, beside the global route")
    ap.add_argument("--global-parts", nargs="?", const="", default=None,
                    metavar="CSRC",
                    help="time the FFT mixer's global route kernel by "
                         "kernel instead, in CSRC (default: the port's "
                         "csrc)")
    ap.add_argument("--b8-only", type=int, default=0, choices=(0, 1, 2),
                    help="with --b8-phases: 1 times the LN and plane items "
                         "alone, 2 the tail items alone")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sizes", default="128,64,144,72",
                    help="H = W of the LGB cases (C 32 at 128, 144, 256, "
                         "264, 512 and 1024, C 64 at 64 and 72, C 8 at "
                         "2048)")
    ap.add_argument("--innt", action="store_true",
                    help="time INNT's eval forward with A's and B's "
                         "searches instead of the kernel cases")
    ap.add_argument("--lightnet", action="store_true",
                    help="time LightNet's eval forward with A's and B's "
                         "stack instead of the kernel cases")
    ap.add_argument("--mdcun", action="store_true",
                    help="time MDCUN's eval forward with A's and B's "
                         "neighbourhood attention instead of the kernel "
                         "cases")
    ap.add_argument("--only", default="", metavar="TEXT",
                    help="run only the cases whose label contains TEXT (or "
                         "one of comma-separated TEXTs); with --innt, "
                         "--lightnet or --mdcun, those cases and then the "
                         "forwards")
    ap.add_argument("--tol", type=float, default=None, metavar="REL",
                    help="accept max|B - A| / max|A| <= REL (default: "
                         "bit-equal outputs)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import (KERNEL_REL_TOL, device_profile, near_tie_mask,
                            sh, time_ms)
    from lgteun_tpu_torch.ops.texture_match_kernel import row_normalize

    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    if opts.cluster_sizes:
        from lgteun_tpu_torch.ops import _cuda
        _cuda.build_library()
        cluster_sizes(card)
        return 0
    if opts.global_parts is not None:
        with tempfile.TemporaryDirectory() as tmp:
            global_parts(card, tmp, opts.global_parts or None)
        return 0
    if opts.mma_rate or opts.phases or opts.b8_phases is not None \
            or opts.search_phases is not None \
            or opts.stack_phases is not None:
        with tempfile.TemporaryDirectory() as tmp:
            if opts.mma_rate:
                mma_rate(card, tmp)
            elif opts.stack_phases is not None:
                stack_phases(card, tmp, opts.stack_phases or None)
            elif opts.search_phases is not None:
                search_phases(card, opts.batch, tmp,
                              opts.search_phases or None)
            elif opts.b8_phases is not None:
                b8_phases(card, tmp, opts.b8_phases or None, opts.b8_only)
            else:
                phases(card, opts.batch, tmp)
        return 0
    if not (opts.a and opts.b):
        ap.error("A and B are needed without --mma-rate or --phases")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"A": build(opts.a, tmp, "a"), "B": build(opts.b, tmp, "b")}
    forwards = [("INNT.py", ({}, {"LGTEUN_FUSED_TM": "0"}))] * opts.innt \
        + [("lightnet.py", ({},))] * opts.lightnet \
        + [("MDCUN.py", ({},))] * opts.mdcun
    if forwards and not opts.only:
        for config, envs in forwards:
            forward_ab(card, libs, config, envs)
        return 0
    gen = torch.Generator().manual_seed(19971118)
    n, c, side = 256 * opts.batch, 4, 24
    q = side * side

    def images(n, c):
        x = torch.randn(n, c, side, side, generator=gen)
        x[: n // 4, :, :8] = 0
        x[: n // 4, :, :, :8] = 0
        return x.reshape(n, c, q).cuda()

    # INNT's searches (C 4: the tensor cores), and at C 8 (K 72) on the
    # FP32-core body
    cases = {}
    for n, c in ((n, c), (64, 8)):
        lr, ref = images(n, c), images(n, c)
        unf = lambda v, n=n, c=c: F.unfold(v.view(n, c, side, side), 3,
                                           padding=1)
        ref_u = unf(ref)
        lr_n = row_normalize(unf(lr), 1).transpose(1, 2).contiguous()
        ref_n = row_normalize(ref_u, 1).transpose(1, 2).contiguous()
        cases[f"texture_match {n}x{c}x{q}"] = (
            "lgteun_texture_match", lambda lay, a=(lr, ref): a,
            lambda n=n, c=c: (torch.empty(n, c, q, device="cuda"),
                              torch.empty(n, q, device="cuda")),
            (n, c, side))
        cases[f"patch_match {n}x{q}x{9 * c}"] = (
            "lgteun_patch_match", lambda lay, a=(lr_n, ref_n, ref_u): a,
            lambda n=n, c=c: (torch.empty(n, 9 * c, q, device="cuda"),
                              torch.empty(n, q, device="cuda")),
            (n, q, 9 * c))
        # their bf16 entries (the zoo's blanket cast) on the same values
        h = lambda *t: tuple(v.to(torch.bfloat16) for v in t)
        cases[f"bf16 texture_match {n}x{c}x{q}"] = (
            "lgteun_texture_match_bf16", lambda lay, a=h(lr, ref): a,
            lambda n=n, c=c: (torch.empty(n, c, q, device="cuda",
                                          dtype=torch.bfloat16),
                              torch.empty(n, q, device="cuda",
                                          dtype=torch.bfloat16)),
            (n, c, side))
        cases[f"bf16 patch_match {n}x{q}x{9 * c}"] = (
            "lgteun_patch_match_bf16",
            lambda lay, a=h(lr_n, ref_n, ref_u): a,
            lambda n=n, c=c: (torch.empty(n, 9 * c, q, device="cuda",
                                          dtype=torch.bfloat16),
                              torch.empty(n, q, device="cuda",
                                          dtype=torch.bfloat16)),
            (n, q, 9 * c))
    cases.update(lgb_cases(opts.batch, map(int, opts.sizes.split(",")),
                           gen))
    cases = {k: v + (None,) for k, v in cases.items()}
    cases.update(stack_cases(gen))
    lays = {tag: layouts(dll) for tag, dll in libs.items()}
    failed = []
    for label, (entry, ins, alloc, dims, launcher) in cases.items():
        if not any(t in label for t in opts.only.split(",")) or not all(
                hasattr(dll, entry) for dll in libs.values()):
            continue
        outs, calls = {}, {}
        for tag, dll in libs.items():
            outs[tag] = alloc()
            calls[tag] = (lambda cs: lambda: [c() for c in cs])(
                launcher(dll, lays[tag], outs[tag])) if launcher \
                else caller(dll, entry, *ins(lays[tag]), *outs[tag],
                            *(dims(lays[tag]) if callable(dims) else dims))
            if entry == "lgteun_lgb_block":   # counters zero at each launch
                calls[tag] = (lambda call, counters: lambda: (
                    counters.zero_(), call()))(calls[tag], outs[tag][1])
            calls[tag]()
        torch.cuda.synchronize()
        # the whole block's scratch and work counter are no output
        got = {t: o[-1:] if entry == "lgteun_lgb_block" else o
               for t, o in outs.items()}
        same = all(torch.equal(x, y) for x, y in zip(got["A"], got["B"]))
        rel = 0.0 if same else rel_diff(got["A"], got["B"])
        verdict = f"outputs bit-equal {same}"
        ok = same or (opts.tol is not None and rel <= opts.tol)
        search = label.split()[0]
        if search in ("texture_match", "patch_match"):
            (ta, sa), (tb, sb) = got["A"], got["B"]
            mask, n_near = near_tie_mask(search, ins(None), ta)
            picks = torch.equal(ta * ~mask, tb * ~mask)
            rel = rel_diff((sa,), (sb,))
            print(f"ab {label}: near-tie queries {n_near}, masked "
                  f"{int(mask.sum())} of {ta.numel()} transferred values; "
                  f"transferred values bit-equal outside them {picks}; "
                  f"s max|B - A| / max|A| {rel:.3e}")
            ok = picks and rel <= (opts.tol if opts.tol is not None
                                   else KERNEL_REL_TOL)
            verdict = (f"picks equal and s within the bound {ok} (outputs "
                       f"bit-equal {same})")
        a1, b1, b2, a2 = (time_ms(calls[t]) for t in "ABBA")
        dev = {t: device_profile(calls[t], n=20)["busy_ms_per_call"]
               for t in "AB"}
        print(f"ab {label}: A {a1:.4f}/{a2:.4f} ms  B "
              f"{b1:.4f}/{b2:.4f} ms  A/B {(a1 + a2) / (b1 + b2):.3f}  "
              f"device A {dev['A']:.4f} B {dev['B']:.4f} ms A/B "
              f"{dev['A'] / dev['B']:.3f}  "
              f"{verdict}, max|B - A| / max|A| {rel:.3e}  [{card}]")
        if not ok:
            failed.append(f"{label} ({rel:.3e})")
    for config, envs in forwards:
        forward_ab(card, libs, config, envs)
    if failed:
        raise AssertionError("B's outputs differ from A's"
                             + (f" beyond {opts.tol:g}" if opts.tol else "")
                             + ": " + ", ".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
