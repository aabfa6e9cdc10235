"""Height-sharded eval forwards over the `space` axis of the port's mesh
(counterpart of `lgteun_tpu/parallel/spatial.py`, ROADMAP A.9.2).

The JAX module hands any function to GSPMD with the image height sharded
over `space`, and XLA writes the halo exchanges and the collectives.
PyTorch has no such partitioner, so here each method that can be
sharded has a height-sharded forward of its own, with the halo of each
operation written out:

    spatial_sharding(mesh, batch_axis=None, space_axis="space")
                     the rank's H rows and batch rows of an NHWC array
                     (`SpatialSharding`; JAX's NamedSharding(mesh,
                     P(batch_axis, space_axis)))
    run_spatially_sharded(method, batch, mesh, batch_axis=None,
                          space_axis="space")
                     every image of `batch` (NHWC numpy arrays or
                     tensors; `image_id` passed through) cut to the
                     rank's rows, the method's height-sharded forward
                     under torch.no_grad(), the rank's rows of the output
                     (NHWC, on the method's device)
    gather_h(out, mesh, batch_axis=None)
                     the whole output on every rank

`method` is what JAX's `fn` was: a `TorchMethod` or `ClassicalMethod`
(the Runner's), or a bare module, and its forward is chosen by the type
of module it holds (`LGTEUN`, `LightNetModule`, `PanUnfolding`,
`GPPNNINNT`, `GPPNNMutInf`, `SFIINNet`, `CrossSwinTransformer`) or, for
a classical method, by its fuse function (SFIM, Wavelet, GSA), so every
registered method shards, as JAX's GSPMD shards any function. A
`TorchMethod`'s forward runs inside its `eval_cast`, as its whole
forward does: under LGTEUN_EVAL_DTYPE=bf16 the zoo's blanket cast (the
bfloat16 copy of the parameters, `jax_promotion`, bfloat16 ms and pan;
MutInf opts out and runs float32), and LightNet's bf16 tap path under
LGTEUN_LIGHTNET_DTYPE=bf16 (`lightnet_tap_rows`). The JAX module's jit
cache (`_JITTED`) has no counterpart: these forwards are eager, and
nothing is traced or compiled per function.

The collectives (NCHW strips, H at dim -2, over the rank's
`space_group`); these three are the only ones a forward runs (a mean
over H x W, `space_mean`, all-reduces float32 partial sums, a bfloat16
tensor's upcast, and rounds once, as torch's bfloat16 mean accumulates
in float32; so do the instance norms; bfloat16 partials are never
summed):

    halo_rows(x, above, below, mesh, edge)
                     `above` rows of the rank above and `below` rows of
                     the rank below around x (`dist.batch_isend_irecv`);
                     at the image's own top and bottom `edge` gives
                     "zero": zero rows (a conv's zero padding), "none": no
                     rows (a resample clamps its taps at the real edge;
                     a conv pads there itself), "wrap": the rows of the
                     far end (SFIM's circular box filter)
    all_gather_h(x, mesh, dim=-2)
                     the whole plane, in rank order
    space_sum(t, mesh)
                     a SUM all-reduce (global statistics)

Under gloo with CUDA tensors (ranks sharing one card) every exchange is
staged through host copies, as `mesh._host_staged` does. A bfloat16
tensor is exchanged bit for bit as its bytes, a uint8 view (never
upcast), so no exchange depends on a backend's bfloat16 support (gloo
refuses int16). `EXCHANGES` counts the
collectives each primitive runs, by kind ("halo", "gather", "sum"), as
the kernel wrappers count their launches.

A `Strip` is rows [lo, hi) of a plane, every one of them the whole
forward's value: the rank's rows and the rows of its neighbours that a
halo brought in (`strip_of`). An operation on it keeps the rows it can
still compute exactly and drops the rest, so one deep halo serves a
chain of operations without a global one inside (ROADMAP C.10's
argument for LightNet's B9): a chain of k 3x3 convs (`Strip.chain`,
each conv zero-padding along H as the whole forward does: exact at the
image's own edges, wrong only in the k rows next to a neighbour's, which
are dropped), a bicubic or bilinear resample (`Strip.resample`: the
output rows whose taps lie in the strip), a max-pool on its grid and a
nearest upsample (`Strip.rescale`). `Strip.own` is the rank's rows.

Each forward, per operation (the rank holds rows [a, b) of H):

- bicubic resamples (`Resample`, `sampling`): a halo of 2 source rows,
  "none" at the edges; a strip of a downsample by q starts on a multiple
  of q (its halo is 2 rounded up to q), so each local output row maps to
  the global row's source coordinate and taps, and the strip's output is
  the global output's rows bit for bit; bilinear ones
  (`resample_rows(mode="bilinear")`) the same on 1 row;
- a k x k conv (`DepConv`): a "zero" halo of k // 2 rows, then the conv
  unpadded along H;
- 1x1 convs, the channel LN, the patch embed: local;
- Wavelet: interp23 applies dense wrap matrices over the whole H, so the
  LrMS (small) is gathered and the rank's rows of the upsample computed
  (`interp23_upsample(rows=)`); the level-2 Haar transforms are local
  when the rank's rows are a multiple of 4;
- SFIM: the means and variances of PAN and u_hs over H x W in its
  two-pass form (the mean first, then the sum of squared deviations),
  each sum an all-reduce; the circular k x k box filter takes a "wrap"
  halo of k // 2 rows;
- LightNet: the two bicubic x2 resamples, then `lightnet_stack` (B9) on
  the rank's rows with a "none" halo of 10 rows (its ten depthwise
  layers: the kernel zeroes outside its input on each, ROADMAP C.10, so
  the rows it gets wrong stay inside the halo), cropped;
- UnlgFormer (`LGTEUN`, every fuse level, `LGTEUN_FUSED_ATTENTION=v2`,
  float32 and both bf16 storage modes, `storage` passed down as
  `LGB.forward` takes it): the unfolding steps' x4 resample of ms, D, DT
  (resamples and 3x3 `DepConv`s as above), R and RT (1x1). In the prior
  each LGB block all-gathers its input x (a bfloat16 stream in the "bf16"
  mode) and runs the mixer on the whole plane on every rank (the FFT
  mixer is global over the plane: exact, and redundant; a distributed
  FFT is ROADMAP A.9.3; so B1, B4 and B8 take every plane the whole
  forward takes, odd sides and prime factors above 512 included, by the
  route of the whole plane's shape, with no change here): at level 2 B1
  `ln_mixer_head`, then the local
  mixer (B2 `window_attention`, or B6 on the strip's windows under v2)
  on the strip of y1 from rows a and b rounded out to the 8-row window
  grid plus one window band on each side (windows stay fixed in the
  global grid), B3 `block_tail` on the same strip of x, x1, x2 (its
  FFN's 3x3 depthwise conv needs 1 row, and the strip is a multiple of
  8 rows), cropped to [a, b); at level 1 the LN of the whole plane, B4
  `global_mixer` on its second half, the local mixer on the strip of the
  first, the proj and residual on the strip, B5 `ln_ffn` on the strip
  (its 3x3 depthwise conv inside the band), cropped. At level 3 the
  blocks are replicated, not sharded: B8 `lgb_block` computes a whole
  block, its global mixer included, in one launch, so each LGB
  all-gathers its input once and every rank runs its blocks on the
  whole plane, then keeps its rows (JAX's GSPMD replicates a Pallas call
  it cannot partition in the same way); the unfolding steps and the
  resamples and convs between the LGBs stay sharded.
- MDCUN (`PanUnfolding`): one PAN halo of 16 rows (`PAN_HALO`) serves the
  high-pass pyramid (each x1/q bicubic strip starts on a multiple of q =
  2, 4, 8 and keeps the 2 rows its x q upsample back needs) and the
  spatial attention's PAN; the x4 bilinear `x` on a 1-row halo; each
  stage takes one halo of 12 rows (`STAGE_HALO`) of its dense inputs
  and x, which serves `conv_u` and `rm1` (two and eight 3x3 convs;
  AttSpatial's channel max / mean are local), B12 `neighborhood_attention` on x's rows
  within 7 of the rank's (the kernel zero-pads phi and g outside its
  input, ROADMAP C.12: only the dropped rows see that), and the down
  resampler (3x3 conv, ReLU, MaxPool2d(4) on the 4-row grid, two 3x3
  convs at 1/4 resolution); one halo of 12 rows of the v side and nl;
  the up resampler on a 2-row halo at 1/4 resolution (3x3 conv, ReLU,
  nearest x4, two 3x3 convs); the stage update is elementwise, with ms
  on the rank's 1/4 rows.
- INNT (`GPPNNINNT`): m_hr, the bicubic align_corners=True x4 of ms,
  from the gathered LrMS for the rank's rows and 2 more each side
  (`bicubic_rows`: its source coordinate y (h - 1) / (H - 1) is not on
  the strip grid; summed in float64, within the whole float32 op's own
  rounding, ROADMAP C.20's 2e-5); `convpan` on a
  2-row PAN halo, `convms`, `conv_fusion`; then `PatchFusion`: mhrf and
  panf all-gathered (the two halves of n_feat, each n_feat / 2 channels
  at full resolution), the rank's contiguous share of the N = B L
  scrambled patch-images built from strided slices of the padded plane
  (`scrambled_patches`: each patch-image is a block of rows of the
  24 x 24 / stride-8 unfold, read through the reference's plain view,
  ROADMAP C.16; the whole unfold is never made), `TransformerFusion` on
  the share (B10 `texture_match`, or B11 `patch_match` with its 3x3
  unfold and fold under LGTEUN_FUSED_TM=0, and `conv_trans`: local to
  each patch-image), the fused patch-images all-gathered (every rank's
  share padded to the largest, a ragged last share trimmed: 4 N C 576
  bytes arrive on each rank in float32, (s - 1) / s of them from the
  others), and the fold of only the patch rows that reach the rank's
  rows (`fold_rows`). `_FeatureExtract`: each InvBlock takes one 8-row
  halo (its 1x1 invertible conv is local; F, then H and G, are chains
  of four 3x3 convs with two instance norms of whole-plane statistics
  each, `instance_norm_rows`: population variance, eps 1e-5, two
  passes; H's and G's sums share each all-reduce); `Refine` one 3-row
  halo, the CALayer's mean all-reduced.
- MDCUN and INNT under the blanket cast: the same forwards in bfloat16,
  B12's bf16 entry on x's strip (4 launches a forward), B10's or B11's
  on the rank's share (1); m_hr's float64 sums round to float32 and then
  to bfloat16, as the whole cast forward's float32 resize rounds.
- LightNet's tap path: the resamples as above, the bf16 stack of plain
  taps on the same 10-row "none" halo (each depthwise conv zero-pads its
  input), cropped.
- GSA: the LrMS gathered (interp23's rows, and the low-resolution design
  whole), the PAN's x1/4 bicubic on a strip on its grid, gathered
  ([B, 1, h, w]: small); alpha by `lstsq_min_norm` of the gathered
  design on every rank (the same bits on each); every mean, cov and
  var_i0 from all-reduced sums, centred first where the whole op
  centres.
- MutInf (`GPPNNMutInf`, the HrMS it returns first): m_hr by
  `bicubic_rows` on the rank's rows and 6 more each side; the two
  `_FeatureExtract`s (a 1x1, two edge blocks of three 3x3 convs deep,
  CDC's five-tap 3x3 beside) on one 6-row halo each; each InvBlock's
  `_DenseBlockMscale`s (F, then H and G in lockstep) take x at 1/2 and
  1/4 from the bilinear downsample of the rank's own rows (its taps lie
  inside a strip on the scale's grid), the dense block (two HIN blocks,
  a 3x3 over the dense concat: five 3x3 convs) at each scale on one
  halo of 5 rows (1x) or 6 (1/2, 1/4: one more for the bilinear way back
  up), where the neighbours' strips hold that many, else a halo before
  each of its three stages (`_reach`); the instance norms of every block
  and scale in one all-reduce a pass, the pooled gate's mean in one;
  `Refine` (two CALayers) as INNT's. A rank takes a multiple of 4 PAN
  rows, at least 8.
- SFIIN: m_hr as MutInf's (1 row each side), `conv_p` on it, `conv_p1` on a
  1-row PAN halo; each `SpaFre`: `panprocess` on a 1-row halo, msf and
  panf all-gathered in one collective, `FreProcess` on the whole planes
  on every rank (its FFT is global: exact, and redundant, as B1's
  gathered plane), the spatial branch (the InvBlock, five 3x3 convs for
  F and for H / G, then a 1x1), `spa_att` and `post` on a strip of the
  gathered planes (13 rows each side), the channel mean and population
  contrast from all-reduced sums, two passes; `fuse`, `Refine`.
- PanFormer (`CrossSwinTransformer`; NHWC inside): the patch merges
  local; regular windows local; a shifted block rolls the plane up by
  d = w / 2 first (a "wrap" halo of d rows from the rank below, x's and,
  in a cross block, y's in one exchange; the roll along W is local),
  takes the upper/lower mask only on the image's last band of windows
  (the rank that holds it: a strip's mask is built for its place in the
  global grid), and rolls back down after (a "wrap" halo of d rows from
  the rank above); `HR_tail` (3x3 convs around two PixelShuffles) on one
  2-row halo at the ms grid (1 + 1/2 + 1/4 + 1/4 rows), the clamp last.
  A rank's feature rows must be whole windows: a multiple of 4 w PAN
  rows (16 at the shipped window 4).

Refused with a ValueError that names ROADMAP A.9.3 (never by gathering
the input and running the whole forward): an H that the space size does
not divide, strips off a method's grid (Wavelet's not a multiple of 4
rows, MutInf's not starting on the 1/4 grid, PanFormer's not whole
windows), a halo deeper than a neighbour's strip (a deep halo needs
strips of at least its depth: 16 PAN rows a rank for MDCUN, 8 for
MutInf), and a call with gradients on (an input that requires a
gradient, or a module in training mode): these are eval forwards. A
module of no registered method has no sharded forward and is refused
too.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.base import ClassicalMethod, TorchMethod, _nchw
from lgteun_tpu_torch.models.classical import (gsa_fuse, lstsq_min_norm,
                                               sfim_fuse, wavelet_fuse,
                                               wavelet_inject)
from lgteun_tpu_torch.models.common.layers import Resample
from lgteun_tpu_torch.models.common.swin import _window_mask
from lgteun_tpu_torch.models.innt import _PAD, _PATCH, _STRIDE, GPPNNINNT
from lgteun_tpu_torch.models.lgteun import LGTEUN
from lgteun_tpu_torch.models.lightnet import LightNetModule, tap_stack
from lgteun_tpu_torch.models.mdcun import PanUnfolding
from lgteun_tpu_torch.models.mutinf import GPPNNMutInf
from lgteun_tpu_torch.models.panformer import CrossSwinTransformer
from lgteun_tpu_torch.models.sfiin import _BLOCKS, SFIINNet
from lgteun_tpu_torch.ops import upcast
from lgteun_tpu_torch.ops.ffn_kernel import block_tail, ln_ffn
from lgteun_tpu_torch.ops.filters import depthwise_conv2d
from lgteun_tpu_torch.ops.interp23 import interp23_upsample
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block
from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_stack
from lgteun_tpu_torch.ops.norm import channel_layer_norm
from lgteun_tpu_torch.ops.resize import sample_scale
from lgteun_tpu_torch.ops.spectral_kernel import global_mixer, ln_mixer_head
from lgteun_tpu_torch.parallel.mesh import (Mesh, _all_reduce_,
                                            _host_staged, all_gather_rows)

__all__ = ["SpatialSharding", "spatial_sharding", "run_spatially_sharded",
           "gather_h", "halo_rows", "edge_rows", "all_gather_h",
           "space_sum", "space_mean", "resample_rows", "conv_rows",
           "window_strip", "Strip", "strip_of", "bicubic_rows",
           "instance_norm_rows",
           "scrambled_patches", "fold_rows", "EDGES", "PAN_HALO",
           "STAGE_HALO", "EXCHANGES"]

EDGES = ("zero", "none", "wrap")
PAN_HALO = 16       # MDCUN's PAN strip: the x1/8 pyramid level and back
STAGE_HALO = 12     # MDCUN's stage strip: the down resampler's depth
_TAPS = {"bicubic": (1, 2), "bilinear": (0, 1)}  # rows below / above a tap
_QUEUE = "ROADMAP A.9.3"
EXCHANGES = collections.Counter()   # collectives run, by kind


def _refuse(what: str) -> ValueError:
    return ValueError(f"run_spatially_sharded: {what} ({_QUEUE})")


@dataclass(frozen=True)
class SpatialSharding:
    """The rank's block of an NHWC array: H over the mesh's `space` axis,
    the batch over `data` (`batch_axis` "data") or on every rank
    (None)."""

    mesh: Mesh
    batch_axis: str | None = None

    def h_rows(self, h: int) -> slice:
        """The rank's rows of an H of h."""
        s = self.mesh.space_world
        if h % s:
            raise _refuse(f"H {h} does not divide by the space size {s}")
        per = h // s
        return slice(self.mesh.space_rank * per,
                     (self.mesh.space_rank + 1) * per)

    def batch_rows(self, n: int) -> slice:
        """The rank's batch rows of a batch of n."""
        if self.batch_axis is None:
            return slice(0, n)
        d = self.mesh.data_world
        if n % d:
            raise ValueError(f"batch {n} does not divide by the data size "
                             f"{d}")
        per = n // d
        return slice(self.mesh.data_rank * per,
                     (self.mesh.data_rank + 1) * per)

    def place(self, a):
        """The rank's block of NHWC `a` (numpy array or tensor)."""
        return a[self.batch_rows(a.shape[0]), self.h_rows(a.shape[1])]


def spatial_sharding(mesh: Mesh, batch_axis: str | None = None,
                     space_axis: str = "space") -> SpatialSharding:
    """NHWC sharding: batch over `batch_axis` (None or "data"), H over
    `space_axis` ("space", the port's one height axis)."""
    if space_axis != "space" or batch_axis not in (None, "data"):
        raise ValueError(f"axes batch={batch_axis!r}, H={space_axis!r}: "
                         "the port's mesh has 'data' and 'space'")
    return SpatialSharding(mesh, batch_axis)


# ------------------------------------------------------------ primitives

def _bits(t: torch.Tensor) -> torch.Tensor:
    """t as an exchange carries it: a bfloat16 tensor as its bytes (a
    uint8 view of its contiguous copy, its last dimension doubled)."""
    return (t.contiguous().view(torch.uint8) if t.dtype == torch.bfloat16
            else t)


def _unbits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def edge_rows(mesh: Mesh, above: int, below: int,
              edge: str) -> tuple[int, int]:
    """The rows `halo_rows` puts above and below the rank's strip."""
    if edge not in EDGES:
        raise ValueError(f"edge {edge!r} is not one of {EDGES}")
    j, s = mesh.space_rank, mesh.space_world
    none = edge == "none"
    return (0 if none and j == 0 else above,
            0 if none and j == s - 1 else below)


def halo_rows(x: torch.Tensor, above: int, below: int, mesh: Mesh,
              edge: str) -> torch.Tensor:
    """x [..., h, W] with `above` rows of the rank above and `below` rows
    of the rank below around it, along H (dim -2); at the image's top and
    bottom as `edge` says (module docstring)."""
    if edge not in EDGES:
        raise ValueError(f"edge {edge!r} is not one of {EDGES}")
    h = x.shape[-2]
    if max(above, below) > h:
        raise _refuse(f"a halo of {max(above, below)} rows over strips of "
                      f"{h} rows reaches past the neighbouring rank")
    j, s = mesh.space_rank, mesh.space_world
    wrap = edge == "wrap"
    # the space index whose rows come in above / below, None at an edge
    src_above = j - 1 if j > 0 else (s - 1 if wrap else None)
    src_below = j + 1 if j < s - 1 else (0 if wrap else None)
    # and the space index whose top / bottom halo this rank's rows are
    dst_down = j + 1 if j < s - 1 else (0 if wrap else None)
    dst_up = j - 1 if j > 0 else (s - 1 if wrap else None)
    top = bottom = None
    if s == 1:  # its own neighbour ("wrap")
        if wrap:
            top, bottom = x[..., h - above:, :], x[..., :below, :]
    else:
        staged = _bits(_host_staged(mesh, x))
        ops, got = [], {}

        def p2p(op, t, peer, tag):
            ops.append(dist.P2POp(op, t, mesh.space_peer(peer),
                                  mesh.space_group, tag))

        # one order on every rank: the rows going down (a top halo), then
        # the rows going up (a bottom halo), each send before its recv
        for key, n, rows, dst, src, tag in (
                ("top", above, staged[..., h - above:, :], dst_down,
                 src_above, 0),
                ("bottom", below, staged[..., :below, :], dst_up, src_below,
                 1)):
            if n and dst is not None:
                p2p(dist.isend, rows.contiguous(), dst, tag)
            if n and src is not None:
                got[key] = staged.new_empty((*x.shape[:-2], n, staged.shape[-1]))
                p2p(dist.irecv, got[key], src, tag)
        if ops:
            EXCHANGES["halo"] += 1
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        top, bottom = (_unbits(got[k], x.dtype).to(x.device) if k in got
                       else None for k in ("top", "bottom"))
    if edge == "zero":
        zeros = lambda n: x.new_zeros((*x.shape[:-2], n, x.shape[-1]))
        top = zeros(above) if top is None else top
        bottom = zeros(below) if bottom is None else bottom
    return torch.cat([t for t in (top, x, bottom) if t is not None], dim=-2)


def all_gather_h(x: torch.Tensor, mesh: Mesh, dim: int = -2) -> torch.Tensor:
    """Every space rank's strip of x, concatenated along `dim` in rank
    order, on x's device; x itself without a space group."""
    if mesh.space_group is None:
        return x
    src = _bits(_host_staged(mesh, x).contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.space_world)]
    EXCHANGES["gather"] += 1
    dist.all_gather(parts, src, group=mesh.space_group)
    return _unbits(torch.cat(parts, dim=dim), x.dtype).to(x.device)


def space_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The SUM of t over the space group (t itself without one)."""
    if mesh.space_group is None:
        return t
    EXCHANGES["sum"] += 1
    return _all_reduce_(t.contiguous(), mesh, group=mesh.space_group)


def resample_rows(x: torch.Tensor, factor: float, mesh: Mesh,
                  mode: str = "bicubic") -> torch.Tensor:
    """`sample_scale(x, factor, mode)` (bicubic or bilinear,
    align_corners False) of the rank's rows of x [B, C, h, W]: a halo of
    the taps' reach (2 or 1 source rows; a x1/q downsample's rounded up
    to q, so that its strip starts on its grid), the rank's rows of the
    whole plane's resample (module docstring)."""
    if factor == 1:
        return x
    halo = max(_TAPS[mode])
    if factor < 1:
        q = round(1 / factor)
        halo = -(-halo // q) * q
    return strip_of(x, halo, mesh).resample(factor, mode).own(mesh)


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A 'same' conv (zero padding k // 2) of the rank's rows of x."""
    pad = conv.kernel_size[0] // 2
    if not pad:
        return conv(x)
    x = halo_rows(x, pad, pad, mesh, "zero")
    return F.conv2d(x, conv.weight, conv.bias, padding=(0, conv.padding[1]),
                    groups=conv.groups)


def _sequence(seq, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """An nn.Sequential of `Resample`s and convs on the rank's rows."""
    for layer in seq:
        if isinstance(layer, Resample):
            x = resample_rows(x, layer.s_factor, mesh)
        elif isinstance(layer, nn.Conv2d):
            x = conv_rows(layer, x, mesh)
        else:
            raise _refuse(f"no height-sharded form of {type(layer).__name__}")
    return x


def window_strip(a: int, b: int, h: int, win: int) -> tuple[int, int]:
    """Rows [lo, hi) of an H of h around the rank's rows [a, b): rounded
    out to the win-row window grid, one window band more on each side,
    clipped to the image."""
    return (max(0, a // win * win - win),
            min(h, -(-b // win) * win + win))


# ---------------------------------------------------------------- strips

def _own(mesh: Mesh, h: int) -> tuple[int, int]:
    """The rank's rows [a, b) of a plane of h rows."""
    per = h // mesh.space_world
    return mesh.space_rank * per, (mesh.space_rank + 1) * per


@dataclass
class Strip:
    """Rows [lo, hi) of a plane of `h` rows (H at dim -2 of `t`), each of
    them the whole forward's value (module docstring)."""

    t: torch.Tensor
    lo: int
    hi: int
    h: int

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of the plane, which the strip must hold."""
        if lo < self.lo or hi > self.hi:
            raise _refuse(f"rows [{lo}, {hi}) of a strip of [{self.lo}, "
                          f"{self.hi}): the halo was too shallow for the "
                          "operations on it")
        return self.t[..., lo - self.lo:hi - self.lo, :]

    def crop(self, lo: int, hi: int) -> "Strip":
        return Strip(self.rows(lo, hi), lo, hi, self.h)

    def own(self, mesh: Mesh) -> torch.Tensor:
        """The rank's rows."""
        return self.rows(*_own(mesh, self.h))

    def map(self, fn) -> "Strip":
        """An operation on each pixel (or each row) alone."""
        return Strip(fn(self.t), self.lo, self.hi, self.h)

    def chain(self, fn, depth: int) -> "Strip":
        """fn, which keeps H and zero-pads along H at the strip's ends (a
        chain of `depth` 3x3 convs, or a window of radius `depth`): the
        `depth` rows next to each end that is not the image's are wrong
        after it and dropped."""
        lo = self.lo + (depth if self.lo > 0 else 0)
        hi = self.hi - (depth if self.hi < self.h else 0)
        return Strip(fn(self.t.contiguous()), self.lo, self.hi,
                     self.h).crop(lo, hi)

    def resample(self, factor: float, mode: str = "bicubic") -> "Strip":
        """`sample_scale(., factor, mode)` (align_corners False): the
        output rows whose taps lie in the strip or are clamped at the
        image's own edge; a downsample's strip must start on its grid."""
        if factor < 1:
            q = round(1 / factor)
            if self.lo % q or (self.hi % q and self.hi != self.h):
                raise _refuse(f"a x1/{q} resample of rows [{self.lo}, "
                              f"{self.hi}): a strip must start on a "
                              f"multiple of {q}")
        y = sample_scale(self.t, factor, mode)
        start = round(self.lo * factor)
        # each output row's source coordinate, as torch computes it
        src = (np.arange(start, start + y.shape[-2]) + 0.5) / factor - 0.5
        if mode == "bilinear":   # a linear source index is clamped at 0
            src = np.maximum(src, 0.0)
        base = np.floor(src).astype(np.int64)
        below, above = _TAPS[mode]
        ok = (((base - below >= self.lo) | (self.lo == 0))
              & ((base + above < self.hi) | (self.hi == self.h)))
        kept = np.flatnonzero(ok)
        return Strip(y, start, start + y.shape[-2],
                     round(self.h * factor)).crop(
            start + int(kept[0]), start + int(kept[-1]) + 1)

    def rescale(self, layer: nn.Module) -> "Strip":
        """`nn.MaxPool2d(k)` (the strip cut to the k-row grid first),
        `nn.Upsample(scale_factor=k)` (nearest) or `nn.PixelShuffle(k)`
        of the strip."""
        if isinstance(layer, nn.MaxPool2d):
            k = layer.kernel_size
            lo, hi = -(-self.lo // k) * k, self.hi // k * k
            return Strip(layer(self.rows(lo, hi)), lo // k, hi // k,
                         self.h // k)
        if isinstance(layer, nn.PixelShuffle):
            k = layer.upscale_factor
            return Strip(layer(self.t), self.lo * k, self.hi * k, self.h * k)
        k = int(layer.scale_factor)
        if layer.mode != "nearest":
            raise _refuse(f"no height-sharded form of {layer.mode} "
                          "nn.Upsample")
        return Strip(layer(self.t), self.lo * k, self.hi * k, self.h * k)

    @staticmethod
    def cat(strips: list, dim: int = 1) -> "Strip":
        """The strips' common rows, concatenated along `dim`."""
        lo = max(s.lo for s in strips)
        hi = min(s.hi for s in strips)
        return Strip(torch.cat([s.rows(lo, hi) for s in strips], dim=dim),
                     lo, hi, strips[0].h)

    def split(self, n: int) -> tuple["Strip", "Strip"]:
        """Channels [:n] and [n:]."""
        return (self.map(lambda t: t[:, :n]), self.map(lambda t: t[:, n:]))


def strip_of(x: torch.Tensor, depth: int, mesh: Mesh) -> Strip:
    """The rank's rows x [..., h, W] with `depth` rows of each neighbour
    ("none" at the image's edges): one halo exchange."""
    h = x.shape[-2] * mesh.space_world
    a, b = _own(mesh, h)
    top, bottom = edge_rows(mesh, depth, depth, "none")
    return Strip(halo_rows(x, depth, depth, mesh, "none"), a - top,
                 b + bottom, h)


_CUBIC_A = -0.75


def _cubic_weights(t: torch.Tensor) -> list[torch.Tensor]:
    """torch's bicubic tap weights (a = -0.75) at fraction t."""
    a = _CUBIC_A
    far = lambda x: ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    near = lambda x: ((a + 2) * x - (a + 3)) * x * x + 1
    return [far(t + 1), near(t), near(1 - t), far(2 - t)]


def bicubic_rows(x: torch.Tensor, out_hw: tuple[int, int], lo: int,
                 hi: int) -> torch.Tensor:
    """Rows [lo, hi) of `resize_bicubic(x, out_hw, align_corners=True)`
    of the whole plane x [B, C, h, w]: each row from its own source
    coordinate y (h - 1) / (H - 1) (in float32, as torch computes it)
    and four clamped taps of x, then the columns by `F.interpolate` (its
    rows left as they are). The taps and weights are the whole op's; the
    sums run in float64 and round once, so the rows lie within the whole
    float32 op's own rounding of it (ROADMAP C.20)."""
    h = x.shape[-2]
    big_h, big_w = out_hw
    scale = torch.tensor((h - 1) / (big_h - 1) if big_h > 1 else 0.0,
                         dtype=torch.float32, device=x.device)
    src = scale * torch.arange(lo, hi, dtype=torch.float32, device=x.device)
    base = torch.floor(src)
    weights = _cubic_weights(src - base)
    base = base.long()
    x64 = x.double()
    out = None
    for k, wk in enumerate(weights):
        term = x64[..., (base - 1 + k).clamp(0, h - 1), :] * wk.double()[
            :, None]
        out = term if out is None else out + term
    # float32 first: a bfloat16 x (the blanket cast) rounds as the whole
    # op's float32 resize does, twice
    return F.interpolate(out, size=(hi - lo, big_w), mode="bicubic",
                         align_corners=True).float().to(x.dtype)


def instance_norm_rows(parts: list, mesh: Mesh) -> list:
    """[(norm, strip)] -> each strip through its `nn.InstanceNorm2d`
    (affine; population variance) with the statistics of the whole
    plane: the rank's rows summed, all-reduced, in two passes (the means,
    then the squared deviations from them), every part's sums in one
    all-reduce a pass; the strip's other rows normalised by the same
    statistics."""
    own = [upcast(s.own(mesh)) for _, s in parts]
    counts = [o.shape[-2] * mesh.space_world * o.shape[-1] for o in own]
    widths = [o.shape[1] for o in own]
    total = lambda ts: torch.split(space_sum(torch.cat(
        [t.sum(dim=(2, 3)) for t in ts], dim=1), mesh), widths, dim=1)
    means = [s / n for s, n in zip(total(own), counts)]
    dev = total([(o - m[:, :, None, None]) ** 2 for o, m in zip(own, means)])
    out = []
    for (norm, s), m, d, n in zip(parts, means, dev, counts):
        inv = torch.rsqrt(d / n + norm.eps)
        out.append(s.map(lambda t, m=m, inv=inv, norm=norm: (
            (upcast(t) - m[:, :, None, None]) * inv[:, :, None, None]
            * upcast(norm.weight)[None, :, None, None]
            + upcast(norm.bias)[None, :, None, None]).to(t.dtype)))
    return out


def space_mean(t: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The mean over H and W of the whole plane of n pixels from the
    rank's rows t [B, C, h, W]: float32 partial sums (a bfloat16 t
    upcast), all-reduced, then rounded once to t's dtype, as torch's
    bfloat16 mean accumulates in float32 and rounds once."""
    total = space_sum(upcast(t).sum(dim=(2, 3), keepdim=True), mesh)
    return (total / n).to(t.dtype)


def scrambled_patches(x: torch.Tensor, n0: int, n1: int) -> torch.Tensor:
    """Patch-images [n0, n1) of `PatchFusion`'s scramble of x [B, C, H,
    W]: the 24 x 24 / stride-8 / padding-8 unfold [B, C 576, L] read as
    [B L, C, 24, 24] by a plain view (ROADMAP C.16), built without the
    whole unfold: patch-image n is flat elements [n C 576, (n + 1) C 576)
    of the unfold, and element (f, l) of it, f = (c, kh, kw), l = (ph,
    pw), is the padded plane's pixel (c, 8 ph + kh, 8 pw + kw)."""
    b, c, h, w = x.shape
    k, st, p = _PATCH, _STRIDE, _PAD
    lw = (w + 2 * p - k) // st + 1
    length = ((h + 2 * p - k) // st + 1) * lw
    per = c * k * k
    g = torch.arange(n0 * per, n1 * per, device=x.device)
    img, rem = g // (per * length), g % (per * length)
    f, l = rem // length, rem % length
    row = l // lw * st + f // k % k
    col = l % lw * st + f % k
    xp = F.pad(x, (p, p, p, p))
    idx = ((img * c + f // (k * k)) * (h + 2 * p) + row) * (w + 2 * p) + col
    return xp.reshape(-1)[idx].view(n1 - n0, c, k, k)


def fold_rows(cols: torch.Tensor, out_hw: tuple[int, int], a: int,
              b: int) -> torch.Tensor:
    """Rows [a, b) of `PatchFusion`'s fold (`fold_patches(cols, out_hw,
    24, 8, 8)`, overlaps summed) of cols [B, C 576, L]: the fold of only
    the patch rows that reach them, each row's contributions added in
    the whole fold's order."""
    k, st, p = _PATCH, _STRIDE, _PAD
    h, w = out_hw
    lh = (h + 2 * p - k) // st + 1
    lw = (w + 2 * p - k) // st + 1
    ph0 = max(0, -(-(a + p - k + 1) // st))
    ph1 = min(lh - 1, (b - 1 + p) // st)
    top = ph0 * st - p       # the first output row of the partial fold
    part = F.fold(cols[..., ph0 * lw:(ph1 + 1) * lw],
                  ((ph1 - ph0) * st + k, w), k, padding=(0, p), stride=st)
    return part[..., a - top:b - top, :]


# -------------------------------------------------------------- forwards

def _lgb(lgb, x: torch.Tensor, mesh: Mesh,
         storage: torch.dtype | None = None) -> torch.Tensor:
    """`LGB.forward(x, storage=storage)` (eval) on the rank's rows, at
    the LGB's level (module docstring)."""
    h = x.shape[-2]
    a = mesh.space_rank * h
    if lgb.level >= 3:       # replicated blocks: one gather, every block
        whole = all_gather_h(x, mesh)
        for i, (mix_res, _) in enumerate(lgb.blocks):
            whole = lgb_block(whole, lgb._params(i), lgb.heads, lgb.win,
                              mix_res.fn.norm.eps, storage)
        return whole[..., a:a + h, :]
    lo, hi = window_strip(a, a + h, h * mesh.space_world, lgb.win)
    strip = lambda t: t[..., lo:hi, :].contiguous()
    for i, (mix_res, _) in enumerate(lgb.blocks):
        eps = mix_res.fn.norm.eps
        blk = lgb._params(i)
        mixer = [blk[k] for k in ("amp_w", "amp_b", "pha_w", "pha_b")]
        whole = all_gather_h(x, mesh)
        if lgb.level == 1:
            y = channel_layer_norm(upcast(whole), blk["ln_w"], blk["ln_b"],
                                   eps)
            c2 = x.shape[1] // 2
            y1 = y[:, :c2] if storage is None else y[:, :c2].to(storage)
            x1 = lgb._local_mixer(strip(y1), blk)
            x2 = global_mixer(y[:, c2:].contiguous(), *mixer,
                              out_dtype=storage)
            mixed = F.conv2d(upcast(torch.cat([x1, strip(x2)], dim=1)),
                             blk["proj_w"][:, :, None, None], blk["proj_b"])
            out = ln_ffn((upcast(strip(whole)) + mixed).to(x.dtype),
                         blk["ffn"], eps=eps)
        else:
            y1, x2 = ln_mixer_head(whole, blk["ln_w"], blk["ln_b"], *mixer,
                                   eps=eps, out_dtype=storage)
            x1 = lgb._local_mixer(strip(y1), blk)
            out = block_tail(strip(whole), x1, strip(x2), blk["proj_w"],
                             blk["proj_b"], blk["ffn"], eps=eps)
        x = out[..., a - lo:a - lo + h, :]
    return x


def _lgt(lgt, z: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`LGT.forward` (eval, in its storage mode) on the rank's rows."""
    sdtype, res_f32 = lgt.storage
    fea = lgt.patch_embed(z)
    if sdtype is not None and not res_f32:
        fea = fea.to(sdtype)
    skips = []
    for lgb, down in lgt.encoder_layers:
        fea = _lgb(lgb, fea, mesh, sdtype)
        skips.append(fea)
        fea = _sequence(down, fea, mesh)
    fea = _lgb(lgt.bottleneck, fea, mesh, sdtype)
    for up, fuse, lgb in lgt.decoder_layers:
        fea = fuse(torch.cat([_sequence(up, fea, mesh), skips.pop()], dim=1))
        fea = _lgb(lgb, fea, mesh, sdtype)
    return _sequence(lgt.tail, upcast(fea), mesh) + z


def lgteun_rows(module: LGTEUN, ms: torch.Tensor, pan: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """`LGTEUN.forward` (eval; any fuse level, v2, any storage mode) on
    the rank's rows of ms [B, C, h, w] and pan [B, 1, 4h, 4w]."""
    z = resample_rows(ms, 4, mesh)
    for eta in module.eta:
        ms_term = _sequence(module.DT, _sequence(module.D, z, mesh) - ms,
                            mesh)
        pan_term = module.RT(module.R(z) - pan)
        z = z - eta * (ms_term + pan_term)
    return _lgt(module.prior_module[module.stage - 1], z, mesh)


def lightnet_rows(module: LightNetModule, ms: torch.Tensor,
                  pan: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`LightNetModule.forward` (float32, B9) on the rank's rows."""
    spans = module.spans()
    lms = resample_rows(resample_rows(ms, 2, mesh), 2, mesh)
    weights = [s.weights() for s in spans]
    depth = len(spans)   # one 3x3 depthwise conv a span on each branch
    return strip_of(torch.cat([pan, lms], dim=1), depth, mesh).chain(
        lambda x: lightnet_stack(x, x[:, 1:].contiguous(), weights),
        depth).own(mesh)


def lightnet_tap_rows(module: LightNetModule, ms: torch.Tensor,
                      pan: torch.Tensor, mesh: Mesh,
                      dtype: torch.dtype) -> torch.Tensor:
    """`lightnet_fast_forward` (the bf16 tap path, the stack in `dtype`)
    on the rank's rows: the resamples as `lightnet_rows`, the stack on
    the same 10-row "none" halo (each depthwise conv zero-pads its
    input, so the rows it gets wrong stay inside the halo), cropped."""
    lms = resample_rows(resample_rows(ms, 2, mesh), 2, mesh)
    depth = len(module.spans())
    x = strip_of(torch.cat([pan, lms], dim=1).to(dtype), depth, mesh)
    stack = x.chain(lambda t: tap_stack(module, t, dtype), depth)
    return lms + stack.own(mesh).to(lms.dtype)


def _mdcun_gates(module: PanUnfolding, feat: Strip, pan: Strip,
                 mesh: Mesh) -> torch.Tensor:
    """The rank's rows of `rm1`'s gates of `_denoise(feat)`: the first
    four bands folded into the batch beside the PAN, AttSpatial's eight
    3x3 convs on the strip."""
    b = feat.t.shape[0]
    pairs = Strip.cat([feat.map(lambda t: t[:, :4].transpose(0, 1).reshape(
        4 * b, 1, *t.shape[2:])), pan.map(lambda t: t.repeat(4, 1, 1, 1))])
    return pairs.chain(module.rm1, 8).own(mesh)


def _mdcun_decode(module: PanUnfolding, feat: Strip, pan: Strip,
                  pan_hp: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's rows of `_denoise(feat, pan, pan_hp) + feat`."""
    b = feat.t.shape[0]
    gates = _mdcun_gates(module, feat, pan, mesh)
    decoded = pan_hp + gates.reshape(4, b, *gates.shape[2:]).transpose(
        0, 1) * pan_hp
    if feat.t.shape[1] > 4:
        decoded = module.conv1x1(decoded)
    return decoded + feat.own(mesh)


def _mdcun_down(res, x: Strip, mesh: Mesh) -> torch.Tensor:
    """The rank's 1/4 rows of `_Resampler` (down) of the strip x."""
    y = x.chain(res.body, 1).rescale(res.tail[0])
    return y.chain(res.tail[1:], 2).own(mesh)


def _mdcun_up(res, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's rows of `_Resampler` (up) of its 1/4 rows x."""
    y = strip_of(x, 2, mesh).chain(res.body, 1).rescale(res.tail[0])
    return y.chain(res.tail[1:], 2).own(mesh)


def mdcun_rows(module: PanUnfolding, ms: torch.Tensor, pan: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """`PanUnfolding.forward` (MDCUN, float32) on the rank's rows of ms
    [B, C, h, w] and pan [B, 1, 4h, 4w] (module docstring)."""
    pan_s = strip_of(pan, PAN_HALO, mesh)
    a, b = _own(mesh, pan_s.h)
    hps = [pan_s.rows(a, b) - pan_s.resample(1 / q).resample(q).rows(a, b)
           for q in (2, 4, 8)]
    pan_hp = module.hf_pan(torch.cat(hps, dim=1))
    x = resample_rows(ms, 4, mesh, mode="bilinear")
    c = x.shape[1]
    uk_list: list[torch.Tensor] = []
    vk_list: list[torch.Tensor] = []
    for i in range(module.stages):
        us = strip_of(torch.cat(uk_list + [x], dim=1), STAGE_HALO, mesh)
        xs = us.map(lambda t: t[:, -c:])
        decode_u = _mdcun_decode(module, us.chain(module.conv_u[i], 2),
                                 pan_s, pan_hp, mesh)
        uk_list.append(decode_u)
        near = module.NLBlock.fs // 2
        nl = xs.crop(max(a - near, 0), min(b + near, xs.h)).chain(
            module.NLBlock, near).own(mesh)
        vs = strip_of(torch.cat(vk_list + [nl], dim=1), STAGE_HALO, mesh)
        decode_v = _mdcun_decode(module, vs.chain(module.conv_u[i], 2),
                                 pan_s, pan_hp, mesh)
        vk_list.append(decode_v)
        down_x = _mdcun_down(module.conv_down, xs, mesh)
        down_nl = _mdcun_down(module.conv_down,
                              vs.map(lambda t: t[:, -c:]), mesh)
        x = x - module.delta[i] * (
            _mdcun_up(module.conv_up, down_x - ms
                      + module.u[i] * (down_nl - ms), mesh)
            + module.eta[i] * (x - decode_u)
            + module.gama[i] * (nl - decode_v))
    return x


def _hin_rows(pairs: list, mesh: Mesh) -> list:
    """[(_HINConvBlock, strip)] -> each block on its strip (two 3x3 convs,
    the instance norm between them with whole-plane statistics), in
    lockstep so that the blocks' sums share each all-reduce."""
    first = [s.chain(blk.conv_1, 1) for blk, s in pairs]
    halves = [f.split(blk.norm.num_features) for (blk, _), f in
              zip(pairs, first)]
    normed = instance_norm_rows([(blk.norm, n) for (blk, _), (n, _) in
                                 zip(pairs, halves)], mesh)
    out = []
    for (blk, s), n, (_, rest) in zip(pairs, normed, halves):
        y = Strip.cat([n, rest]).map(
            lambda t, blk=blk: F.leaky_relu(t, blk.relu_slope))
        y = y.chain(blk.conv_2, 1)
        ident = s.map(blk.identity).rows(y.lo, y.hi)
        out.append(y.map(lambda t, blk=blk, ident=ident: F.leaky_relu(
            t, blk.relu_slope) + ident))
    return out


def _dense_rows(blocks: list, strips: list, mesh: Mesh) -> list:
    """INNT's `_DenseBlockINNT`s, each on its strip, in lockstep."""
    act = lambda s: s.map(lambda t: F.leaky_relu(t, 0.2))
    x1 = [act(s) for s in _hin_rows([(blk.conv1, s) for blk, s in
                                     zip(blocks, strips)], mesh)]
    return [act(s) for s in _hin_rows([(blk.conv2, s) for blk, s in
                                       zip(blocks, x1)], mesh)]


def _invblock_rows(op, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`InvBlock.forward` (INNT's subnets) on the rank's rows: one halo
    of 8 rows, F's four 3x3 convs, then H's and G's."""
    x1, x2 = strip_of(x, 8, mesh).map(op.invconv).split(op.split)
    f, = _dense_rows([op.F], [x2], mesh)
    y1 = f.map(lambda t: x1.rows(f.lo, f.hi) + t)
    hs, gs = _dense_rows([op.H, op.G], [y1, y1], mesh)
    s = op.clamp * (torch.sigmoid(hs.own(mesh)) * 2 - 1)
    y2 = x2.own(mesh) * torch.exp(s) + gs.own(mesh)
    return torch.cat([y1.own(mesh), y2], dim=1)


def _refine_rows(refine, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`Refine.forward` on the rank's rows: one halo of 3 rows (conv_in,
    then each CALayer's two convs for its mean, or conv_last)."""
    x = strip_of(x, 3, mesh).chain(refine.conv_in, 1)
    for ca in refine.process:
        y = x.chain(ca.process, 2).own(mesh)
        y = space_mean(y, mesh, y.shape[-2] * mesh.space_world
                       * y.shape[-1])
        x = x.map(lambda t, y=y, ca=ca: ca.conv_du(y) * y + t)
    return x.chain(refine.conv_last, 1).own(mesh)


def _patch_fusion_rows(pf, msf: torch.Tensor, panf: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """`PatchFusion.forward(msf, panf)` on the rank's rows from the whole
    planes: the rank's share of the patch-images searched, every share
    all-gathered, the rank's rows folded (module docstring)."""
    b, c, h, w = msf.shape
    lh = (h + 2 * _PAD - _PATCH) // _STRIDE + 1
    length = lh * ((w + 2 * _PAD - _PATCH) // _STRIDE + 1)
    n, s = b * length, mesh.space_world
    per = -(-n // s)
    n0 = min(n, mesh.space_rank * per)
    n1 = min(n, n0 + per)
    fused = msf.new_zeros(per, c, _PATCH, _PATCH)
    if n1 > n0:
        fused[:n1 - n0] = pf.fuse(scrambled_patches(msf, n0, n1),
                                  scrambled_patches(panf, n0, n1))
    fused = all_gather_h(fused, mesh, dim=0)[:n]
    a = mesh.space_rank * (h // s)
    return fold_rows(fused.reshape(b, c * _PATCH * _PATCH, length), (h, w),
                     a, a + h // s)


def _m_hr(ms: torch.Tensor, pan: torch.Tensor, depth: int,
          mesh: Mesh) -> Strip:
    """m_hr, the bicubic align_corners=True resize of ms to the PAN's
    size, on the rank's rows and `depth` more each side, from the
    gathered LrMS (`bicubic_rows`)."""
    big_h, big_w = pan.shape[-2] * mesh.space_world, pan.shape[-1]
    a, b = _own(mesh, big_h)
    lo, hi = max(a - depth, 0), min(b + depth, big_h)
    return Strip(bicubic_rows(all_gather_h(ms, mesh), (big_h, big_w), lo,
                              hi), lo, hi, big_h)


def innt_rows(module: GPPNNINNT, ms: torch.Tensor, pan: torch.Tensor,
              mesh: Mesh) -> torch.Tensor:
    """`GPPNNINNT.forward` (INNT, float32, either search) on the rank's
    rows of ms [B, C, h, w] and pan [B, 1, 4h, 4w] (module
    docstring)."""
    m_hr = _m_hr(ms, pan, 2, mesh)
    cp = module.conv_process
    feats = Strip.cat([m_hr.chain(cp.convms, 1),
                       strip_of(pan, 2, mesh).chain(cp.convpan, 1)])
    conv_f = feats.chain(module.conv_fusion.conv, 1).own(mesh)
    whole = all_gather_h(feats.own(mesh), mesh)
    half = whole.shape[1] // 2
    trans_f = _patch_fusion_rows(module.transform_fusion, whole[:, :half],
                                 whole[:, half:], mesh)
    x = torch.cat([conv_f, trans_f], dim=1)
    extract = module.extract
    outs = [x]
    for i, op in enumerate(extract.operations):
        x = _invblock_rows(op, x, mesh)
        if i > 1:
            outs.append(x)
    hr = extract.fuse(torch.cat(outs, dim=1))
    return _refine_rows(module.refine, hr, mesh) + m_hr.own(mesh)


def _reach(s: Strip, depth: int, ahead: int, mesh: Mesh) -> Strip:
    """s where it holds `depth` rows beyond the rank's at each end that
    is not the image's; else the rank's rows of s with a new halo,
    `ahead` rows deep (one exchange for the operations ahead) where the
    neighbours' strips hold that many, else `depth`."""
    a, b = _own(mesh, s.h)
    if s.lo <= max(a - depth, 0) and s.hi >= min(b + depth, s.h):
        return s
    own = s.own(mesh)
    return strip_of(own, ahead if ahead <= own.shape[-2] else depth, mesh)


_SCALES = (1, 2, 4)     # MutInf's multi-scale dense block: 1x, 1/2, 1/4


def _mscale_rows(blocks: list, x: torch.Tensor, mesh: Mesh) -> list:
    """MutInf's `_DenseBlockMscale`s, each of the rank's rows x, in
    lockstep (every block's and scale's instance-norm sums in one
    all-reduce a pass, the pooled sums in one): x at 1/2 and 1/4 by the
    bilinear downsample of the rank's own rows (its taps stay inside a
    strip that starts on the scale's grid), the dense block at each scale
    on a halo of its five 3x3 convs and, below 1x, one row more for the
    bilinear way back up: one halo a scale where the neighbours' strips
    hold it, else a halo before each stage (HIN block, HIN block, the
    3x3 over the dense concat), so that a rank takes 8 PAN rows."""
    h = x.shape[-2] * mesh.space_world
    own = Strip(x, *_own(mesh, h), h)
    act = lambda st: st.map(lambda t: F.leaky_relu(t, 0.2))
    parts = [(blk.ops, q) for blk in blocks for q in _SCALES]
    up = lambda q: int(q > 1)
    # one strip a scale: the blocks share their input
    xs = {q: _reach(own if q == 1 else own.resample(1 / q, "bilinear"), 2,
                    5 + up(q), mesh) for q in _SCALES}
    x1 = [act(st) for st in _hin_rows([(ops.conv1, xs[q])
                                      for ops, q in parts], mesh)]
    x1 = [_reach(st, 2, 3 + up(q), mesh) for st, (_, q) in zip(x1, parts)]
    x2 = [act(st) for st in _hin_rows([(ops.conv2, st) for st, (ops, _) in
                                       zip(x1, parts)], mesh)]
    outs = []
    for (ops, q), a1, a2 in zip(parts, x1, x2):
        cat = _reach(Strip.cat([xs[q], a1, a2]), 1 + up(q), 1 + up(q), mesh)
        y = act(cat.chain(ops.conv3, 1))
        outs.append(y.own(mesh) if q == 1 else
                    y.resample(q, "bilinear").own(mesh))
    per = [outs[i:i + len(_SCALES)] for i in range(0, len(outs),
                                                   len(_SCALES))]
    pooled = space_mean(torch.cat([o1 + o2 + o4 for o1, o2, o4 in per],
                                  dim=1), mesh, h * x.shape[-1])
    result = []
    for blk, (o1, o2, o4), att in zip(blocks, per, torch.split(
            pooled, [o[0].shape[1] for o in per], dim=1)):
        att = blk.fusepool[1:](att)
        result.append(blk.fuse(torch.cat([o1 * blk.fc1(att),
                                          o2 * blk.fc2(att),
                                          o4 * blk.fc3(att)], dim=1)))
    return result


def mutinf_rows(module: GPPNNMutInf, ms: torch.Tensor, pan: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """`GPPNNMutInf.forward`'s HrMS (MutInf, eval) on the rank's rows of
    ms [B, C, h, w] and pan [B, 1, 4h, 4w] (module docstring)."""
    m_hr = _m_hr(ms, pan, 6, mesh)
    panf = strip_of(pan, 6, mesh).chain(module.extract_pan, 6).own(mesh)
    x = torch.cat([panf, m_hr.chain(module.extract_ms, 6).own(mesh)], dim=1)
    outs = []
    for i, op in enumerate(module.interact.operations):
        x = op.invconv(x)
        x1, x2 = x[:, :op.split], x[:, op.split:]
        f, = _mscale_rows([op.F], x2, mesh)
        y1 = x1 + f
        hs, gs = _mscale_rows([op.H, op.G], y1, mesh)
        s = op.clamp * (torch.sigmoid(hs) * 2 - 1)
        x = torch.cat([y1, x2 * torch.exp(s) + gs], dim=1)
        if i >= 1:
            outs.append(x)
    fused = module.interact.fuse(torch.cat(outs, dim=1))
    return _refine_rows(module.refine, fused, mesh) + m_hr.own(mesh)


_SPA_DEPTH = 10     # SFIIN's InvBlock: F, then H and G, five 3x3 each


def _spafre_rows(blk, msf: torch.Tensor, pan: torch.Tensor,
                 mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """`SpaFre.forward` on the rank's rows: `panprocess` on a 1-row halo;
    msf and panf all-gathered (one collective), `FreProcess` on the whole
    planes on every rank (its FFT is global: exact, and redundant), the
    spatial branch (InvBlock, 1x1), `spa_att` and `post` on a strip of
    the gathered planes; the channel mean and contrast over H x W from
    all-reduced sums, two passes."""
    panpre = conv_rows(blk.panprocess, pan, mesh)
    panf = blk.panpre(panpre)
    c = msf.shape[1]
    whole = all_gather_h(torch.cat([msf, panf], dim=1), mesh)
    h = whole.shape[-2]
    a, b = _own(mesh, h)
    fre = blk.fre_process(whole[:, :c], whole[:, c:])
    depth = _SPA_DEPTH + 2 + 1
    lo, hi = max(a - depth, 0), min(b + depth, h)
    spa = Strip(whole[..., lo:hi, :], lo, hi, h).chain(blk.spa_process,
                                                       _SPA_DEPTH)
    fre_at = lambda st: fre[..., st.lo:st.hi, :]
    att = Strip(spa.t - fre_at(spa), spa.lo, spa.hi, h).chain(blk.spa_att,
                                                              2)
    spa = spa.crop(att.lo, att.hi)
    cat_f = att.map(lambda t: torch.cat([fre_at(att) * t + spa.t,
                                         fre_at(att)], dim=1))
    own = cat_f.own(mesh)
    n = h * own.shape[-1]
    mean = space_mean(own, mesh, n)
    contrast = space_mean((own - mean).square(), mesh, n).sqrt()
    gate = blk.cha_att(contrast + mean)
    cha = cat_f.map(lambda t: gate * t).chain(blk.post, 1).own(mesh)
    return cha + msf, panpre


def sfiin_rows(module: SFIINNet, ms: torch.Tensor, pan: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """`SFIINNet.forward` (SFIIN, eval) on the rank's rows of ms
    [B, C, h, w] and pan [B, 1, 4h, 4w] (module docstring)."""
    proc = module.process
    m_hr = _m_hr(ms, pan, 1, mesh)
    msf = m_hr.chain(proc.conv_p, 1).own(mesh)
    panf = conv_rows(proc.conv_p1, pan, mesh)
    feats = []
    for name in _BLOCKS:
        msf, panf = _spafre_rows(getattr(proc, name), msf, panf, mesh)
        feats.append(msf)
    fused = proc.fuse(torch.cat(feats, dim=1))
    return _refine_rows(module.refine, fused, mesh) + m_hr.own(mesh)


def _halo_nhwc(x: torch.Tensor, above: int, below: int, mesh: Mesh,
               edge: str) -> torch.Tensor:
    """`halo_rows` of an NHWC x."""
    return halo_rows(x.permute(0, 3, 1, 2), above, below, mesh,
                     edge).permute(0, 2, 3, 1)


def _window_attention_rows(attn, x: torch.Tensor, y: torch.Tensor | None,
                           mesh: Mesh) -> torch.Tensor:
    """`WindowAttention.forward(x, y)` on the rank's rows (NHWC, a
    multiple of the window; W whole): regular windows are local; shifted
    ones roll the plane up by d = w // 2 first (d rows of the rank below
    come in, the first rows of the image at its bottom: a "wrap" halo,
    with y's rows where the block is cross), take the upper/lower mask
    on the image's last band of windows only, and roll back down after
    (d rows of the rank above, "wrap"); the roll along W is local."""
    if not attn.shifted:
        return attn.attend(x, y)
    w, d = attn.window_size, attn.window_size // 2
    h, cx = x.shape[1], x.shape[-1]
    cross = attn.cross_attn and y is not None
    t = torch.cat([x, y], dim=-1) if cross else x
    t = torch.roll(_halo_nhwc(t, 0, d, mesh, "wrap")[:, d:], -d, dims=2)
    x, y = (t[..., :cx], t[..., cx:]) if cross else (t, y)
    mask = _window_mask(w, h // w, x.shape[2] // w, x.device,
                        mesh.space_rank == mesh.space_world - 1)
    out = attn.attend(x, y, mask)
    return torch.roll(_halo_nhwc(out, d, 0, mesh, "wrap")[:, :h], d, dims=2)


def _swin_rows(swin, x: torch.Tensor, mesh: Mesh,
               y: torch.Tensor | None = None) -> torch.Tensor:
    """`SwinModule.forward(x, y)` on the rank's rows (NHWC): the patch
    merge is local (the rank's rows a multiple of its factor), each
    block's LN and MLP too."""
    x = swin.patch_partition(x)
    if y is not None:
        y = swin.patch_partition(y)
    for block in (blk for pair in swin.layers for blk in pair):
        pre = block.attention_block.fn
        x = _window_attention_rows(pre.fn, pre.norm(x), y, mesh) + x
        x = block.mlp_block(x)
    return x


def _tail_rows(seq: nn.Sequential, x: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """PanFormer's `HR_tail` (3x3 convs, PixelShuffles, ReLUs) on the
    rank's rows: one halo of the convs' reach at x's grid (a conv at k
    times x's resolution reaches 1 / k of x's rows: 1 + 1/2 + 1/4 + 1/4
    = 2 rows)."""
    reach, k = 0.0, 1
    for layer in seq:
        if isinstance(layer, nn.Conv2d):
            reach += layer.kernel_size[0] // 2 / k
        elif isinstance(layer, nn.PixelShuffle):
            k *= layer.upscale_factor
    st = strip_of(x, math.ceil(reach), mesh)
    for layer in seq:
        if isinstance(layer, nn.Conv2d):
            st = st.chain(layer, layer.kernel_size[0] // 2)
        elif isinstance(layer, nn.PixelShuffle):
            st = st.rescale(layer)
        else:
            st = st.map(layer)
    return st.own(mesh)


def panformer_rows(module: CrossSwinTransformer, ms: torch.Tensor,
                   pan: torch.Tensor, mesh: Mesh,
                   clamp: bool = True) -> torch.Tensor:
    """`CrossSwinTransformer.forward` (PanFormer, eval; `unclamped` with
    clamp False) on the rank's rows of ms [B, C, h, w] and pan [B, 1, 4h,
    4w]: each rank's feature rows must be whole windows, so a rank takes
    a multiple of 4 w PAN rows (16 at the shipped window 4)."""
    win = module.pan_encoder[0].layers[0][0].attention_block.fn.fn \
        .window_size
    if pan.shape[-2] % (4 * win):
        raise _refuse(f"PanFormer on strips of {pan.shape[-2]} PAN rows: "
                      f"its windows need a multiple of {4 * win} (two "
                      f"x1/2 merges, then {win}-row windows)")
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    pan_feat = nhwc(pan)
    for swin in module.pan_encoder:
        pan_feat = _swin_rows(swin, pan_feat, mesh)
    ms_feat = nhwc(ms)
    for swin in module.ms_encoder:
        ms_feat = _swin_rows(swin, ms_feat, mesh)
    for pan_cross, ms_cross in zip(module.pan_cross_ms, module.ms_cross_pan):
        pan_feat, ms_feat = (_swin_rows(pan_cross, pan_feat, mesh, ms_feat),
                             _swin_rows(ms_cross, ms_feat, mesh, pan_feat))
    x = torch.cat([pan_feat, ms_feat], dim=-1).permute(0, 3, 1, 2)
    out = _tail_rows(module.HR_tail, x, mesh)
    return out.clamp(0.0, module.hi) if clamp else out


def _interp23_rows(lrms: torch.Tensor, ratio: int,
                   mesh: Mesh) -> torch.Tensor:
    """The rank's rows of interp23_upsample(the whole LrMS), NHWC."""
    whole = all_gather_h(lrms, mesh, dim=1)
    n = lrms.shape[1] * ratio
    rows = slice(mesh.space_rank * n, (mesh.space_rank + 1) * n)
    return interp23_upsample(whole, ratio, rows=rows)


def sfim_rows(lrms: torch.Tensor, pan: torch.Tensor,
              mesh: Mesh) -> torch.Tensor:
    """`sfim_fuse` on the rank's rows of NHWC lrms and pan."""
    ratio = pan.shape[-3] // lrms.shape[-3]
    u_hs = _interp23_rows(lrms, ratio, mesh)
    k = ratio + 1 if ratio % 2 == 0 else ratio
    n_pix = pan.shape[-3] * mesh.space_world * pan.shape[-2]
    total = lambda t: space_sum(t.sum(dim=(1, 2), keepdim=True), mesh)
    pan_mean = total(pan) / n_pix
    pan_var = total((pan - pan_mean) ** 2) / (n_pix - 1)
    hs_mean = total(u_hs) / n_pix
    hs_var = total((u_hs - hs_mean) ** 2) / (n_pix - 1)
    pan_m = (pan - pan_mean) * torch.sqrt(hs_var / pan_var) + hs_mean
    pad = k // 2
    x = halo_rows(pan_m.permute(0, 3, 1, 2), pad, pad, mesh, "wrap")
    x = F.pad(x, (pad, pad, 0, 0), mode="circular")
    lrpan = depthwise_conv2d(x, np.full((k, k), 1.0 / (k * k)))
    out = u_hs * pan_m / (lrpan.permute(0, 2, 3, 1) + 1e-8)
    return out.clamp(0.0, 1.0)


def wavelet_rows(lrms: torch.Tensor, pan: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """`wavelet_fuse` on the rank's rows of NHWC lrms and pan."""
    if pan.shape[-3] % 4:
        raise _refuse(f"Wavelet's level-2 Haar transforms on strips of "
                      f"{pan.shape[-3]} rows (a multiple of 4 is local)")
    return wavelet_inject(
        _interp23_rows(lrms, pan.shape[-3] // lrms.shape[-3], mesh), pan)


def gsa_rows(lrms: torch.Tensor, pan: torch.Tensor,
             mesh: Mesh) -> torch.Tensor:
    """`gsa_fuse` on the rank's rows of NHWC lrms and pan: the LrMS
    gathered (interp23's rows, and the low-resolution design whole); the
    PAN's x1/ratio bicubic on the rank's rows (a strip on its grid), then
    gathered; alpha by `lstsq_min_norm` of the gathered design on every
    rank (the same bits on each); every mean over H x W, cov and var_i0
    from all-reduced sums, centred first where the whole op centres."""
    b, hh, ww, c = lrms.shape
    whole = all_gather_h(lrms, mesh, dim=1)
    hh = whole.shape[1]
    h, w = pan.shape[1], pan.shape[2]
    ratio = h * mesh.space_world // hh
    n_pix = h * mesh.space_world * w
    rows = slice(mesh.space_rank * h, (mesh.space_rank + 1) * h)
    u_hs = interp23_upsample(whole, ratio, rows=rows)
    mean = lambda t, dims: space_sum(t.sum(dim=dims, keepdim=True),
                                     mesh) / n_pix
    means = mean(u_hs, (1, 2))
    image_lr = u_hs - means
    image_lr_lp = whole - whole.mean(dim=(1, 2), keepdim=True)
    image_hr = pan - mean(pan, (1, 2, 3))
    image_hr0 = all_gather_h(resample_rows(image_hr.permute(0, 3, 1, 2),
                                           1 / ratio, mesh), mesh)
    ones = lambda n: torch.ones(b, n, 1, dtype=lrms.dtype,
                                device=lrms.device)
    design = torch.cat([image_lr_lp.reshape(b, hh * ww, c), ones(hh * ww)],
                       -1)
    alpha = lstsq_min_norm(design, image_hr0.reshape(b, hh * ww, 1))
    design_hr = torch.cat([image_lr.reshape(b, h * w, c), ones(h * w)], -1)
    intensity = (design_hr @ alpha).reshape(b, h * w)
    i0 = intensity - mean(intensity, 1)
    i0_centered = i0 - mean(i0, 1)
    bands = image_lr.reshape(b, h * w, c)
    bands_centered = bands - mean(bands, 1)
    cov_var = space_sum(torch.cat([
        (i0_centered[:, None, :] @ bands_centered)[:, 0],
        (i0_centered * i0_centered).sum(dim=1, keepdim=True)], dim=1), mesh)
    g = (cov_var[:, :c] / (n_pix - 1)) / (cov_var[:, c:] / n_pix)
    delta = image_hr - i0.reshape(b, h, w, 1)
    fused = image_lr + g[:, None, None, :] * delta
    fused = fused - mean(fused, (1, 2)) + means
    return fused.clamp(0.0, 1.0)


_MODULES = {LGTEUN: lgteun_rows, LightNetModule: lightnet_rows,
            PanUnfolding: mdcun_rows, GPPNNINNT: innt_rows,
            GPPNNMutInf: mutinf_rows, SFIINNet: sfiin_rows,
            CrossSwinTransformer: panformer_rows}
_CLASSICAL = {sfim_fuse: sfim_rows, wavelet_fuse: wavelet_rows,
              gsa_fuse: gsa_rows}


def _sharded_forward(method) -> tuple:
    """(forward, device, module or None) of `method` (module docstring);
    raises for one without a height-sharded forward."""
    if isinstance(method, ClassicalMethod):
        fwd = _CLASSICAL.get(type(method).fuse_fn)
        if fwd is None:
            raise _refuse(f"{type(method).__name__} has no height-sharded "
                          "forward")
        return fwd, method.device, None
    module = method.module if isinstance(method, TorchMethod) else method
    fwd = _MODULES.get(type(module)) if isinstance(module, nn.Module) \
        else None
    if fwd is None:
        raise _refuse(f"{type(method).__name__} ({type(module).__name__}) "
                      "has no height-sharded forward")
    if getattr(method, "taps", lambda: False)():
        fwd = functools.partial(lightnet_tap_rows, dtype=method.tap_dtype)
    if module.training:
        raise _refuse("a module in training mode: the height-sharded "
                      "forwards are eval forwards without gradients")
    return fwd, next(module.parameters()).device, module


def run_spatially_sharded(method, batch: dict, mesh: Mesh,
                          batch_axis: str | None = None,
                          space_axis: str = "space") -> torch.Tensor:
    """Every image of `batch` cut to the rank's rows (`spatial_sharding`;
    `image_id` passed through), the method's height-sharded forward under
    torch.no_grad(): the rank's rows of the output, NHWC float32 on the
    method's device (module docstring)."""
    sharding = spatial_sharding(mesh, batch_axis, space_axis)
    fwd, device, module = _sharded_forward(method)
    if any(isinstance(v, torch.Tensor) and v.requires_grad
           for v in batch.values()):
        raise _refuse("a call with gradients on: the height-sharded "
                      "forwards run under torch.no_grad()")
    local = {k: v if k == "image_id" else sharding.place(v)
             for k, v in batch.items()}
    with torch.no_grad():
        if module is None:
            lr, pan = (torch.as_tensor(local[k], dtype=torch.float32,
                                       device=device)
                       for k in ("input_lr", "input_pan"))
            return fwd(lr, pan, mesh)
        ms, pan = (_nchw(local[k], device) for k in ("input_lr",
                                                     "input_pan"))
        cast = (method.eval_cast(ms, pan) if isinstance(method, TorchMethod)
                else contextlib.nullcontext((ms, pan)))
        with cast as (ms, pan):
            out = fwd(module, ms, pan, mesh)
        return out.float().permute(0, 2, 3, 1)


def gather_h(out: torch.Tensor, mesh: Mesh,
             batch_axis: str | None = None) -> torch.Tensor:
    """The whole output from every rank's rows of NHWC `out`: H gathered
    over the space group, and with `batch_axis` "data" the batch rows
    over the data group."""
    whole = all_gather_h(out, mesh, dim=1)
    return whole if batch_axis is None else all_gather_rows(whole, mesh)
