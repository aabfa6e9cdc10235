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
of module it holds (`LGTEUN`, `LightNetModule`) or, for a classical
method, by its fuse function (SFIM, Wavelet). The JAX module's jit cache
(`_JITTED`) has no counterpart: these forwards are eager, and nothing is
traced or compiled per function.

The halo primitives (NCHW strips, H at dim -2, over the rank's
`space_group`):

    halo_rows(x, above, below, mesh, edge)
                     `above` rows of the rank above and `below` rows of
                     the rank below around x (`dist.batch_isend_irecv`);
                     at the image's own top and bottom `edge` gives
                     "zero": zero rows (a conv's zero padding), "none": no
                     rows (a resample clamps its taps at the real edge;
                     LightNet's stack zero-pads each layer there), "wrap":
                     the rows of the far end (SFIM's circular box filter)
    all_gather_h(x, mesh, dim=-2)
                     the whole plane, in rank order
    space_sum(t, mesh)
                     a SUM all-reduce (global statistics)

Under gloo with CUDA tensors (ranks sharing one card) every exchange is
staged through host copies, as `mesh._host_staged` does. `EXCHANGES`
counts the collectives each primitive runs, by kind ("halo", "gather",
"sum"), as the kernel wrappers count their launches.

Each forward, per operation (the rank holds rows [a, b) of H):

- bicubic resamples (`Resample`, `sampling`): a halo of 2 source rows,
  "none" at the edges; a strip of a downsample by q starts on a multiple
  of q (its halo is 2 rounded up to q), so each local output row maps to
  the global row's source coordinate and taps, and the strip's output is
  the global output's rows bit for bit;
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
- UnlgFormer (`LGTEUN`, fuse level 2, float32): the unfolding steps'
  x4 resample of ms, D, DT (resamples and 3x3 `DepConv`s as above), R
  and RT (1x1); in the prior each LGB block all-gathers its input x and
  runs B1 `ln_mixer_head` on the whole plane on every rank (the FFT mixer
  is global over the plane: exact, and redundant; a distributed FFT is
  ROADMAP A.9.3), then B2 `window_attention` on the strip of y1 from
  rows a and b rounded out to the 8-row window grid plus one window band
  on each side (windows stay fixed in the global grid), B3 `block_tail`
  on the same strip of x, x1, x2 (its FFN's 3x3 depthwise conv needs 1
  row, and the strip is a multiple of 8 rows), cropped to [a, b).

Refused with a ValueError that names ROADMAP A.9.3 (never by gathering
the input and running the whole forward): a method without a sharded
forward (GSA, MDCUN, INNT, PanFormer, SFIIN, MutInf), UnlgFormer at a
fuse level other than 2 or with LGTEUN_FUSED_ATTENTION=v2, either bf16
storage mode (and LightNet's bf16 tap path, the zoo's blanket cast), an
H that the space size does not divide, Wavelet on strips that are not a
multiple of 4 rows, a halo deeper than a neighbour's strip, and a call
with gradients on (an input that requires a gradient, or a module in
training mode): these are eval forwards.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lgteun_tpu_torch.models.base import ClassicalMethod, TorchMethod, _nchw
from lgteun_tpu_torch.models.classical import (sfim_fuse, wavelet_fuse,
                                               wavelet_inject)
from lgteun_tpu_torch.models.common.layers import Resample
from lgteun_tpu_torch.models.lgteun import LGTEUN
from lgteun_tpu_torch.models.lightnet import LightNetModule
from lgteun_tpu_torch.ops.ffn_kernel import block_tail
from lgteun_tpu_torch.ops.filters import depthwise_conv2d
from lgteun_tpu_torch.ops.interp23 import interp23_upsample
from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_stack
from lgteun_tpu_torch.ops.resize import sample_scale
from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head
from lgteun_tpu_torch.parallel.mesh import (Mesh, _all_reduce_,
                                            _host_staged, all_gather_rows)

__all__ = ["SpatialSharding", "spatial_sharding", "run_spatially_sharded",
           "gather_h", "halo_rows", "edge_rows", "all_gather_h",
           "space_sum", "resample_rows", "conv_rows", "window_strip",
           "EDGES", "RESAMPLE_HALO", "EXCHANGES"]

EDGES = ("zero", "none", "wrap")
RESAMPLE_HALO = 2   # source rows a bicubic tap reaches beyond a strip
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
        staged = _host_staged(mesh, x)
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
                got[key] = staged.new_empty((*x.shape[:-2], n, x.shape[-1]))
                p2p(dist.irecv, got[key], src, tag)
        if ops:
            EXCHANGES["halo"] += 1
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        top, bottom = (got[k].to(x.device) if k in got else None
                       for k in ("top", "bottom"))
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
    src = _host_staged(mesh, x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.space_world)]
    EXCHANGES["gather"] += 1
    dist.all_gather(parts, src, group=mesh.space_group)
    return torch.cat(parts, dim=dim).to(x.device)


def space_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The SUM of t over the space group (t itself without one)."""
    if mesh.space_group is None:
        return t
    EXCHANGES["sum"] += 1
    return _all_reduce_(t.contiguous(), mesh, group=mesh.space_group)


def resample_rows(x: torch.Tensor, factor: float,
                  mesh: Mesh) -> torch.Tensor:
    """`sample_scale(x, factor)` (bicubic, align_corners False) of the
    rank's rows of x [B, C, h, W]: the rank's rows of the whole plane's
    resample (module docstring)."""
    if factor == 1:
        return x
    h = x.shape[-2]
    halo = RESAMPLE_HALO
    if factor < 1:
        q = round(1 / factor)
        if h % q:
            raise _refuse(f"a x1/{q} resample of strips of {h} rows: a "
                          f"strip must start on a multiple of {q}")
        halo = -(-halo // q) * q
    top, _ = edge_rows(mesh, halo, halo, "none")
    y = sample_scale(halo_rows(x, halo, halo, mesh, "none"), factor)
    start, n = round(top * factor), round(h * factor)
    return y[..., start:start + n, :]


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


# -------------------------------------------------------------- forwards

def _lgb(lgb, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """LGB at fuse level 2 on the rank's rows (module docstring)."""
    h = x.shape[-2]
    a = mesh.space_rank * h
    lo, hi = window_strip(a, a + h, h * mesh.space_world, lgb.win)
    strip = lambda t: t[..., lo:hi, :].contiguous()
    for i, (mix_res, _) in enumerate(lgb.blocks):
        eps = mix_res.fn.norm.eps
        blk = lgb._params(i)
        whole = all_gather_h(x, mesh)
        y1, x2 = ln_mixer_head(whole, blk["ln_w"], blk["ln_b"],
                               *(blk[k] for k in ("amp_w", "amp_b",
                                                  "pha_w", "pha_b")),
                               eps=eps)
        x1 = lgb._local_mixer(strip(y1), blk)
        out = block_tail(strip(whole), x1, strip(x2), blk["proj_w"],
                         blk["proj_b"], blk["ffn"], eps=eps)
        x = out[..., a - lo:a - lo + h, :]
    return x


def _lgt(lgt, z: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    fea = lgt.patch_embed(z)
    skips = []
    for lgb, down in lgt.encoder_layers:
        fea = _lgb(lgb, fea, mesh)
        skips.append(fea)
        fea = _sequence(down, fea, mesh)
    fea = _lgb(lgt.bottleneck, fea, mesh)
    for up, fuse, lgb in lgt.decoder_layers:
        fea = fuse(torch.cat([_sequence(up, fea, mesh), skips.pop()], dim=1))
        fea = _lgb(lgb, fea, mesh)
    return _sequence(lgt.tail, fea, mesh) + z


def _check_lgteun(module: LGTEUN) -> None:
    prior = module.prior_module[module.stage - 1]
    lgbs = [lgb for lgb, _ in prior.encoder_layers]
    lgbs += [prior.bottleneck] + [lgb for *_, lgb in prior.decoder_layers]
    if prior.storage != (None, False):
        raise _refuse("UnlgFormer's bf16 storage modes (LGTEUN_EVAL_DTYPE) "
                      "have no height-sharded forward")
    if any(lgb.windows for lgb in lgbs):
        raise _refuse("UnlgFormer with LGTEUN_FUSED_ATTENTION=v2 has no "
                      "height-sharded forward")
    levels = sorted({lgb.level for lgb in lgbs})
    if levels != [2]:
        raise _refuse(f"UnlgFormer at LGTEUN_FUSE_LEVEL {levels}: only "
                      "level 2 is height-sharded")


def lgteun_rows(module: LGTEUN, ms: torch.Tensor, pan: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """`LGTEUN.forward` (eval, level 2, float32) on the rank's rows of
    ms [B, C, h, w] and pan [B, 1, 4h, 4w]."""
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
    if ms.dtype != torch.float32:
        raise _refuse(f"LightNet on {ms.dtype}: only the float32 stack is "
                      "height-sharded")
    spans = module.spans()
    lms = resample_rows(resample_rows(ms, 2, mesh), 2, mesh)
    x = torch.cat([pan, lms], dim=1)
    depth = len(spans)   # one 3x3 depthwise conv a span on each branch
    top, _ = edge_rows(mesh, depth, depth, "none")
    xh = halo_rows(x, depth, depth, mesh, "none")
    out = lightnet_stack(xh, xh[:, 1:].contiguous(),
                         [s.weights() for s in spans])
    return out[..., top:top + x.shape[-2], :]


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


_MODULES = {LGTEUN: lgteun_rows, LightNetModule: lightnet_rows}
_CLASSICAL = {sfim_fuse: sfim_rows, wavelet_fuse: wavelet_rows}


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
    if isinstance(method, TorchMethod) and (
            method.eval_dtype is not None
            or getattr(method, "tap_dtype", None) is not None):
        raise _refuse(f"{type(method).__name__} under LGTEUN_EVAL_DTYPE / "
                      "LGTEUN_LIGHTNET_DTYPE=bf16 has no height-sharded "
                      "forward")
    if module.training:
        raise _refuse("a module in training mode: the height-sharded "
                      "forwards are eval forwards without gradients")
    if isinstance(module, LGTEUN):
        _check_lgteun(module)
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
        out = fwd(module, _nchw(local["input_lr"], device),
                  _nchw(local["input_pan"], device), mesh)
        return out.permute(0, 2, 3, 1)


def gather_h(out: torch.Tensor, mesh: Mesh,
             batch_axis: str | None = None) -> torch.Tensor:
    """The whole output from every rank's rows of NHWC `out`: H gathered
    over the space group, and with `batch_axis` "data" the batch rows
    over the data group."""
    whole = all_gather_h(out, mesh, dim=1)
    return whole if batch_axis is None else all_gather_rows(whole, mesh)
