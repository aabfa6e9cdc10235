"""Tiled whole-scene fusion (counterpart of
`lgteun_tpu/parallel/scene.py::fuse_scene`, the JAX package's
production large-strip path).

The networks were trained on 128px tiles, so a large scene is covered
with overlapping tiles at the model's native size, the tiles are fused in
batches through the method's forward (`TorchMethod.apply`), and the
seams are blended with a partition-of-unity cosine ramp.

Geometry (the same as the JAX engine). PAN tiles are T x T with stride
S = T - 2*halo; the scene is reflect-padded bottom/right to a regular
grid ((H'-T) % S == 0), so blend weights sum to exactly 1 everywhere
(boundary tiles get flat-edged ramps). LrMS tiles are (T/4) x (T/4) at
stride S/4: T, S, halo and the scene size must be multiples of 4.
halo <= T/4 keeps the overlap factor at 2 per axis, so the overlap-add
is two parity groups per axis, each laid out by a pad and a reshape.

Everything runs on the method's device: reflect padding, tile
extraction as strided views (`Tensor.unfold`), the chunks of `batch`
tiles, the ramp weighting and the overlap-add. One eager pass per call.
With a `mesh` (`parallel/mesh.py`; JAX's `mesh=`, which shards each tile
batch over the `data` axis) every rank fuses its rows of each chunk, the
fused tiles are gathered in rank order, and every rank blends and
returns the whole scene.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lgteun_tpu_torch.parallel.mesh import Mesh, all_gather_rows

__all__ = ["fuse_scene", "cosine_ramp_weights"]

SCALE = 4  # PAN/LrMS resolution ratio (reference contract)


def cosine_ramp_weights(n_tiles: int, tile: int, stride: int) -> np.ndarray:
    """Per-tile 1-D blend profiles, [n_tiles, tile] float32.

    Interior weight 1; over the `o = tile - stride` overlapped samples
    at each end a sin^2 ramp, so adjacent tiles' weights sum to exactly
    1. The first tile's leading edge and the last tile's trailing edge
    face the scene border (no partner), so those ramps are flat 1."""
    o = tile - stride
    w = np.ones(tile, np.float32)
    if o > 0:
        i = np.arange(o, dtype=np.float64) + 0.5
        ramp = np.sin(np.pi * i / (2 * o)) ** 2
        w[:o] = ramp
        w[tile - o:] = ramp[::-1]
    ws = np.tile(w, (n_tiles, 1))
    ws[0, :o] = 1.0
    ws[-1, tile - o:] = 1.0
    return ws


def _fit(t: torch.Tensor, dim: int, before: int, size: int) -> torch.Tensor:
    """Zero-pad `before` samples in front along `dim`, then pad or crop
    to `size` samples."""
    pad = [0, 0] * (t.ndim - dim)
    pad[-2] = before
    t = F.pad(t, pad)
    if t.shape[dim] < size:
        pad[-2], pad[-1] = 0, size - t.shape[dim]
        return F.pad(t, pad)
    return t.narrow(dim, 0, size)


def _overlap_add_x(tiles: torch.Tensor, stride: int,
                   out_w: int) -> torch.Tensor:
    """[ny, nx, T, T, C] -> [ny, T, out_w, C] overlap-add along x.

    Tiles of one parity group (x-index even / odd) are >= T apart
    (2*stride >= T), so each group lays out contiguously with a pad to
    2S and a reshape; the two groups are summed shifted by `stride`."""
    ny, nx, t, _, c = tiles.shape
    acc = None
    for r in range(min(2, nx)):
        sub = F.pad(tiles[:, r::2], (0, 0, 0, 2 * stride - t))
        nr = sub.shape[1]
        strip = sub.permute(0, 2, 1, 3, 4).reshape(ny, t, nr * 2 * stride, c)
        strip = _fit(strip, 2, r * stride, out_w)
        acc = strip if acc is None else acc + strip
    return acc


def _overlap_add_y(strips: torch.Tensor, stride: int,
                   out_h: int) -> torch.Tensor:
    """[ny, T, W, C] -> [out_h, W, C] overlap-add along y."""
    ny, t, w, c = strips.shape
    acc = None
    for r in range(min(2, ny)):
        sub = F.pad(strips[r::2], (0, 0, 0, 0, 0, 2 * stride - t))
        col = _fit(sub.reshape(sub.shape[0] * 2 * stride, w, c), 0,
                   r * stride, out_h)
        acc = col if acc is None else acc + col
    return acc


def _reflect(img: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """[H, W, C] reflect-padded by dh rows at the bottom and dw columns
    at the right (numpy's 'reflect': the edge sample is not repeated)."""
    if not dh and not dw:
        return img
    chw = img.permute(2, 0, 1)[None]
    return F.pad(chw, (0, dw, 0, dh), mode="reflect")[0].permute(1, 2, 0)


def _extract(img: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """[H, W, C] -> [ny*nx, t, t, C]: tiles at stride s (strided views,
    one copy)."""
    c = img.shape[-1]
    tiles = img.unfold(0, t, s).unfold(1, t, s)  # [ny, nx, C, t, t]
    return tiles.permute(0, 1, 3, 4, 2).reshape(-1, t, t, c)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32)


@torch.inference_mode()
def fuse_scene(method, ms, pan, *, tile: int = 128, halo: int = 16,
               batch: int = 32, mesh: Mesh | None = None) -> torch.Tensor:
    """Fuse one large scene: LrMS [h/4, w/4, C] + PAN [h, w] or
    [h, w, 1] (numpy or tensors, normalised) -> HrMS [h, w, C] on the
    method's device, tiled through `method.apply`.

    tile/halo/batch: PAN-grid tile size, per-side blend halo
    (stride = tile - 2*halo), and tiles per forward (over the W ranks of
    `mesh`'s data axis, each of which fuses batch / W of them). tile,
    halo and the scene size must be multiples of 4, 0 <= halo <= tile/4,
    and batch a multiple of W."""
    device = method.device
    ms, pan = _as_tensor(ms, device), _as_tensor(pan, device)
    if pan.ndim == 2:
        pan = pan[..., None]
    h, w = pan.shape[:2]
    if h % SCALE or w % SCALE or tile % SCALE or halo % SCALE:
        raise ValueError("scene, tile and halo must be multiples of 4")
    if not 0 <= halo <= tile // 4:
        raise ValueError("need 0 <= halo <= tile/4")
    if h < tile or w < tile:
        raise ValueError(f"scene {h}x{w} smaller than tile {tile}")
    if tuple(ms.shape[:2]) != (h // SCALE, w // SCALE):
        raise ValueError(f"LrMS {tuple(ms.shape[:2])} does not match PAN/"
                         f"{SCALE} = {(h // SCALE, w // SCALE)}")
    if mesh is not None and batch % mesh.data_world:
        raise ValueError("batch must divide by the mesh axis size")
    mine = slice(0, batch) if mesh is None else mesh.rows(batch)

    stride = tile - 2 * halo
    ny = max(1, -(-(h - tile) // stride) + 1)
    nx = max(1, -(-(w - tile) // stride) + 1)
    hp, wp = (ny - 1) * stride + tile, (nx - 1) * stride + tile
    n = ny * nx
    pan_t = _extract(_reflect(pan, hp - h, wp - w), tile, stride)
    ms_t = _extract(_reflect(ms, (hp - h) // SCALE, (wp - w) // SCALE),
                    tile // SCALE, stride // SCALE)
    n_pad = (-n) % batch
    if n_pad:  # every forward has `batch` tiles (one shape)
        pan_t = torch.cat([pan_t, pan_t[:n_pad]])
        ms_t = torch.cat([ms_t, ms_t[:n_pad]])
    out = torch.cat([all_gather_rows(method.apply(
        {"input_lr": ms_t[i:i + batch][mine],
         "input_pan": pan_t[i:i + batch][mine]}), mesh)
        for i in range(0, n + n_pad, batch)])
    out = out[:n].reshape(ny, nx, tile, tile, -1)
    wy = torch.from_numpy(cosine_ramp_weights(ny, tile, stride)).to(device)
    wx = torch.from_numpy(cosine_ramp_weights(nx, tile, stride)).to(device)
    out = out * wy[:, None, :, None, None] * wx[None, :, None, :, None]
    full = _overlap_add_y(_overlap_add_x(out, stride, wp), stride, hp)
    return full[:h, :w]
