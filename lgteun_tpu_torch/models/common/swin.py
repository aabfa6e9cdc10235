"""Swin-transformer machinery of PanFormer (counterpart of
`lgteun_tpu/models/common/swin.py`; reference modules.py:278-502).

The modules here work on NHWC [B, H, W, C] tensors, as the JAX code's
window index arithmetic does; `CrossSwinTransformer` turns its NCHW
inputs around once. The attention is batched matmuls and a softmax, one
code path on every device (the JAX package runs it as XLA einsums, no
kernel).

Reference quirks kept:
- the shifted windows' masks are -1e9, not -inf, and are added to the
  last row of windows (upper/lower) and to every nw_w-th window
  (left/right), as the reference places them (modules.py:412-414);
- cross-attention takes k and v from x and q from the *raw* y: only x
  is LayerNormed (modules.py:295-303, 383-386); the projections have no
  bias; the relative position table is (2w - 1)^2, drawn from N(0, 1);
- exact-erf GELU, LayerNorm eps 1e-5; PatchMerging flattens each patch
  channel-outermost (torch's unfold); y is merged once, with x's
  weights.

The attribute names are the reference's, so `state_dict()` carries its
keys (`patch_partition.linear.weight`,
`layers.0.1.attention_block.fn.fn.to_kv.weight`,
`layers.0.0.mlp_block.fn.fn.net.2.bias`, ...). The shifted blocks' masks
are recomputed and not stored; a reference state_dict that carries them
(`...attention_block.fn.fn.upper_lower_mask` / `left_right_mask`, -inf
where masked) still loads: each is checked against the recomputed mask
and then dropped, and a mask that differs fails the load.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

__all__ = ["WindowAttention", "SwinBlock", "PatchMerging", "SwinModule"]

_NEG_INF = -1e9  # in place of float('-inf'), as the JAX package


class _Linear(nn.Linear):
    """nn.Linear with torch's default init drawn from a generator."""

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)


class _LayerNorm(nn.LayerNorm):
    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


@functools.lru_cache(maxsize=None)
def _relative_index(window_size: int) -> np.ndarray:
    """[w², w², 2] relative (dy, dx) + (w - 1) of every token pair."""
    coords = np.array([[y, x] for y in range(window_size)
                       for x in range(window_size)])
    return coords[None, :, :] - coords[:, None, :] + window_size - 1


@functools.lru_cache(maxsize=None)
def _shift_masks(window_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(upper_lower, left_right) additive [w², w²] masks."""
    d = window_size // 2
    n = window_size * window_size
    ul = np.zeros((n, n), np.float32)
    ul[-d * window_size:, :-d * window_size] = _NEG_INF
    ul[:-d * window_size, -d * window_size:] = _NEG_INF
    lr = np.zeros((window_size,) * 4, np.float32)
    lr[:, -d:, :, :-d] = _NEG_INF
    lr[:, :-d, :, -d:] = _NEG_INF
    return ul, lr.reshape(n, n)


# The device constants below are made once and kept: outside inference
# mode, so that a training step may save them after an inference call
# made them.

@functools.lru_cache(maxsize=None)
def _window_mask(window_size: int, nw_h: int, nw_w: int,
                 device: torch.device, last: bool = True) -> torch.Tensor:
    """[nw_h * nw_w, w², w²] mask of the shifted windows on `device`:
    the left/right mask on every band's last window, the upper/lower one
    on the last band where it is the plane's (`last`; False for a strip
    above it, `parallel/spatial.py`)."""
    ul, lr = _shift_masks(window_size)
    mask = np.zeros((nw_h * nw_w,) + ul.shape, np.float32)
    if last:
        mask[-nw_w:] += ul
    mask[nw_w - 1::nw_w] += lr
    with torch.inference_mode(False):
        return torch.tensor(mask, device=device)


@functools.lru_cache(maxsize=None)
def _relative_index_on(window_size: int, device: torch.device):
    with torch.inference_mode(False):
        idx = torch.tensor(_relative_index(window_size), device=device)
        return idx[..., 0], idx[..., 1]


class WindowAttention(nn.Module):
    """(Shifted-)window MHSA with the relative position table, optionally
    cross: q from y (reference modules.py:341-422). NHWC in and out; H and
    W multiples of the window."""

    def __init__(self, dim: int, heads: int, head_dim: int, shifted: bool,
                 window_size: int, cross_attn: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.shifted, self.window_size = shifted, window_size
        self.cross_attn = cross_attn
        if cross_attn:
            self.to_kv = _Linear(dim, inner * 2, bias=False)
            self.to_q = _Linear(dim, inner, bias=False)
        else:
            self.to_qkv = _Linear(dim, inner * 3, bias=False)
        self.pos_embedding = nn.Parameter(torch.empty(2 * window_size - 1,
                                                      2 * window_size - 1))
        self.to_out = _Linear(inner, dim)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        self.pos_embedding.normal_(0.0, 1.0, generator=generator)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        if self.shifted:
            for key, want in zip(("upper_lower_mask", "left_right_mask"),
                                 _shift_masks(self.window_size)):
                got = state_dict.pop(prefix + key, None)
                if got is None:
                    continue
                got = torch.where(torch.isneginf(got), _NEG_INF, got.float())
                if not torch.equal(got.cpu(), torch.from_numpy(want)):
                    error_msgs.append(f"{prefix}{key}: not the mask of a "
                                      f"shifted {self.window_size}x"
                                      f"{self.window_size} window")
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None
                ) -> torch.Tensor:
        w, d = self.window_size, self.window_size // 2
        if not self.shifted:
            return self.attend(x, y)
        x = torch.roll(x, (-d, -d), dims=(1, 2))
        if self.cross_attn and y is not None:
            y = torch.roll(y, (-d, -d), dims=(1, 2))
        out = self.attend(x, y, _window_mask(w, x.shape[1] // w,
                                             x.shape[2] // w, x.device))
        return torch.roll(out, (d, d), dims=(1, 2))

    def attend(self, x: torch.Tensor, y: torch.Tensor | None = None,
               mask: torch.Tensor | None = None) -> torch.Tensor:
        """The attention of x's windows (q from y where cross), NHWC in
        and out, `mask` added to the logits: the forward without its
        rolls."""
        w = self.window_size
        b, n_h, n_w, _ = x.shape
        nw_h, nw_w = n_h // w, n_w // w
        if self.cross_attn:
            k, v = self.to_kv(x).chunk(2, dim=-1)
            q = self.to_q(y)
        else:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)

        def to_windows(t):
            t = t.reshape(b, nw_h, w, nw_w, w, self.heads, self.head_dim)
            return t.permute(0, 5, 1, 3, 2, 4, 6).reshape(
                b, self.heads, nw_h * nw_w, w * w, self.head_dim)

        q, k, v = map(to_windows, (q, k, v))
        dots = torch.matmul(q, k.transpose(-2, -1)) * self.head_dim ** -0.5
        dots = dots + self.pos_embedding[_relative_index_on(w, x.device)]
        if mask is not None:
            dots = dots + mask
        out = torch.matmul(dots.softmax(dim=-1), v)
        out = out.reshape(b, self.heads, nw_h, nw_w, w, w, self.head_dim)
        out = out.permute(0, 2, 4, 3, 5, 1, 6).reshape(
            b, n_h, n_w, self.heads * self.head_dim)
        return self.to_out(out)


class _PreNorm(nn.Module):
    """fn(LayerNorm(x), *rest): only the first input is normalised."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = _LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, *rest):
        return self.fn(self.norm(x), *rest)


class _Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *rest):
        return self.fn(x, *rest) + x


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(_Linear(dim, hidden), nn.GELU(),
                                 _Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class SwinBlock(nn.Module):
    """x + attn(LN x, y), then x + MLP(LN x) (reference
    modules.py:425-440)."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int,
                 shifted: bool, window_size: int, cross_attn: bool = False):
        super().__init__()
        self.attention_block = _Residual(_PreNorm(dim, WindowAttention(
            dim, heads, head_dim, shifted, window_size, cross_attn)))
        self.mlp_block = _Residual(_PreNorm(dim, _FeedForward(dim, mlp_dim)))

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None
                ) -> torch.Tensor:
        return self.mlp_block(self.attention_block(x, y))


class PatchMerging(nn.Module):
    """ds x ds patches (channel outermost, as torch's unfold) -> linear.
    NHWC in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 downscaling_factor: int):
        super().__init__()
        self.ds = downscaling_factor
        self.linear = _Linear(in_channels * downscaling_factor ** 2,
                              out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ds = self.ds
        b, h, w, c = x.shape
        if ds > 1:
            x = x.reshape(b, h // ds, ds, w // ds, ds, c).permute(
                0, 1, 3, 5, 2, 4).reshape(b, h // ds, w // ds, c * ds * ds)
        return self.linear(x)


class SwinModule(nn.Module):
    """Patch merge, then `layers` alternating regular / shifted blocks
    (reference modules.py:458-502). NHWC in and out; y (cross-attention's
    query stream) is merged with the same weights."""

    def __init__(self, in_channels: int, hidden_dimension: int, layers: int,
                 downscaling_factor: int, num_heads: int, head_dim: int,
                 window_size: int, cross_attn: bool = False):
        super().__init__()
        self.patch_partition = PatchMerging(in_channels, hidden_dimension,
                                            downscaling_factor)
        block = functools.partial(
            SwinBlock, hidden_dimension, num_heads, head_dim,
            hidden_dimension * 4, window_size=window_size,
            cross_attn=cross_attn)
        self.layers = nn.ModuleList(
            nn.ModuleList([block(shifted=False), block(shifted=True)])
            for _ in range(layers // 2))

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None
                ) -> torch.Tensor:
        x = self.patch_partition(x)
        if y is not None:
            y = self.patch_partition(y)
        for regular, shifted in self.layers:
            x = shifted(regular(x, y), y)
        return x

