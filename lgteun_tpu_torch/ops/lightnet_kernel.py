"""LightNet's whole SpanConv stack plus the lms residual, on
[B, C, H, W].

Counterpart of `lgteun_tpu/ops/lightnet_kernel.py::lightnet_fused_forward`
(Pallas) and the flax `LightNetModule` it reproduces. Each of the ten
layers of `lightnet_layers` is

    x <- DW1(PW1 x + pb1) + db1 + DW2(PW2 x + pb2) + db2   (ReLU if marked)

with 1x1 pointwise convs PW and 3x3 depthwise convs DW (zero padding);
the stack returns lms + x.

`lightnet_stack` launches `csrc/lightnet.cu` (five launches of two
layers, the pointwise convs on the tensor cores with the 3xTF32 split;
see the source note) for a CUDA tensor, differentiable there
(`ops.autograd.recompute`: the kernel forward, the plain version's
backward recomputed from the saved inputs, as the JAX package trains
through its flax chain), and runs `lightnet_stack_ref` for a CPU
tensor. `layers` holds, per layer in table order, the torch conv
tensors (pw1 [cout, cin, 1, 1], pb1 [cout], dw1 [cout, 1, 3, 3], db1
[cout], pw2, pb2, dw2, db2). The kernel reads them in its own layout
(`lightnet_fragments`: the pointwise weights split into TF32 hi/lo parts
in the mma.sync B fragments' order), made once per weight version.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.ffn_kernel import tf32_split

__all__ = ["lightnet_layers", "lightnet_stack", "lightnet_stack_ref",
           "lightnet_fragments", "group_smem"]

_CHUNK = 4                   # csrc/lightnet.cu kChunk
_TILE = 16                   # csrc/lightnet.cu kT
# layers per launch: two, so that a launch takes at most 112,256 bytes of
# shared memory at 32 channels and two blocks fit an SM
_GROUPS = ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10))
_SMEM_MAX = 232448           # shared memory a block may use, bytes


def lightnet_layers(ms_chans: int):
    """(name, cin, cout, relu_after) per SpanConv, in forward order
    (reference lightnet.py:85-135: head relu after head2, belly relu
    between conv1/conv2 of each block)."""
    c5 = ms_chans + 1
    return (
        ("head0", c5, c5, False),
        ("head1", c5, 20, False),
        ("head2", 20, 32, True),
        (("belly0", "conv1"), 32, 32, True),
        (("belly0", "conv2"), 32, 32, False),
        (("belly1", "conv1"), 32, 32, True),
        (("belly1", "conv2"), 32, 32, False),
        ("tail0", 32, 16, False),
        ("tail1", 16, 8, False),
        ("tail2", 8, ms_chans, False),
    )


def lightnet_stack_ref(x, lms, layers: Sequence[Sequence[torch.Tensor]]):
    """Plain version: the F.conv2d chain of the flax module."""
    table = lightnet_layers(lms.shape[1])
    for (pw1, pb1, dw1, db1, pw2, pb2, dw2, db2), (*_n, cout, relu) in zip(
            layers, table, strict=True):
        a = F.conv2d(F.conv2d(x, pw1, pb1), dw1, db1, padding=1, groups=cout)
        b = F.conv2d(F.conv2d(x, pw2, pb2), dw2, db2, padding=1, groups=cout)
        x = torch.relu(a + b) if relu else a + b
    return lms + x


def _ceil8(v: int) -> int:
    return -(-v // 8) * 8


def _layer_len(cin: int, coutp: int) -> int:
    """Floats of one layer in `lightnet_fragments`' layout."""
    return 4 * coutp * _ceil8(cin) + 22 * coutp


def lightnet_fragments(layers, table):
    """-> (weights, rows): the weight layout csrc/lightnet.cu reads, on
    the weights' device, and a CPU int32 [n, 5] table of (cin, cout,
    coutp, relu, offset) per layer. Per layer at `offset` floats:

    - frag [coutp/4][cinp/8][32][4]: for chunk q (4 output channels of
      both branches) and k-step ks, lane 4g + t's mma.sync B fragments
      {b0 hi, b1 hi, b0 lo, b1 lo} (`ffn_kernel.tf32_split`), b0 =
      W[8 ks + t][g], b1 = W[8 ks + t + 4][g] with W[k][c] the pointwise
      weight of input channel k and column c: branch c // 4, output
      channel 4 q + c % 4;
    - pb [coutp/4][8]: the pointwise biases in that column order;
    - dw [2][coutp][9], db [2][coutp]: the depthwise taps and biases.

    cinp and coutp are cin and cout rounded up to 8, the padding zero.
    The same bits on any device (the split is integer arithmetic)."""
    parts, rows, off = [], [], 0
    for layer, (_n, cin, cout, relu) in zip(layers, table, strict=True):
        pw1, pb1, dw1, db1, pw2, pb2, dw2, db2 = layer
        dev = pw1.device
        cinp, coutp = _ceil8(cin), _ceil8(cout)
        w = torch.zeros(2, coutp, cinp, device=dev)
        pb = torch.zeros(2, coutp, device=dev)
        dw = torch.zeros(2, coutp, 9, device=dev)
        db = torch.zeros(2, coutp, device=dev)
        for br, (pw_, pb_, dw_, db_) in enumerate(((pw1, pb1, dw1, db1),
                                                   (pw2, pb2, dw2, db2))):
            w[br, :cout, :cin] = pw_.reshape(cout, cin)
            pb[br, :cout] = pb_
            dw[br, :cout] = dw_.reshape(cout, 9)
            db[br, :cout] = db_
        q = coutp // _CHUNK
        # B [q][k][column], then [q][ks][half][t][g] -> [q][ks][g][t][half]
        bmat = w.view(2, q, _CHUNK, cinp).permute(1, 3, 0, 2).reshape(
            q, cinp, 2 * _CHUNK)
        frag = torch.cat([part.reshape(q, cinp // 8, 2, 4, 8).permute(
            0, 1, 4, 3, 2).reshape(q, cinp // 8, 32, 2)
            for part in tf32_split(bmat.contiguous())], dim=-1)
        pbc = pb.view(2, q, _CHUNK).permute(1, 0, 2)
        parts += [frag.flatten(), pbc.flatten(), dw.flatten(), db.flatten()]
        rows.append((cin, cout, coutp, int(relu), off))
        off += _layer_len(cin, coutp)
    return torch.cat(parts), torch.tensor(rows, dtype=torch.int32)


def _groups(rows, table):
    """Per launch of `_GROUPS`: (rows, layers, cout); raises unless each
    launch fits a block's shared memory."""
    groups = []
    for l0, l1 in _GROUPS:
        smem = group_smem(rows[l0:l1].tolist())
        if smem > _SMEM_MAX:
            raise ValueError(f"lightnet_stack: layers {l0}..{l1 - 1} need "
                             f"{smem} B of shared memory (> {_SMEM_MAX}) "
                             f"at {table[-1][2]} bands")
        groups.append((rows[l0:l1], l1 - l0, table[l1 - 1][2]))
    return groups


def _packed(layers, table, device):
    """(weights, groups): `lightnet_fragments` and the launches, made once
    per weight version. Raises unless the weights are contiguous float32
    tensors on `device` in `table`'s shapes (checked once per weight
    version, not on every call)."""
    flat = [t for layer in layers for t in layer]

    def make():
        want = [shp for _n, cin, cout, _r in table for shp in
                ((cout, cin, 1, 1), (cout,), (cout, 1, 3, 3), (cout,)) * 2]
        if [tuple(t.shape) for t in flat] != want:
            raise ValueError(f"lightnet_stack: weights do not match "
                             f"lightnet_layers({table[-1][2]})")
        _cuda.check_cuda_f32("lightnet_stack", device,
                             **{f"weight{i}": t for i, t in enumerate(flat)})
        weights, rows = lightnet_fragments(layers, table)
        return weights, _groups(rows, table)
    return _cuda.weight_layout("lightnet", flat, make)


def _act_stride(r: int) -> int:
    """csrc/lightnet.cu::act_stride: an r x r region's channel stride
    (its 16-pixel M-tiles rounded up to 8 or 24 mod 32 floats)."""
    m = -(-r * r // 16) * 16
    return m + (8 - m % 16) % 16


def _p_stride(r0: int) -> int:
    """csrc/lightnet.cu::p_stride."""
    m = -(-r0 * r0 // 16) * 16
    return m + (4 - m % 32) % 32


def group_smem(rows) -> int:
    """Bytes of shared memory one launch over `rows` (cin, cout, coutp,
    relu, offset) takes, as csrc/lightnet.cu::group_smem computes them:
    the two activation buffers (layer k's input in buffer k % 2, over its
    region 16 + 2 (n - k) a side), the pointwise chunk P and a layer's
    depthwise taps and biases."""
    n = len(rows)
    buf = [0, 0]
    for k, r in enumerate(rows):
        buf[k % 2] = max(buf[k % 2], _ceil8(r[0]) * _act_stride(
            _TILE + 2 * (n - k)))
    taps = max(20 * r[2] for r in rows)
    return 4 * (buf[0] + buf[1] + 2 * _CHUNK * _p_stride(_TILE + 2 * n)
                + taps)


def lightnet_stack(x, lms, layers: Sequence[Sequence[torch.Tensor]]):
    """lms + stack(x): x [B, C+1, H, W] (pan then lms), lms [B, C, H, W].
    On a CUDA tensor the kernel's forward, differentiable through
    `ops.autograd.recompute` (`_train_entry`)."""
    if _cuda.plain_on_cpu("lightnet_stack", x):
        return lightnet_stack_ref(x, lms, layers)
    b, c5, h, w = x.shape
    if tuple(lms.shape) != (b, c5 - 1, h, w):
        raise ValueError(f"lightnet_stack: x {tuple(x.shape)}, lms "
                         f"{tuple(lms.shape)}")
    return _train_entry(x, lms, layers)


def _train_entry(x, lms, layers):
    """`_stack_kernel` forward, `lightnet_stack_ref`'s backward recomputed
    from the saved inputs: the 10 x 8 layer tensors pass through
    `recompute` as flat positional tensors and are regrouped by layer on
    either side."""
    per = len(layers[0])
    regroup = lambda flat: [flat[i:i + per]
                            for i in range(0, len(flat), per)]
    return recompute(
        lambda x, lms, *flat: _stack_kernel(x, lms, regroup(flat)),
        lambda x, lms, *flat: lightnet_stack_ref(x, lms, regroup(flat)),
        x, lms, *(t for layer in layers for t in layer))


def _stack_kernel(x, lms, layers):
    """The five launches of `csrc/lightnet.cu` (no backward of its own)."""
    b, c5, h, w = x.shape
    _cuda.check_cuda_f32("lightnet_stack", x.device, x=x, lms=lms)
    weights, groups = _packed(layers, lightnet_layers(c5 - 1), x.device)
    act = x
    for k, (rows, n, cout) in enumerate(groups):
        out = torch.empty(b, cout, h, w, device=x.device)
        last = k == len(groups) - 1
        _cuda.launch("lgteun_lightnet_group", x.device, act, act.shape[1],
                     lms if last else None, weights, out, rows, n, b, h, w)
        lightnet_stack.launches += 1
        act = out
    return act


lightnet_stack.launches = 0
