"""LightNet's whole SpanConv stack plus the lms residual, on
[B, C, H, W].

Counterpart of `lgteun_tpu/ops/lightnet_kernel.py::lightnet_fused_forward`
(Pallas) and the flax `LightNetModule` it reproduces. Each of the ten
layers of `lightnet_layers` is

    x <- DW1(PW1 x + pb1) + db1 + DW2(PW2 x + pb2) + db2   (ReLU if marked)

with 1x1 pointwise convs PW and 3x3 depthwise convs DW (zero padding);
the stack returns lms + x.

`lightnet_stack` launches `csrc/lightnet.cu` (three launches of 4, 3 and
3 layers; see the source note) for a CUDA tensor and runs
`lightnet_stack_ref` for a CPU tensor. `layers` holds, per layer in
table order, the torch conv tensors (pw1 [cout, cin, 1, 1], pb1 [cout],
dw1 [cout, 1, 3, 3], db1 [cout], pw2, pb2, dw2, db2).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda

__all__ = ["lightnet_layers", "lightnet_stack", "lightnet_stack_ref"]

_CHUNK = 8                          # csrc/lightnet.cu kChunk
_TILE = 16                          # csrc/lightnet.cu kT
_GROUPS = ((0, 4), (4, 7), (7, 10))  # layers per launch
_SMEM_MAX = 232448                  # shared memory a block may use, bytes


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


def _layer_len(cin: int, coutp: int) -> int:
    return 2 * coutp * (cin + 11)


def _pack(layers, table, device):
    """-> (weights, groups): the packed float32 buffer the kernel reads,
    and per launch of `_GROUPS` (rows, layers, cout) with rows a CPU
    int32 [n, 5] table of (cin, cout, coutp, relu, offset). Per layer at
    `offset`: pw [cin][2][coutp], pb [2][coutp], dw [2][coutp][9],
    db [2][coutp], branch 1 first; coutp is cout rounded up to the
    kernel's chunk of 8, the padding zero. Raises unless the weights are
    contiguous float32 tensors on `device` in `table`'s shapes and every
    launch fits a block's shared memory (checked here, once per weight
    version, not on every call)."""
    flat = {f"weight{i}": t for i, t in
            enumerate(t for layer in layers for t in layer)}
    want = [shp for _n, cin, cout, _r in table for shp in
            ((cout, cin, 1, 1), (cout,), (cout, 1, 3, 3), (cout,)) * 2]
    if [tuple(t.shape) for t in flat.values()] != want:
        raise ValueError(f"lightnet_stack: weights do not match "
                         f"lightnet_layers({table[-1][2]})")
    _cuda.check_cuda_f32("lightnet_stack", device, **flat)
    parts, rows, off = [], [], 0
    for layer, (_n, cin, cout, relu) in zip(layers, table, strict=True):
        pw1, pb1, dw1, db1, pw2, pb2, dw2, db2 = layer
        coutp = -(-cout // _CHUNK) * _CHUNK
        pw = torch.zeros(cin, 2, coutp, device=device)
        pb = torch.zeros(2, coutp, device=device)
        dw = torch.zeros(2, coutp, 9, device=device)
        db = torch.zeros(2, coutp, device=device)
        for br, (w, bias, k, kb) in enumerate(((pw1, pb1, dw1, db1),
                                               (pw2, pb2, dw2, db2))):
            pw[:, br, :cout] = w.reshape(cout, cin).t()
            pb[br, :cout] = bias
            dw[br, :cout] = k.reshape(cout, 9)
            db[br, :cout] = kb
        parts += [pw.flatten(), pb.flatten(), dw.flatten(), db.flatten()]
        rows.append((cin, cout, coutp, int(relu), off))
        off += _layer_len(cin, coutp)
    rows = torch.tensor(rows, dtype=torch.int32)
    groups, in_c = [], table[0][1]
    for l0, l1 in _GROUPS:
        smem = _group_smem(rows[l0:l1].tolist(), in_c)
        if smem > _SMEM_MAX:
            raise ValueError(f"lightnet_stack: layers {l0}..{l1 - 1} need "
                             f"{smem} B of shared memory (> {_SMEM_MAX}) "
                             f"at {table[-1][2]} bands")
        in_c = table[l1 - 1][2]
        groups.append((rows[l0:l1], l1 - l0, in_c))
    return torch.cat(parts), groups


def _packed(layers, table, device):
    """`_pack`, made once per weight version."""
    flat = [t for layer in layers for t in layer]
    return _cuda.weight_layout("lightnet", flat,
                               lambda: _pack(layers, table, device))


def _group_smem(rows, in_c: int) -> int:
    """Bytes of shared memory one launch over `rows` takes (as
    csrc/lightnet.cu::group_smem computes them)."""
    r0 = _TILE + 2 * len(rows)
    cmax = max([in_c] + [max(r[0], r[1]) for r in rows])
    w_len = _layer_len(rows[-1][0], rows[-1][2]) + rows[-1][4] - rows[0][4]
    return 4 * (w_len + 2 * cmax * r0 * r0 + 2 * _CHUNK * r0 * r0)


def lightnet_stack(x, lms, layers: Sequence[Sequence[torch.Tensor]]):
    """lms + stack(x): x [B, C+1, H, W] (pan then lms), lms [B, C, H, W]."""
    if x.device.type == "cpu":
        return lightnet_stack_ref(x, lms, layers)
    if x.device.type != "cuda":
        raise ValueError(f"lightnet_stack: unsupported device {x.device}")
    b, c5, h, w = x.shape
    if tuple(lms.shape) != (b, c5 - 1, h, w):
        raise ValueError(f"lightnet_stack: x {tuple(x.shape)}, lms "
                         f"{tuple(lms.shape)}")
    _cuda.check_cuda_f32("lightnet_stack", x.device, x=x, lms=lms)
    if torch.is_grad_enabled() and any(t.requires_grad for layer in layers
                                       for t in layer):
        raise RuntimeError("lightnet_stack: a weight requires grad, but the "
                           "kernel has no backward")
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
