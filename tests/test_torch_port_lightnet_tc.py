"""The arithmetic of LightNet's stack on the tensor cores, on the CPU.

The kernel (`csrc/lightnet.cu`) runs two layers a launch over 16x16
output tiles: per layer, the tile's region (16 + 2 (n - k) pixels a
side) in shared memory, the pointwise convs of both branches as mma.sync
m16n8k8 TF32 products with the 3xTF32 split (16-pixel M-tiles, a chunk
of 4 output channels of both branches as the 8 columns, K = cin padded
to 8), the bias added and the pixels outside the image set to 0, then
the depthwise taps on the FP32 cores (each branch summed from its bias
over the taps, then the two added), the ReLU, and lms on the last
launch. The weights are read in their own layout
(`lightnet_kernel.lightnet_fragments`: the B fragments' hi/lo parts in
the lanes' order).

These tests read that layout back element by element the way a lane
reads it, mirror the launches' grouping and shared memory in Python, and
emulate the kernel in torch tile by tile (the regions, the padding, the
three TF32 passes summed in float32 in k-step order, the depthwise order)
so that the card's checks are not spent on the arithmetic: within 2e-6
of float64, within 1e-5 of the plain version and within 2e-5 of the JAX
package's Pallas kernel in interpret mode, at 4 and 8 bands and on
ragged images.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.ops.lightnet_kernel import lightnet_fused_forward
from lgteun_tpu_torch.ops import lightnet_kernel
from lgteun_tpu_torch.ops.ffn_kernel import tf32_split
from lgteun_tpu_torch.ops.lightnet_kernel import (group_smem,
                                                  lightnet_fragments,
                                                  lightnet_layers,
                                                  lightnet_stack,
                                                  lightnet_stack_ref)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_lightnet import (_inputs, _port, _stack_args,  # noqa: E402
                                      flax_params)

TILE = 16
CHUNK = 4


def _ceil8(v):
    return -(-v // 8) * 8


def _layers(bands, seed):
    """Random weights in the stack's shapes: kaiming-like pointwise and
    depthwise kernels, biases U(+-0.1) (non-zero, so that the border
    zeroing matters)."""
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
    u = lambda n: torch.from_numpy(rng.uniform(-0.1, 0.1, n).astype(
        np.float32))
    layers = []
    for _n, cin, cout, _r in lightnet_layers(bands):
        span = []
        for _br in range(2):
            span += [t(cout, cin, 1, 1, scale=(2 / cout) ** 0.5), u(cout),
                     t(cout, 1, 3, 3, scale=(2 / 9 / cout) ** 0.5), u(cout)]
        layers.append(tuple(span))
    return layers


def _stack_inputs(bands, b, h, w, seed):
    rng = np.random.default_rng(seed)
    lms = torch.from_numpy(rng.uniform(0, 1, (b, bands, h, w)).astype(
        np.float32))
    pan = torch.from_numpy(rng.uniform(0, 1, (b, 1, h, w)).astype(np.float32))
    return torch.cat([pan, lms], dim=1), lms


def _layer_views(weights, cin, cout, coutp, off):
    """The layer's parts as the kernel addresses them: frag [coutp/4]
    [cinp/8][32][4], pb [coutp/4][8], dw [2][coutp][9], db [2][coutp]."""
    ks = _ceil8(cin) // 8
    q = coutp // CHUNK
    frag = weights[off:off + q * ks * 128].view(q, ks, 32, 4)
    at = off + q * ks * 128
    pb = weights[at:at + 2 * coutp].view(q, 8)
    dw = weights[at + 2 * coutp:at + 20 * coutp].view(2, coutp, 9)
    db = weights[at + 20 * coutp:at + 22 * coutp].view(2, coutp)
    return frag, pb, dw, db


def _b_operand(frag, q, ks):
    """B [8 k][8 columns] hi and lo of chunk q's k-step ks, read the way
    lane 4g + t reads its float4: b0 = B[t][g], b1 = B[t + 4][g], hi
    then lo."""
    hi = torch.full((8, 8), float("nan"))
    lo = torch.full((8, 8), float("nan"))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        b0h, b1h, b0l, b1l = frag[q, ks, lane].tolist()
        hi[t, g], hi[t + 4, g], lo[t, g], lo[t + 4, g] = b0h, b1h, b0l, b1l
    return hi, lo


@pytest.mark.parametrize("bands", [4, 8])
def test_fragments_are_the_mma_b_operand(bands):
    """Every float of `lightnet_fragments` read back through the lanes:
    chunk q's k-step ks is tf32_split of W[8 ks + k][column], column c =
    branch c // 4 and channel 4 q + c % 4, zero past cin and cout; the
    biases in that column order; the depthwise taps and biases as
    [2][coutp][9] and [2][coutp]; rows (cin, cout, coutp, relu, offset)
    with coutp = cout rounded up to 8 and each layer 16-byte aligned."""
    table = lightnet_layers(bands)
    layers = _layers(bands, seed=bands)
    weights, rows = lightnet_fragments(layers, table)
    assert rows.dtype == torch.int32
    end = 0
    for layer, (_n, cin, cout, relu), row in zip(layers, table,
                                                 rows.tolist()):
        pw1, pb1, dw1, db1, pw2, pb2, dw2, db2 = layer
        assert row[:4] == [cin, cout, _ceil8(cout), int(relu)]
        assert row[4] == end and row[4] % 4 == 0
        coutp = row[2]
        frag, pb, dw, db = _layer_views(weights, cin, cout, coutp, row[4])
        end = row[4] + 4 * coutp * _ceil8(cin) + 22 * coutp
        w = torch.zeros(2, coutp, _ceil8(cin))
        w[0, :cout, :cin] = pw1.reshape(cout, cin)
        w[1, :cout, :cin] = pw2.reshape(cout, cin)
        whi, wlo = tf32_split(w)
        for q in range(coutp // CHUNK):
            cols = torch.arange(8)
            br, ch = cols // 4, CHUNK * q + cols % 4
            for ks in range(_ceil8(cin) // 8):
                hi, lo = _b_operand(frag, q, ks)
                k = 8 * ks + torch.arange(8)
                assert torch.equal(hi, whi[br[None], ch[None], k[:, None]])
                assert torch.equal(lo, wlo[br[None], ch[None], k[:, None]])
            bias = torch.zeros(2, coutp)
            bias[0, :cout], bias[1, :cout] = pb1, pb2
            assert torch.equal(pb[q], bias[br, ch])
        want_dw = torch.zeros(2, coutp, 9)
        want_dw[0, :cout], want_dw[1, :cout] = dw1.view(cout, 9), \
            dw2.view(cout, 9)
        want_db = torch.zeros(2, coutp)
        want_db[0, :cout], want_db[1, :cout] = db1, db2
        assert torch.equal(dw, want_dw) and torch.equal(db, want_db)
    assert end == weights.numel()


def test_launches_fit_two_blocks_an_sm():
    """Five launches of two layers; at 4 and 8 bands each takes at most
    112,256 bytes of shared memory (two blocks an SM: 2 x (112,256 +
    1,024 reserved) <= 228 KB), as csrc/lightnet.cu's group_smem
    computes: the two activation buffers at channel strides of 8 or 24
    mod 32 floats, the pointwise chunk at 4 mod 32 and a layer's taps."""
    assert lightnet_kernel._GROUPS == ((0, 2), (2, 4), (4, 6), (6, 8),
                                       (8, 10))
    for bands in (4, 8):
        table = lightnet_layers(bands)
        _w, rows = lightnet_fragments(_layers(bands, 0), table)
        sizes = [group_smem(rows[a:b].tolist())
                 for a, b in lightnet_kernel._GROUPS]
        assert max(sizes) == 112_256
        assert 2 * (max(sizes) + 1024) <= 228 * 1024
    assert lightnet_kernel._act_stride(20) == 408
    assert lightnet_kernel._act_stride(18) == 344
    assert lightnet_kernel._p_stride(20) == 420
    for r in range(3, 40):
        assert lightnet_kernel._act_stride(r) % 32 in (8, 24)
        assert 0 <= lightnet_kernel._act_stride(r) - -(-r * r // 16) * 16 \
            < 16
        assert lightnet_kernel._p_stride(r) % 32 == 4


def test_fragment_loads_hit_every_bank_once():
    """The A-fragment loads (channel stride = 8 or 24 mod 32: lane 4g + t
    reads t cs + g) and the accumulator stores to P (stride = 4 mod 32:
    lane writes (2t) ps + g and (2t + 1) ps + g) touch 32 distinct
    banks."""
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    ps = lightnet_kernel._p_stride(20)
    for r in (20, 18, 16):
        cs = lightnet_kernel._act_stride(r)
        for addr in (t * cs + g, t * cs + g + 8, (t + 4) * cs + g):
            assert len(set(addr % 32)) == 32
    for addr in (2 * t * ps + g, (2 * t + 1) * ps + g):
        assert len(set(addr % 32)) == 32


def _split_trunc(t):
    """tc_tf32.cuh::split_tf32_trunc as the tensor cores read it: hi =
    tf32(t) rounded to nearest, lo = t - hi with its low 13 bits
    dropped."""
    hi = tf32_split(t.contiguous())[0]
    lo = (t - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def _mm3(a, bhi, blo):
    """a [P, 8] . B for one k-step as the kernel's three mma.sync passes
    (lo.hi, hi.lo, hi.hi), each product exact, summed in float32; the
    activations split as loaded (_split_trunc), the weights as
    `lightnet_fragments` stores them."""
    ah, al = _split_trunc(a)
    return (al @ bhi, ah @ blo, ah @ bhi)


def _pointwise(a, operands, pb, coutp):
    """The pointwise products of one layer on region pixels a [P, cinp]:
    per chunk, the accumulator over k-steps in the kernel's pass order,
    plus the bias: [P, 2, coutp] (branch, channel). `operands[q][ks]` is
    `_b_operand(frag, q, ks)`."""
    out = torch.zeros(a.shape[0], 2, coutp)
    for q, steps in enumerate(operands):
        acc = torch.zeros(a.shape[0], 8)
        for ks, (hi, lo) in enumerate(steps):
            for part in _mm3(a[:, 8 * ks:8 * ks + 8], hi, lo):
                acc = acc + part
        acc = acc + pb[q]
        out[:, 0, CHUNK * q:CHUNK * q + CHUNK] = acc[:, :4]
        out[:, 1, CHUNK * q:CHUNK * q + CHUNK] = acc[:, 4:]
    return out


def _fma(a, b, c):
    """float32 fmaf: the exact product and sum, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _depthwise(p, dw, db, relu):
    """[T, 2, coutp, R, R] -> [T, coutp, R - 2, R - 2] in the kernel's
    order: each branch's sum from its bias over the taps (dy, dx), then
    branch 1 + branch 2."""
    r = p.shape[-1]
    v = []
    for br in range(2):
        s = db[br][None, :, None, None].expand(p.shape[0], -1, r - 2, r - 2)
        for dy in range(3):
            for dx in range(3):
                s = _fma(p[:, br, :, dy:dy + r - 2, dx:dx + r - 2],
                         dw[br, :, 3 * dy + dx][None, :, None, None], s)
        v.append(s)
    v = v[0] + v[1]
    return torch.relu(v) if relu else v


def emulated_stack(x, lms, layers, zero_border=True):
    """The kernel's launches: each group of lightnet_kernel._GROUPS over
    16x16 tiles (all tiles at once), each tile's region read with zeros
    outside the image and in the padded channels, per layer the
    pointwise products (zero outside the image) and the depthwise taps
    over the shrinking region, the last layer's tile stored inside the
    image, lms added on the last launch. `zero_border=False` leaves the
    pointwise bias outside the image (the rule broken, for a test)."""
    b, _c, h, w = x.shape
    table = lightnet_layers(lms.shape[1])
    weights, rows = lightnet_fragments(layers, table)
    views = []
    for cin, cout, coutp, relu, off in rows.tolist():
        frag, pb, dw, db = _layer_views(weights, cin, cout, coutp, off)
        operands = [[_b_operand(frag, q, ks) for ks in range(
            _ceil8(cin) // 8)] for q in range(coutp // CHUNK)]
        views.append((operands, pb, dw, db, coutp, relu))
    ty, tx = -(-h // TILE), -(-w // TILE)
    y0 = torch.arange(ty).repeat_interleave(tx) * TILE
    x0 = torch.arange(tx).repeat(ty) * TILE
    act = x
    for gi, (l0, l1) in enumerate(lightnet_kernel._GROUPS):
        n = l1 - l0
        r0 = TILE + 2 * n
        ys = y0[:, None] - n + torch.arange(r0)            # [T, r0]
        xs = x0[:, None] - n + torch.arange(r0)
        inside = ((ys >= 0) & (ys < h))[:, :, None] & \
            ((xs >= 0) & (xs < w))[:, None, :]             # [T, r0, r0]
        yc, xc = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
        out = torch.full((b, table[l1 - 1][2], ty * TILE, tx * TILE),
                         float("nan"))
        for bi in range(b):
            region = act[bi][:, yc[:, :, None], xc[:, None, :]]  # [c,T,r,r]
            a = torch.zeros(len(y0), _ceil8(rows[l0, 0].item()), r0, r0)
            a[:, :act.shape[1]] = torch.where(inside[:, None], region.
                                              transpose(0, 1), 0.0)
            for k in range(n):
                operands, pb, dw, db, coutp, relu = views[l0 + k]
                rin = r0 - 2 * k
                pix = a.permute(0, 2, 3, 1).reshape(-1, a.shape[1])
                p = _pointwise(pix, operands, pb, coutp)
                p = p.view(len(y0), rin, rin, 2, coutp).permute(0, 3, 4, 1, 2)
                if zero_border:
                    sl = slice(k, r0 - k)
                    p = torch.where(inside[:, None, None, sl, sl], p, 0.0)
                a = _depthwise(p, dw, db, relu)
            tiles = a[:, :table[l1 - 1][2]]                # [T, c, 16, 16]
            out[bi] = tiles.view(ty, tx, -1, TILE, TILE).permute(
                2, 0, 3, 1, 4).reshape(-1, ty * TILE, tx * TILE)
        out = out[:, :, :h, :w]
        if gi == len(lightnet_kernel._GROUPS) - 1:
            out = out + lms
        act = out
    return act


def _float64_stack(x, lms, layers):
    return lightnet_stack_ref(x.double(), lms.double(),
                              [[t.double() for t in layer]
                               for layer in layers])


@pytest.mark.parametrize("bands,b,h,w", [(8, 1, 32, 32), (8, 2, 20, 36),
                                         (4, 1, 36, 20)])
def test_emulated_stack_is_fp32_accurate(bands, b, h, w):
    """The emulated kernel within 2e-6 of the float64 plain stack
    (relative to its largest value) and within 1e-5 of the float32 plain
    version, at 4 and 8 bands, on whole and ragged tiles."""
    layers = _layers(bands, seed=h + w)
    x, lms = _stack_inputs(bands, b, h, w, seed=bands)
    got = emulated_stack(x, lms, layers)
    exact = _float64_stack(x, lms, layers)
    assert torch.isfinite(got).all()
    assert (got.double() - exact).abs().max() <= 2e-6 * exact.abs().max()
    plain = lightnet_stack_ref(x, lms, layers)
    assert (got - plain).abs().max() <= 1e-5


def test_border_zeroing_matters():
    """Without the pointwise output zeroed outside the image (the bias
    left there, as a 1x1 conv gives), the emulation moves far beyond the
    1e-5 bound: these weights exercise the border rule (ROADMAP C.10) on
    every layer."""
    bands = 8
    layers = _layers(bands, seed=5)
    x, lms = _stack_inputs(bands, 1, 20, 20, seed=6)
    plain = lightnet_stack_ref(x, lms, layers)
    loose = emulated_stack(x, lms, layers, zero_border=False)
    assert (loose - plain).abs().max() > 1e-2


@pytest.mark.parametrize("bands", [4, 8])
def test_emulated_stack_matches_pallas_kernel(bands):
    """The emulated kernel on the port's LightNet weights vs the JAX
    package's fused Pallas kernel in interpret mode: atol 2e-5, as the
    plain version is held."""
    tree = flax_params(bands, seed=20 + bands)
    ms, pan = _inputs(bands, 1, 32, seed=7)
    x, lms, layers = _stack_args(_port(bands, tree), ms, pan)
    with torch.inference_mode():
        got = emulated_stack(x, lms, layers)
    want = lightnet_fused_forward(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(ms), jnp.asarray(pan),
                                  interpret=True)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)


def test_wrapper_on_cpu_counts_no_launch():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch."""
    bands = 4
    layers = _layers(bands, seed=1)
    x, lms = _stack_inputs(bands, 1, 16, 16, seed=2)
    before = lightnet_stack.launches
    got = lightnet_stack(x, lms, layers)
    assert lightnet_stack.launches == before
    assert torch.equal(got, lightnet_stack_ref(x, lms, layers))
