"""The FFT mixer's cluster route (planes above 240^2 up to 512^2 and
1024 x 512), on the CPU.

Where a plane's half spectrum exceeds one block's shared memory but the
shared memory of a thread-block cluster holds it, `ln_mixer_head` (B1)
and `global_mixer` (B4) run it in one launch on the card
(`csrc/fft_mixer.cuh::fft_mixer_plane_cluster`): block j of the cluster
keeps rows [j rows, (j + 1) rows) of the half spectrum, runs their W
forward and split, then its own range of columns a chunk at a time,
gathered from every block's rows into a stage, through the H passes and
the amp/phase mixer and scattered back, then the c2r and W inverse of
its rows. These tests hold the route's Python mirror (`mixer_route`,
`fft_cluster_plan`, `cluster_size`) at the capacity boundaries, an
emulation of the partition in float32 (`test_torch_port_fft_plan.py`'s
passes on the blocks' rows, column ranges, chunks and the exchange)
against the one-block emulation bit for bit and against
`global_mixer_ref`, exact zero bins on planes constant along an axis,
and the plain mixer against the JAX package's at 264^2. The card holds
the route bit-equal to the one-block body and to the global route in
`chip_smoke.py`'s `large` phase.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lgteun_tpu.ops.spectral_kernel import global_mixer_xla_cm
from lgteun_tpu_torch.ops.spectral_kernel import (FFT_CLUSTERS,
                                                  FFT_PLAN_FLOATS,
                                                  FFT_SMEM_BYTES, H100_SMS,
                                                  cluster_size,
                                                  fft_cluster_plan,
                                                  fft_global_plan,
                                                  fft_mixer_plan,
                                                  global_mixer_ref,
                                                  mixer_route)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_fft_plan import (_complex, _plane, _positions,  # noqa
                                      _rel, _tables, combine, emulate,
                                      fft_pass, mix_bin, rows_inverse,
                                      split)
from test_torch_port_lgb_engines import _mixer_params  # noqa: E402
from test_torch_port_ops import f32, max_err  # noqa: E402

PARAMS = (0.9, 0.05, 1.3, 0.1)  # amp_w, amp_b, pha_w, pha_b

# (H, W) -> (route, k, rows, cols a block) by shape alone (planes enough
# to fill the card, so no cluster is made larger): the one-block body up
# to 240^2; from 242^2 (238,240 bytes of half spectrum) a cluster of two
# up to 264^2, eight at 512^2 (four hold 128 rows of 2,056 bytes: 263
# KB), sixteen at 1024 x 512; the global route at 1000^2 and 1024^2,
# where sixteen blocks' rows alone exceed a block (63 or 64 rows of 4 KB)
ROUTES = {(240, 240): ("smem", None, None, None),
          (242, 242): ("cluster", 2, 121, 61),
          (256, 256): ("cluster", 2, 128, 65),
          (264, 264): ("cluster", 2, 132, 67),
          (512, 512): ("cluster", 8, 64, 33),
          (1024, 512): ("cluster", 16, 64, 17),
          (1000, 1000): ("global", None, 28, 14),
          (1024, 1024): ("global", None, 27, 13)}


@pytest.mark.parametrize("hw", sorted(ROUTES))
def test_cluster_route_mirror(hw):
    """The route by shape at the capacity boundaries: one launch (the
    head one more) and no scratch on the cluster route, with the
    smallest k of 2, 4, 8, 16 whose blocks hold their rows (H / k
    rounded up, the plan first) and at least one staged column; the
    columns a block (N + 1 over k, rounded up) in chunks of an odd
    pitch, the whole within 232,448 bytes; three launches on a scratch
    where no cluster holds the plane."""
    h, w = hw
    route, k, rows, cols = ROUTES[hw]
    plan, n = fft_mixer_plan(h, w), w // 2
    got = mixer_route(h, w, planes=H100_SMS)
    head = mixer_route(h, w, planes=H100_SMS, head=True)
    assert (got["route"], got["k"]) == (route, k)
    assert (got["rows"], got["cols"]) == (rows, cols)
    if route == "smem":
        assert plan["smem"] <= FFT_SMEM_BYTES
        return
    assert plan["smem"] > FFT_SMEM_BYTES
    if route == "global":
        assert all(fft_cluster_plan(h, w, kk) is None for kk in FFT_CLUSTERS)
        assert (got["launches"], head["launches"]) == (3, 4)
        return
    assert (got["launches"], head["launches"]) == (1, 2)
    assert got["scratch_bytes"] == 0
    assert all(fft_cluster_plan(h, w, kk) is None for kk in FFT_CLUSTERS
               if kk < k)
    c = fft_cluster_plan(h, w, k)
    assert (c["rows"], c["cols"]) == (rows, cols)
    assert k * rows >= h > (k - 1) * rows
    assert k * cols >= n + 1 > (k - 1) * cols
    assert c["chunks"] * c["chunk"] >= cols > (c["chunks"] - 1) * c["chunk"]
    assert c["pitch"] % 2 == 1 and c["pitch"] - c["chunk"] in (0, 1)
    mine = 4 * FFT_PLAN_FLOATS + 8 * rows * plan["ld"]
    assert c["smem"] == mine + 8 * h * c["pitch"] <= FFT_SMEM_BYTES
    # one chunk fewer would not fit
    if c["chunks"] > 1:
        wider = -(-cols // (c["chunks"] - 1))
        assert mine + 8 * h * (wider | 1) > FFT_SMEM_BYTES
    # the cluster route takes only planes the global route takes
    assert fft_global_plan(h, w) is not None


@pytest.mark.parametrize("planes,k", [(1, 16), (4, 16), (8, 8), (16, 4),
                                      (17, 2), (32, 2), (512, 2)])
def test_cluster_grows_where_planes_are_few(planes, k):
    """At 256^2 (two blocks hold a plane) the launch doubles the cluster
    while its clusters take at most half of the H100's 132 SMs, one
    block an SM: 16 planes run on four blocks each (64 blocks), 32 and
    more on two; at most 16."""
    got = mixer_route(256, 256, planes=planes)
    assert (got["route"], got["k"]) == ("cluster", k)
    assert got["rows"] == 256 // k and got["cols"] == -(-129 // k)
    assert cluster_size(2, planes) == k
    assert k == 2 or planes * k <= H100_SMS // 2
    assert k == 16 or planes * 2 * k > H100_SMS // 2


def test_routes_take_what_they_took():
    """The three routes take the planes the one-block body and the
    global route took before the cluster route (a route exactly where
    there is a plan and, above one block, a global plan): on even sides
    2-1200 by steps of 14 and the boundaries' neighbours, whatever the
    plane count."""
    sides = sorted(set(range(2, 1202, 14)) | {238, 240, 242, 512, 514,
                                              1022, 1024, 1026})
    for h in sides:
        for w in sides:
            plan = fft_mixer_plan(h, w)
            before = plan is not None and (plan["smem"] <= FFT_SMEM_BYTES
                                           or fft_global_plan(h, w)
                                           is not None)
            for planes in (1, 64):
                got = mixer_route(h, w, planes)
                assert (got is not None) == before, (h, w)
                if got is not None and got["route"] == "cluster":
                    assert fft_cluster_plan(h, w, got["k"]) is not None


def emulate_cluster(x, k, prm=PARAMS):
    """The cluster route on one plane x [H, W] on k blocks, block by
    block: (1) block j's rows through the W forward passes and the split
    into its own rows [rows][ld] (the padding is never read: NaN); (2)
    block j's columns [j cols, (j + 1) cols) `chunk` at a time: each
    chunk gathered from every block's rows into a stage [H][pitch], the
    H forward passes, the amp/phase mixer and the H inverse passes there,
    and scattered back into the blocks' rows (the blocks touch disjoint
    columns, so running them in turn is running them at once); (3) block
    j's rows through the c2r and the W inverse passes. Returns (out, the
    spectrum after the H forward passes [N + 1, H] in position order)."""
    h, w = x.shape
    n, dtype = w // 2, x.dtype
    plan, c = fft_mixer_plan(h, w), fft_cluster_plan(h, w, k)
    rows, cols, chunk, pitch = c["rows"], c["cols"], c["chunk"], c["pitch"]
    tw_row, tw_half, tw_col, pos = _tables(h, w, dtype)
    span_of = [(min(j * rows, h), min((j + 1) * rows, h)) for j in range(k)]
    mine = [torch.full((rows, plan["ld"], 2), float("nan"), dtype=dtype)
            for _ in range(k)]
    for (r0, r1), rows_j in zip(span_of, mine):
        if r1 == r0:
            continue
        z, span = x[r0:r1].reshape(-1, n, 2), n
        for r in plan["row"]:
            z = fft_pass(z, n, span, r, tw_row, False)
            span //= r
        rows_j[:r1 - r0, :n + 1] = split(z, tw_half, pos)
    spec = torch.empty(n + 1, h, 2, dtype=dtype)
    q = torch.arange(h).view(1, h)
    for j in range(k):
        end = min((j + 1) * cols, n + 1)
        for c0 in range(j * cols, end, chunk):
            nc = min(chunk, end - c0)
            stage = torch.full((h, pitch, 2), float("nan"), dtype=dtype)
            for (r0, r1), rows_i in zip(span_of, mine):
                stage[r0:r1, :nc] = rows_i[:r1 - r0, c0:c0 + nc]
            part, span = stage[:, :nc].transpose(0, 1), h
            for r in plan["col"]:
                part = fft_pass(part, h, span, r, tw_col, False)
                span //= r
            spec[c0:c0 + nc] = part
            col = torch.arange(c0, c0 + nc).view(nc, 1)
            edge = ((col == 0) | (col == n)) & ((q == 0) | (q == plan["qh"]))
            part = mix_bin(part, edge, prm)
            for r in reversed(plan["col"]):
                span *= r
                part = fft_pass(part, h, span, r, tw_col, True)
            stage[:, :nc] = part.transpose(0, 1)
            for (r0, r1), rows_i in zip(span_of, mine):
                rows_i[:r1 - r0, c0:c0 + nc] = stage[r0:r1, :nc]
    out = torch.empty(h, w, dtype=dtype)
    norm = torch.tensor(1.0 / (h * w), dtype=dtype)
    for (r0, r1), rows_j in zip(span_of, mine):
        if r1 == r0:
            continue
        z = rows_inverse(combine(rows_j[:r1 - r0, :n + 1], tw_half, pos),
                         plan, tw_row)
        out[r0:r1] = (z * norm).abs().reshape(-1, w)
    return out, spec


@pytest.mark.parametrize("h,w,k", [(256, 256, 2), (264, 264, 2),
                                   (264, 520, 4), (240, 240, 4),
                                   (128, 128, 16)])
def test_emulated_cluster_matches_one_block(h, w, k):
    """float32: the cluster's partition gives the one-block body's
    emulated output bit for bit (each value takes the same arithmetic,
    only the blocks that run it differ), within 1e-5 of
    `global_mixer_ref` as the one-block emulation is held: 256^2 and
    264^2 on the two blocks they take (two chunks a block; 264^2 runs
    radix 3 and 11, the generic pass), 264 x 520 on four, and the
    forced sizes the card checks against the one-block body: 240^2 on
    four, 128^2 on sixteen (5 columns a block: the last three blocks
    have none)."""
    x = _plane(h, w, seed=6)
    c = fft_cluster_plan(h, w, k)
    assert c is not None
    if (h, w) != (128, 128):
        assert c["chunks"] == 2 or (h, w) == (240, 240)
    prm = torch.tensor(PARAMS, dtype=torch.float64)
    want = global_mixer_ref(x[None, None], *(v.view(1) for v in prm))[0, 0]
    got, _ = emulate_cluster(x.float(), k)
    assert got.dtype == torch.float32
    assert torch.equal(got, emulate(x.float())["out"])
    assert _rel(got.double(), want) <= 1e-5


@pytest.mark.parametrize("axis", ["H", "W"])
def test_emulated_cluster_keeps_exact_zeros(axis):
    """A float32 256^2 plane constant along H (equal rows) or along W
    (constant rows), on two blocks: every bin that is zero in exact
    arithmetic is exactly zero after the blocks' row passes and the
    chunks' column passes, and the output matches the plain version
    (which zeroes them, `plane_rfft2`) at a non-integer phase scale."""
    h = w = 256
    n = w // 2
    rng = np.random.default_rng(7)
    shape = (1, w) if axis == "H" else (h, 1)
    x = torch.from_numpy(np.broadcast_to(rng.standard_normal(shape),
                                         (h, w)).astype(np.float32))
    prm = (0.9, 0.5, 7.3, 0.1)
    got, spec = emulate_cluster(x, 2, prm)
    plan = fft_mixer_plan(h, w)
    cols = torch.cat([_positions(plan["row"], n), torch.tensor([n])])
    spec = _complex(spec[cols][:, _positions(plan["col"], h)]).transpose(0, 1)
    nonzero = torch.zeros(h, n + 1, dtype=torch.bool)
    if axis == "H":
        nonzero[0] = True
    else:
        nonzero[:, 0] = True
    assert torch.all(spec[~nonzero] == 0)
    assert torch.equal(got, emulate(x, prm)["out"])
    want = global_mixer_ref(x[None, None].double(),
                            *(torch.tensor([v], dtype=torch.float64)
                              for v in prm))[0, 0]
    assert _rel(got.double(), want) <= 1e-5


def test_plain_mixer_matches_jax_at_264():
    """`global_mixer_ref` (what the cluster route is held to on the card)
    against the JAX package's plain mixer (`global_mixer_xla_cm`,
    pocketfft on the CPU) at 264^2 (odd factors 3 and 11), integer phase
    scales (ROADMAP C.22), 3e-5, as at 256^2."""
    rng = np.random.default_rng(42)
    x = f32(rng, 1, 8, 264, 264)
    mix = _mixer_params(rng, 8, integer_phase=True)
    got = global_mixer_ref(torch.from_numpy(x), *map(torch.from_numpy, mix))
    want = global_mixer_xla_cm(*(jnp.asarray(a) for a in [x] + mix))
    assert max_err(got.numpy(), want) <= 3e-5
