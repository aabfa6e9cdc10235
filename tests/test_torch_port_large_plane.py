"""UnlgFormer on planes above 240^2 (the FFT mixer's global route and
B8's route by shape), on the CPU.

Above 240 x 240 a plane's half spectrum no longer fits one block's
shared memory, so `ln_mixer_head` (B1) and `global_mixer` (B4) run the
mixer on a thread-block cluster where one holds the plane (up to 512^2
and 1024 x 512: `test_torch_port_cluster_route.py`) and on the global
route above (`csrc/spectral_head.cu`): the same plan, tables and
butterflies as the one-block body, the half spectrum [H][ld] in a
scratch between three launches over ranges of rows and of columns (the
card also forces it on smaller planes, against the other routes); and
`lgb_block` (B8) runs level 2's chain there. These tests hold the
global route's Python mirror (`mixer_route`, `fft_global_plan`), an
emulation of its three parts in float32 (`test_torch_port_fft_plan.py`'s
passes, on the route's row and column ranges) against the one-block
emulation bit for bit and against `global_mixer_ref`, the plain mixer and
head against the JAX package's plain mixer at 256^2, a narrow UnlgFormer
at PAN 256^2 against JAX's channel-major forward (5e-4), and the level-3
launch mix by shape. The card runs the routes against the plain versions
in `chip_smoke.py`'s `large` phase.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.models.lgteun_fast import lgteun_fast_forward
from lgteun_tpu.ops.spectral_kernel import (global_mixer_xla_cm,
                                            ln_mixer_head_xla_cm)
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.models.common import lgt
from lgteun_tpu_torch.ops import lgb_block_kernel
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block, lgb_route
from lgteun_tpu_torch.ops.spectral_kernel import (FFT_GLOBAL_SMEM,
                                                  FFT_MAX_H, FFT_MAX_W,
                                                  FFT_MAX_W_ODD,
                                                  FFT_PLAN_FLOATS,
                                                  FFT_SMEM_BYTES,
                                                  _check_plane,
                                                  fft_global_plan,
                                                  fft_mixer_plan,
                                                  global_mixer_ref,
                                                  ln_mixer_head_ref,
                                                  mixer_route)
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_fft_plan import (_complex, _plane, _positions,  # noqa
                                      _rel, _tables, edge_bins, emulate,
                                      fft_pass, mix_bin, rows_back,
                                      rows_forward)
from test_torch_port_lgb_engines import _mixer_params  # noqa: E402
from test_torch_port_ops import f32, max_err  # noqa: E402

PARAMS = (0.9, 0.05, 1.3, 0.1)  # amp_w, amp_b, pha_w, pha_b

# (H, W) -> (route by shape of 16 planes, the global route's rows and
# cols a block for 16 planes on the H100's 132 SMs): the one-block body up
# to 240^2, a cluster to 264^2 here (`test_torch_port_cluster_route.py`),
# the global route above it; the global plan at every size it takes
# (forced on the cluster's planes by `lgteun_global_mixer_global_route`
# and `_head_global_route`)
ROUTES = {(240, 240): ("smem", None, None),
          (248, 248): ("cluster", 21, 11),
          (256, 256): ("cluster", 22, 11),
          (264, 264): ("cluster", 22, 12),
          (1000, 1000): ("global", 21, 11),
          (1024, 1024): ("global", 21, 11),
          (2048, 2048): ("global", 14, 7),
          (1024, 2048): ("global", 13, 13)}


@pytest.mark.parametrize("hw", sorted(ROUTES))
def test_route_mirror(hw):
    """Which route, launches, scratch and the global plan's range widths
    for 16 planes: the one-block body where the plan and half spectrum
    fit 232,448 bytes; else one launch (the head one more, its LN split)
    and no scratch on a cluster, or three launches on a scratch of the
    planes' half spectra [W/2 + 1][H] float2 on the global route; the
    global route's row and column ranges at most as large as half of the
    shared memory holds (two blocks an SM; the columns staged with the odd
    pitch H | 1), split evenly over the waves of 264 blocks, covering the
    plane."""
    h, w = hw
    route, rows, cols = ROUTES[hw]
    plan, half = fft_mixer_plan(h, w), w // 2 + 1
    got = mixer_route(h, w, planes=16)
    head = mixer_route(h, w, planes=16, head=True)
    assert got["route"] == route
    assert (plan["smem"] <= FFT_SMEM_BYTES) == (route == "smem")
    if route == "smem":
        assert (got["rows"], got["cols"]) == (None, None)
        assert (got["launches"], head["launches"]) == (1, 2)
        assert got["scratch_bytes"] == 0
        return
    if route == "cluster":
        assert (got["launches"], head["launches"]) == (1, 2)
        assert got["scratch_bytes"] == 0
    else:
        assert (got["rows"], got["cols"]) == (rows, cols)
        assert (got["launches"], head["launches"]) == (3, 4)
        assert got["scratch_bytes"] == 16 * 8 * h * half
    g, hd = fft_global_plan(h, w, 16), 4 * FFT_PLAN_FLOATS
    assert g["rows"] == rows and g["cols"] == cols
    assert g["plane_bytes"] == 8 * h * half
    assert (g["row_threads"], g["col_threads"]) == (256, 256)
    most, most_c = g["most_rows"], g["most_cols"]
    assert hd + 8 * plan["ld"] * most <= FFT_GLOBAL_SMEM
    assert most == h or hd + 8 * plan["ld"] * (most + 1) > FFT_GLOBAL_SMEM
    assert g["smem_rows"] == hd + 8 * plan["ld"] * rows and rows <= most
    assert g["pitch"] == h | 1
    assert hd + 8 * g["pitch"] * most_c <= FFT_GLOBAL_SMEM
    assert most_c == half or hd + 8 * g["pitch"] * (most_c + 1) > \
        FFT_GLOBAL_SMEM
    assert g["smem_cols"] == hd + 8 * g["pitch"] * cols and cols <= most_c
    assert g["row_blocks"] * rows >= h > (g["row_blocks"] - 1) * rows
    assert g["col_blocks"] * cols >= half > (g["col_blocks"] - 1) * cols


# planes the mixer refused before it took odd sides and prime factors
# above 512 (ROADMAP A.12.2) -> (route of 2 planes, launches, scratch
# bytes); B8 takes none of them (level 2's chain)
NEWLY_TAKEN = {(256, 255): ("cluster", 1, 0), (255, 256): ("cluster", 1, 0),
               (2062, 2062): ("global", 3, 2 * 8 * 2062 * 1032),
               (2 * 1031, 64): ("cluster", 1, 0),
               (64, 4 * 1031): ("cluster", 1, 0)}


@pytest.mark.parametrize("hw", sorted(NEWLY_TAKEN))
def test_route_refusals(hw):
    """An odd side or an odd prime factor above 512 (a side of 2 x 1031,
    or W/2 = 2 x 1031), once refused, now has a route: the one the
    mirror names, its launches and its scratch (the global route's
    [W/2 + 1][H] float2 a plane); `_check_plane` returns it, and B8
    runs level 2's chain there."""
    route, launches, scratch = NEWLY_TAKEN[hw]
    got = mixer_route(*hw, planes=2)
    assert (got["route"], got["launches"], got["scratch_bytes"]) == (
        route, launches, scratch)
    assert _check_plane("global_mixer", torch.empty(
        1, 2, *hw, device="meta")) == got
    assert lgb_route(*hw) == "chain"


@pytest.mark.parametrize("hw", [(FFT_MAX_H + 1, 2), (2, FFT_MAX_W + 2),
                                (3, FFT_MAX_W_ODD + 2), (1, 16), (16, 1),
                                (FFT_MAX_H + 2, FFT_MAX_W)])
def test_refusals_beyond_the_limits(hw):
    """Beyond H 14,514 and W 29,026 (odd W 14,513), or below 2, no route
    takes a plane; `_check_plane` raises naming those limits; at the
    limits every route rule still finds one."""
    assert mixer_route(*hw) is None and lgb_route(*hw) is None
    with pytest.raises(ValueError, match=r"2 <= H <= 14514 and 2 <= W <= "
                                         r"29026 \(odd W <= 14513\)"):
        _check_plane("global_mixer", torch.empty(1, 2, *hw, device="meta"))
    for h, w in ((FFT_MAX_H, 2), (2, FFT_MAX_W), (3, FFT_MAX_W_ODD),
                 (FFT_MAX_H, FFT_MAX_W)):
        assert mixer_route(h, w) is not None


def emulate_global(x, prm=PARAMS, planes=1):
    """The global route on one plane x [H, W], part by part: (a) each
    range of `rows` rows through the W forward (and the split) into the
    scratch, stored column by column [W/2 + 1][H]; (b) each range of
    `cols` columns, one run of the scratch, through the H forward
    passes, the amp/phase mixer and the H inverse passes, back into the
    scratch; (c) each range of rows read back column-wise through the W
    inverse. The ranges those of `planes` planes. Returns (out, the
    spectrum after the H forward passes [W/2 + 1, H] in position
    order)."""
    h, w = x.shape
    dtype, half = x.dtype, w // 2 + 1
    plan, g = fft_mixer_plan(h, w), fft_global_plan(h, w, planes)
    tw_row, tw_half, tw_col, pos = _tables(h, w, dtype)
    scratch = torch.full((half, h, 2), float("nan"), dtype=dtype)
    for r0 in range(0, h, g["rows"]):
        _, part = rows_forward(x[r0:r0 + g["rows"]], plan, tw_row, tw_half,
                               pos)
        scratch[:, r0:r0 + len(part)] = part.transpose(0, 1)
    spec = torch.empty(half, h, 2, dtype=dtype)
    for c0 in range(0, half, g["cols"]):
        cols, span = scratch[c0:c0 + g["cols"]], h
        nc = len(cols)
        for r in plan["col"]:
            cols = fft_pass(cols, h, span, r, tw_col, False)
            span //= r
        spec[c0:c0 + nc] = cols
        cols = mix_bin(cols, edge_bins(plan, h, c0, nc), prm)
        for r in reversed(plan["col"]):
            span *= r
            cols = fft_pass(cols, h, span, r, tw_col, True)
        scratch[c0:c0 + nc] = cols
    out = torch.empty(h, w, dtype=dtype)
    norm = torch.tensor(1.0 / (h * w), dtype=dtype)
    for r0 in range(0, h, g["rows"]):
        part = scratch[:, r0:r0 + g["rows"]].transpose(0, 1)
        out[r0:r0 + len(part)] = rows_back(part, plan, tw_row, tw_half, pos,
                                           norm)
    return out, spec


@pytest.mark.parametrize("hw", [(256, 256), (264, 520)])
def test_emulated_route_matches_plain(hw):
    """float32: the global route's three parts give the one-block body's
    emulated output bit for bit (each value takes the same arithmetic),
    within 1e-5 of `global_mixer_ref` (as the one-block emulation is
    held); 264 x 520 runs radix 11 and 13 on the generic pass. Both
    sizes take a cluster by shape: the card forces the global route on
    them (`lgteun_global_mixer_global_route`) and holds it bit-equal to
    the cluster route there."""
    h, w = hw
    assert mixer_route(h, w)["route"] == "cluster"
    assert fft_global_plan(h, w) is not None
    x = _plane(h, w, seed=4)
    prm = torch.tensor(PARAMS, dtype=torch.float64)
    want = global_mixer_ref(x[None, None], *(v.view(1) for v in prm))[0, 0]
    got, _ = emulate_global(x.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, emulate(x.float())["out"])
    assert _rel(got.double(), want) <= 1e-5


@pytest.mark.parametrize("axis", ["H", "W"])
def test_emulated_route_keeps_exact_zeros(axis):
    """A float32 256^2 plane constant along H (equal rows) or along W
    (constant rows): after the global route's row ranges and column
    ranges (forced there on the card) every bin that is zero in exact
    arithmetic is exactly zero, and the output matches the plain version
    (which zeroes them, `plane_rfft2`) at a non-integer phase scale."""
    h = w = 256
    n = w // 2
    rng = np.random.default_rng(5)
    shape = (1, w) if axis == "H" else (h, 1)
    x = torch.from_numpy(np.broadcast_to(rng.standard_normal(shape),
                                         (h, w)).astype(np.float32))
    prm = (0.9, 0.5, 7.3, 0.1)
    got, spec = emulate_global(x, prm)
    plan = fft_mixer_plan(h, w)
    cols = torch.cat([_positions(plan["row"], n), torch.tensor([n])])
    spec = _complex(spec[cols][:, _positions(plan["col"], h)]).transpose(0, 1)
    nonzero = torch.zeros(h, n + 1, dtype=torch.bool)
    if axis == "H":
        nonzero[0] = True
    else:
        nonzero[:, 0] = True
    assert torch.all(spec[~nonzero] == 0)
    want = global_mixer_ref(x[None, None].double(),
                            *(torch.tensor([v], dtype=torch.float64)
                              for v in prm))[0, 0]
    assert _rel(got.double(), want) <= 1e-5


def test_plain_mixer_and_head_match_jax_at_256():
    """`global_mixer_ref` and `ln_mixer_head_ref` (what the route is held
    to on the card) against the JAX package's plain mixer and head
    (`global_mixer_xla_cm`, `ln_mixer_head_xla_cm`, pocketfft on the CPU)
    at 256^2, integer phase scales (ROADMAP C.22), 3e-5; y1 1e-5."""
    rng = np.random.default_rng(40)
    x = f32(rng, 1, 8, 256, 256)
    mix = _mixer_params(rng, 8, integer_phase=True)
    got = global_mixer_ref(torch.from_numpy(x), *map(torch.from_numpy, mix))
    want = global_mixer_xla_cm(*(jnp.asarray(a) for a in [x] + mix))
    assert max_err(got.numpy(), want) <= 3e-5
    xh = f32(rng, 1, 16, 256, 256)
    params = [(1 + 0.1 * f32(rng, 16)).astype(np.float32),
              0.1 * f32(rng, 16)] + mix
    got_y1, got_x2 = ln_mixer_head_ref(torch.from_numpy(xh),
                                       *map(torch.from_numpy, params))
    want_y1, want_x2 = ln_mixer_head_xla_cm(*(jnp.asarray(a)
                                              for a in [xh] + params))
    assert max_err(got_y1.numpy(), want_y1) <= 1e-5
    assert max_err(got_x2.numpy(), want_x2) <= 3e-5


@pytest.fixture(scope="module")
def large_case():
    """A narrow UnlgFormer (4 bands: LGT width 16, K = 2) at PAN 256^2:
    flax weights, a batch and JAX lgteun_fast_forward's output (plain XLA
    on the CPU).

    The mixers' phase scales are integers in {-2, -1, 1, 2}, as every
    comparison of the mixer with the XLA references is made
    (`test_torch_port_lgb_engines.py`'s docstring): a bin on the negative
    real axis has phase +pi or -pi by the sign of its float32 rounding
    noise, and a non-integer scale turns that 2 pi into a value change.
    At 256^2 the seeded planes hold such bins: with the seeded scales one
    bin (|z| 8.4 of 4.8e4, imaginary part -9.5e-7 in the port's float32,
    +9.4e-7 in float64) moved the output by 6.9e-4, the same function on
    either side of the cut."""
    tree = flax_params(4, seed=6)
    rng = np.random.default_rng(41)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.choice([-2.0, -1.0, 1.0, 2.0], v.shape)
                         .astype(np.float32)
                         if path[-1].key == "pha_scale" else v), tree)
    batch = {"input_lr": rng.uniform(0, 1, (1, 64, 64, 4)).astype(
        np.float32),
             "input_pan": rng.uniform(0, 1, (1, 256, 256, 1)).astype(
                 np.float32)}
    want = jax.jit(lambda p, ms, pan: lgteun_fast_forward(p, ms, pan,
                                                          stage=2))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["input_lr"]),
        jnp.asarray(batch["input_pan"]))
    return tree, batch, np.asarray(want)


def _port(level, monkeypatch, tree):
    monkeypatch.setenv("LGTEUN_FUSE_LEVEL", str(level))
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    return port


def test_unlgformer_256_matches_jax(monkeypatch, large_case):
    """The port's UnlgFormer at PAN 256^2 (level 2: every block's planes
    above 240^2 but the bottleneck's) vs JAX's channel-major forward on
    the CPU, within the port's 5e-4 max-abs."""
    tree, batch, want = large_case
    got = _port(2, monkeypatch, tree).apply(batch).numpy()
    assert got.shape == want.shape == (1, 256, 256, 4)
    assert np.isfinite(got).all() and max_err(got, want) <= 5e-4


def test_level3_launch_mix_at_256(monkeypatch, large_case):
    """Level 3 at PAN 256^2: the forward's five `lgb_block` calls (four
    on 256^2 planes, one on the 128^2 bottleneck) give JAX's output
    (5e-4); replayed on meta tensors of their shapes with the launches
    stubbed, `lgb_block` routes the four 256^2 blocks to level 2's chain
    (one launch each of B1, B2, B3: 4 in all) and the bottleneck to B8
    (1 launch), as its counters count them on the card."""
    tree, batch, want = large_case
    shapes = []

    def spy(x, *args, **kw):
        shapes.append(tuple(x.shape))
        return lgb_block(x, *args, **kw)

    port = _port(3, monkeypatch, tree)
    monkeypatch.setattr(lgt, "lgb_block", spy)
    with torch.no_grad():
        got = port.apply(batch).numpy()
    assert max_err(got, want) <= 5e-4
    assert sorted(shapes) == sorted([(1, 16, 256, 256)] * 4
                                    + [(1, 32, 128, 128)])
    calls = dict.fromkeys(("ln_mixer_head", "window_attention",
                           "block_tail", "_launch"), 0)

    def stub(name, make):
        def call(*args, **kw):
            calls[name] += 1
            return make(*args)
        return call

    half = lambda x, *a: torch.empty(x.shape[0], x.shape[1] // 2,
                                     *x.shape[2:], device=x.device)
    monkeypatch.setattr(lgb_block_kernel, "ln_mixer_head", stub(
        "ln_mixer_head", lambda x, *a: (half(x), half(x))))
    monkeypatch.setattr(lgb_block_kernel, "window_attention", stub(
        "window_attention", lambda y1, *a: torch.empty_like(y1)))
    monkeypatch.setattr(lgb_block_kernel, "block_tail", stub(
        "block_tail", lambda x, *a: torch.empty_like(x)))
    monkeypatch.setattr(lgb_block_kernel, "_launch", stub(
        "_launch", lambda x, *a: torch.empty_like(x)))
    blk = dict.fromkeys(("ln_w", "ln_b", "amp_w", "amp_b", "pha_w",
                         "pha_b", "wqkv", "bqkv", "pos", "proj_w", "proj_b",
                         "ffn"))
    before = lgb_block.launches
    for shape in shapes:
        x = torch.empty(shape, device="meta")
        assert lgb_route(*shape[-2:]) == ("chain" if shape[-1] == 256
                                          else "block")
        lgb_block(x, blk)
    assert calls == {"ln_mixer_head": 4, "window_attention": 4,
                     "block_tail": 4, "_launch": 1}
    assert lgb_block.launches - before == 1
