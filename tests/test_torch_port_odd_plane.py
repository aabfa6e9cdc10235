"""The FFT mixer on every plane JAX's kernels take: odd sides and prime
factors above 512 (ROADMAP A.12.2), on the CPU.

The kernel (`csrc/fft_mixer.cuh`) reads an even-W row as W/2 complex
points; an odd-W row it transforms as W complex points with imaginary
part 0, in decimation in time (the row loaded at digit-reversed
positions, the bins out in natural order), and back by the hermitian
extension and an inverse in decimation in frequency; odd H changes only
the self-conjugate bins; a radix above 512 takes the generic pass's
terms in its order (`fft_pass_prime`). These tests emulate that in
float64 and float32 (`test_torch_port_fft_plan.py`'s passes) and hold it
against `torch.fft` and `global_mixer_ref` at 15 x 21, 9 x 1042, 1042 x 9
and 521 x 64, assert the exact zero bins of planes constant along an
axis there, hold the global route's parts (`test_torch_port_large_plane.
emulate_global`) bit for bit to the one-block emulation, check the plan,
its tables and its limits, the port's plain mixer and head against the
JAX package's kernels' functions at such shapes, and a narrow UnlgFormer
on a PAN 8336 x 16 strip (8336 = 16 x 521) against JAX's forward. The
card runs the routes in `chip_smoke.py`'s `large` phase.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgteun_tpu.models.lgteun_fast import lgteun_fast_forward
from lgteun_tpu.ops.spectral_kernel import (fused_global_mixer_cm,
                                            fused_ln_mixer_head_cm,
                                            global_mixer_xla_cm,
                                            ln_mixer_head_xla_cm)
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_route
from lgteun_tpu_torch.ops.spectral_kernel import (FFT_MAX_H, FFT_MAX_PASS,
                                                  FFT_MAX_PRIME, FFT_MAX_W,
                                                  FFT_MAX_W_ODD,
                                                  FFT_PLAN_FLOATS,
                                                  fft_global_plan,
                                                  fft_mixer_plan, fft_plan,
                                                  fft_tables_ref,
                                                  global_mixer_ref,
                                                  ln_mixer_head_ref,
                                                  mixer_route)
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_fft_plan import (PARAMS, _complex, _plane,  # noqa
                                      _positions, _rel, _tables, _twiddles,
                                      emulate)
from test_torch_port_large_plane import emulate_global  # noqa: E402
from test_torch_port_lgb_engines import _mixer_params  # noqa: E402
from test_torch_port_ops import f32, max_err  # noqa: E402

@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers:
    the emulated passes' many small ops ran 300x slower on the pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# odd H and W; W/2 = 521 (the prime pass on the rows); 521 in H's plan
# (2 x 521); 521 rows
SIZES = [(15, 21), (9, 1042), (1042, 9), (521, 64)]


def _half_cols(h, w):
    """The half spectrum's columns in bin order: odd W holds bin k at
    column k, even W at position fft_pos(row, k) and bin W/2 at W/2."""
    if w % 2:
        return torch.arange(w // 2 + 1)
    plan, n = fft_mixer_plan(h, w), w // 2
    return torch.cat([_positions(plan["row"], n), torch.tensor([n])])


@pytest.mark.parametrize("h,w", SIZES)
def test_emulated_stages_match_torch_fft(h, w):
    """float64: the W forward leaves rfft(x) in the half spectrum (bin 0,
    and W/2 for even W, exactly real), the H passes rfft2(x), and the
    whole mixer global_mixer_ref within 1e-12 of the largest output;
    float32 within 1e-5 (the card's bound is 1e-4)."""
    x = _plane(h, w, seed=1)
    st = emulate(x)
    cols = _half_cols(h, w)
    assert _rel(_complex(st["half"][:, cols]), torch.fft.rfft(x, dim=1)) \
        <= 1e-13
    assert torch.all(st["half"][:, 0, 1] == 0)
    plan = fft_mixer_plan(h, w)
    got = _complex(st["spec"][cols][:, _positions(plan["col"], h)])
    assert _rel(got.transpose(0, 1), torch.fft.rfft2(x)) <= 1e-13
    prm = torch.tensor(PARAMS, dtype=torch.float64)
    want = global_mixer_ref(x[None, None], *(v.view(1) for v in prm))[0, 0]
    assert _rel(st["out"], want) <= 1e-12
    got32 = emulate(x.float())["out"]
    assert got32.dtype == torch.float32
    assert _rel(got32.double(), want) <= 1e-5


@pytest.mark.parametrize("h,w", [(15, 21), (521, 64), (64, 1042)])
@pytest.mark.parametrize("axis", ["H", "W"])
def test_odd_and_large_prime_planes_keep_exact_zeros(h, w, axis):
    """float32 planes constant along H (equal rows) or along W (constant
    rows) at odd sides and with a factor 521 (the prime pass on
    the columns, on the rows): every bin that is zero in exact
    arithmetic is exactly zero after the emulated forward transforms, and
    the whole mixer matches the plain version (which zeroes those bins,
    `plane_rfft2`) at a non-integer phase scale, where noise in a zero
    bin would take a random phase (an error of the order of the output).
    Within the card's 1e-4: at 521 the DC bin is the generic pass's
    sequential float32 sum of 521 equal values (relative error up to 521
    x 2^-24 / 2 = 1.6e-5), which the phase scale 7.3 carries; 2.1e-5 and
    2.3e-5 at 521 x 64 along H and 64 x 1042 along W."""
    rng = np.random.default_rng(3)
    shape = (1, w) if axis == "H" else (h, 1)
    x = torch.from_numpy(np.broadcast_to(rng.standard_normal(shape),
                                         (h, w)).astype(np.float32))
    prm = (0.9, 0.5, 7.3, 0.1)
    st = emulate(x, prm)
    plan = fft_mixer_plan(h, w)
    spec = _complex(st["spec"][_half_cols(h, w)][:, _positions(
        plan["col"], h)]).transpose(0, 1)
    nonzero = torch.zeros(h, w // 2 + 1, dtype=torch.bool)
    if axis == "H":
        nonzero[0] = True
    else:
        nonzero[:, 0] = True
    assert torch.all(spec[~nonzero] == 0)
    want = global_mixer_ref(x[None, None].double(),
                            *(torch.tensor([v], dtype=torch.float64)
                              for v in prm))[0, 0]
    assert _rel(st["out"].double(), want) <= 1e-4


@pytest.mark.parametrize("h,w,planes", [(15, 21, 1), (255, 257, 16),
                                        (1042, 9, 4), (64, 1042, 4)])
def test_emulated_global_route_matches_one_block(h, w, planes):
    """float32: the global route's three parts (rows written column by
    column, columns as runs, rows read back) at the ranges of `planes`
    planes give the one-block emulation's output bit for bit and lie
    within 1e-5 of `global_mixer_ref`, at odd sides and with a factor
    521 (the card forces the route on such planes too)."""
    x = _plane(h, w, seed=4)
    prm = torch.tensor(PARAMS, dtype=torch.float64)
    want = global_mixer_ref(x[None, None], *(v.view(1) for v in prm))[0, 0]
    got, _ = emulate_global(x.float(), planes=planes)
    assert torch.equal(got, emulate(x.float())["out"])
    assert _rel(got.double(), want) <= 1e-5


@pytest.mark.parametrize("h,w", [(15, 21), (8, 9), (1042, 9), (521, 64),
                                 (8336, 128)])
def test_plan_of_odd_and_large_prime_planes(h, w):
    """The plan: odd W's rows as W points (ld = W, no half twiddles),
    even W's as W/2; qh -1 for odd H (no H-bin H/2); the line buffer
    the largest radix above 512; tables laid out as `fft_tables_ref`
    fills them, W at the plan's end, positions a permutation; shared
    memory 112 + 8 (H ld + gbuf)."""
    p = fft_mixer_plan(h, w)
    n = w if w % 2 else w // 2
    assert p["row"] == fft_plan(n) and p["col"] == fft_plan(h)
    assert p["ld"] == (w if w % 2 else n + 1 | 1) and p["ld"] % 2 == 1
    assert p["qh"] == (-1 if h % 2 else _positions(p["col"], h)[h // 2])
    big = [r for r in p["row"] + p["col"] if r > FFT_MAX_PRIME]
    assert p["gbuf"] == max(big, default=0)
    assert p["smem"] == 4 * FFT_PLAN_FLOATS + 8 * (h * p["ld"] + p["gbuf"])
    tab = fft_tables_ref(h, w)
    half = 0 if w % 2 else 2 * n + 2
    assert tab.numel() == p["floats"] == FFT_PLAN_FLOATS + 3 * n + half \
        + 2 * h
    head = tab[:FFT_PLAN_FLOATS].view(torch.int32).tolist()
    assert head[:2] == [n, len(p["row"])] and head[10:12] == [h,
                                                             len(p["col"])]
    assert head[20:28] == [p[k] for k in ("ld", "qh", "tw_row", "tw_half",
                                          "tw_col", "pos_row", "floats",
                                          "w")]
    assert sorted(tab[p["pos_row"]:].view(torch.int32).tolist()) == \
        list(range(n))
    tw_row, _, tw_col, _ = _tables(h, w, torch.float32)
    for got, length in ((tw_row, n), (tw_col, h)):
        want = _twiddles(length, length, torch.float64)
        assert float((got.double() - want).abs().max()) <= 6e-8
        assert torch.equal(got == 0, want == 0)


def test_every_side_within_the_limits_has_a_route():
    """Every length up to the largest W has a plan of at most 8 passes,
    so every H <= 14,514 and W <= 29,026 (odd W <= 14,513) has a plan;
    the global route holds a row and a column of each with its line
    buffer (every H against W 3, every W against H 2, and the largest
    primes against each other), and no plane beyond."""
    plans = [fft_plan(n) for n in range(1, FFT_MAX_W + 1)]
    assert all(p is not None and len(p) <= FFT_MAX_PASS for p in plans)
    sides = [(h, 3) for h in range(2, FFT_MAX_H + 1)]
    sides += [(2, w) for w in range(2, FFT_MAX_W + 1)
              if w % 2 == 0 or w <= FFT_MAX_W_ODD]
    sides += [(14503, 29006), (14503, 14503), (14514, 29026), (9, 14503)]
    assert all(fft_global_plan(h, w) is not None for h, w in sides)
    assert fft_mixer_plan(FFT_MAX_H + 1, 2) is None
    assert fft_mixer_plan(2, FFT_MAX_W + 2) is None
    assert fft_mixer_plan(2, FFT_MAX_W_ODD + 2) is None


def test_b8_takes_none_of_the_new_planes():
    """B8's kernel is not widened: odd sides and prime factors above 512
    run level 2's chain even where one block holds the plane (4168 x 8:
    8 x 521 rows, the prime pass), while the planes B8 took keep it."""
    assert mixer_route(15, 21)["route"] == "smem"
    assert mixer_route(4168, 8)["route"] == "smem"
    assert lgb_route(15, 21) == lgb_route(4168, 8) == "chain"
    assert lgb_route(128, 128) == lgb_route(64, 64) == "block"
    assert lgb_route(8336, 128) == lgb_route(4168, 64) == "chain"


@pytest.mark.parametrize("shape", [(1, 2, 15, 21), (1, 2, 521, 12)])
def test_plain_mixer_and_head_match_jax(shape):
    """`global_mixer_ref` and `ln_mixer_head_ref` (what the card's routes
    are held to) at an odd plane and one with 521 rows against the JAX
    package's kernels run as its tests run them on the CPU: the Pallas
    mixer and head in interpret mode (native trig, a matmul DFT; 1e-4)
    and their XLA mirrors at integer phase scales (3e-5); y1 1e-5."""
    b, c, h, w = shape
    rng = np.random.default_rng(24)
    x = f32(rng, *shape)
    for integer_phase, tol in ((False, 1e-4), (True, 3e-5)):
        params = _mixer_params(rng, c, integer_phase)
        got = global_mixer_ref(torch.from_numpy(x),
                               *map(torch.from_numpy, params)).numpy()
        jx = [jnp.asarray(a) for a in [x] + params]
        want = (global_mixer_xla_cm(*jx) if integer_phase else
                fused_global_mixer_cm(*jx, interpret=True, trig="native"))
        assert max_err(got, want) <= tol
    xh = f32(rng, b, 2 * c, h, w)
    ln = [(1 + 0.1 * f32(rng, 2 * c)).astype(np.float32),
          0.1 * f32(rng, 2 * c)]
    for integer_phase, tol in ((False, 1e-4), (True, 3e-5)):
        params = ln + _mixer_params(rng, c, integer_phase)
        got_y1, got_x2 = ln_mixer_head_ref(torch.from_numpy(xh),
                                           *map(torch.from_numpy, params))
        jx = [jnp.asarray(a) for a in [xh] + params]
        want_y1, want_x2 = (
            ln_mixer_head_xla_cm(*jx) if integer_phase else
            fused_ln_mixer_head_cm(*jx, interpret=True, trig="native"))
        assert max_err(got_y1.numpy(), want_y1) <= 1e-5
        assert max_err(got_x2.numpy(), want_x2) <= tol


def test_unlgformer_strip_matches_jax(monkeypatch):
    """A narrow UnlgFormer (4 bands: LGT width 16, K = 2) on a PAN 8336 x
    16 strip (LrMS 2084 x 4): its full-resolution planes have 16 x 521
    rows (the prime pass's radix; on the card the global route at the
    shipped width), the bottleneck's 8 x 521. The port at level 2 (the
    plain versions on the CPU) against JAX's channel-major forward,
    within the port's 5e-4 max-abs; the mixers' phase scales are integers
    (`test_torch_port_large_plane.large_case`'s reason)."""
    tree = flax_params(4, seed=7)
    rng = np.random.default_rng(42)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.choice([-2.0, -1.0, 1.0, 2.0], v.shape)
                         .astype(np.float32)
                         if path[-1].key == "pha_scale" else v), tree)
    batch = {"input_lr": rng.uniform(0, 1, (1, 2084, 4, 4)).astype(
        np.float32),
             "input_pan": rng.uniform(0, 1, (1, 8336, 16, 1)).astype(
                 np.float32)}
    want = np.asarray(jax.jit(lambda p, ms, pan: lgteun_fast_forward(
        p, ms, pan, stage=2))(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(batch["input_lr"]),
                              jnp.asarray(batch["input_pan"])))
    monkeypatch.setenv("LGTEUN_FUSE_LEVEL", "2")
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    got = port.apply(batch).numpy()
    assert got.shape == want.shape == (1, 8336, 16, 4)
    assert np.isfinite(got).all() and max_err(got, want) <= 5e-4
