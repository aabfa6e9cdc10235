"""UnlgFormer's bf16 storage modes in the port (`LGTEUN_EVAL_DTYPE` =
"bf16res" / "bf16", `lgteun_tpu_torch.ops.storage_dtype`) against the
JAX package, on the CPU (the wrappers' plain versions).

Kernel contract: a bfloat16 input is upcast as loaded, the math is
float32, and each output is rounded once to nearest even. Each plain
version is held to the JAX Pallas kernel (interpret mode) fed the same
bfloat16 refs: its stored output is its float32 value p rounded once;
every element of JAX's within 2^-8 |p| + 1e-4 of p (half a bf16 step
plus the float32 bound the float32 tests use; two roundings a step
apart differ by up to 2^-7 of the value, so the bound is on p, not on
JAX's rounded value), and at least 99 % of the elements with |p| >=
1e-3 max|p| equal to JAX's bit for bit (the two round float32 values a
few ulp apart, which lands on different sides of a rounding boundary
only that often; a store that truncated would match about half).
Inputs are made with numpy from a seed (conftest turns on
jax_enable_x64: arrays are cast to float32 by hand).

Model contract (4 bands, 8^2 LrMS / 32^2 PAN, K = 2, weights from
`test_torch_port_convert.flax_params`): the drift of a mode from float32
storage stays inside the JAX package's envelope (mean <= 5e-3, max <=
5e-2 of max|out|, tests/test_lgteun.py); the level-1 prior computes
level 2's function, JAX's B1 -> B2 -> B3 chain (ROADMAP C.35: it feeds
the global mixer the float32 LN and rounds only its output, where JAX's
level-1 mirror off the TPU rounds the mixer's input); level 3 computes
level 2's. The "bf16" stream stays bfloat16 at every level (JAX's level
1 promotes it to float32 after a block, C.36, which the port does not
copy). Training ignores the mode.

The bf16 modes are ill-conditioned across blocks: a rounding that lands
on the other side in two float32 implementations moves a block's output
by a bf16 step there, and the next blocks' mixers (global over each
plane, their phases scaled by the learned phase weights) spread that
over the plane. A one-rounding change of the port's own input moves
its whole level-1 forward by about a quarter of the mode's drift here
(ROADMAP C.37), so the whole forward is held to JAX's by its envelope
and by which mode it is nearer to, and the same-function bound (a
quarter of the drift) is held where both run on the same input: one
LGB stack, and one block's kernel chain.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.models import lgteun_fast
from lgteun_tpu.models.lgteun_fast import lgteun_fast_forward
from lgteun_tpu.ops.ffn_kernel import fused_block_tail_cm, fused_ln_ffn_cm
from lgteun_tpu.ops.lgb_block_kernel import fused_lgb_block_cm
from lgteun_tpu.ops.spectral_kernel import (fused_global_mixer_cm,
                                            fused_ln_mixer_head_cm)
from lgteun_tpu.ops.window_attention import fused_window_attention_v3_packed
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
from lgteun_tpu_torch.fuse import build_argparser, fuse_scene_files
from lgteun_tpu_torch.models.common import lgt
from lgteun_tpu_torch.ops import _cuda, storage_dtype
from lgteun_tpu_torch.ops.ffn_kernel import (block_tail, block_tail_ref,
                                             ln_ffn_ref)
from lgteun_tpu_torch.ops.lgb_block_kernel import lgb_block_ref
from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer,
                                                  global_mixer_ref,
                                                  ln_mixer_head,
                                                  ln_mixer_head_ref)
from lgteun_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_ref)
from lgteun_tpu_torch.parallel.scene import fuse_scene
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_lgb_engines import (_ffn_inputs, _jax_blk,  # noqa: E402
                                         _mixer_params, _port_blk)
from test_torch_port_ops import _port_ffn, f32  # noqa: E402

BF16 = torch.bfloat16
BOUND_REL, BOUND_ABS = 2.0 ** -8, 1e-4
EQUAL_SHARE, EQUAL_FLOOR = 0.99, 1e-3
DRIFT_MEAN, DRIFT_MAX = 5e-3, 5e-2


def to_jax(t: torch.Tensor):
    """A port tensor as a JAX array of the same dtype and bits."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def from_jax(a) -> torch.Tensor:
    """A JAX array as a port tensor of the same dtype and bits."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.asarray(a))


def assert_storage_close(got: torch.Tensor, p: torch.Tensor,
                         want: torch.Tensor) -> None:
    """The module docstring's kernel bound: the port's output `got` is its
    float32 value `p` rounded once to `want`'s dtype; every element of
    JAX's `want` within BOUND_REL |p| + BOUND_ABS of p, and for bfloat16
    outputs at least EQUAL_SHARE of the elements above EQUAL_FLOOR max|p|
    equal to the port's bit for bit."""
    assert p.dtype == torch.float32
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, p.to(got.dtype))
    w, pd = want.double(), p.double()
    excess = ((w - pd).abs() - BOUND_REL * pd.abs() - BOUND_ABS).max().item()
    assert excess <= 0, f"an element exceeds the bound by {excess:.3e}"
    if got.dtype == BF16:
        big = pd.abs() >= EQUAL_FLOOR * pd.abs().max()
        same = (got.view(torch.int16) == want.view(torch.int16)) & big
        share = same.sum().item() / big.sum().item()
        assert share >= EQUAL_SHARE, f"{share:.4f} equal"


def stored(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


def setenv(monkeypatch, **env) -> None:
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env,want", [(None, (None, False)),
                                      ("fp16", (None, False)),
                                      ("bf16", (BF16, False)),
                                      ("bf16res", (BF16, True))])
def test_storage_switch(env, want, monkeypatch):
    """The JAX package's parse (`lgteun_fast.py:65-96`), read when the
    method is built: the module keeps its mode when the variable
    changes afterwards, and the output is float32 in every mode."""
    setenv(monkeypatch, LGTEUN_EVAL_DTYPE=env)
    assert storage_dtype() == want
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(flax_params(4)))
    monkeypatch.setenv("LGTEUN_EVAL_DTYPE", "bf16" if env is None else "")
    assert all(m.storage == want for m in port.module.prior_module)
    rng = np.random.default_rng(40)
    out = port.apply({"input_lr": rng.uniform(0, 1, (1, 8, 8, 4)),
                      "input_pan": rng.uniform(0, 1, (1, 32, 32, 1))})
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
def test_head_bf16_matches_pallas(x_dtype):
    """B1: y1 and x2 stored as bf16 from float32 or bf16 x, vs the Pallas
    head with out_dtype=bfloat16 (interpret, native trig)."""
    rng = np.random.default_rng(41)
    x = stored(f32(rng, 1, 8, 32, 32), x_dtype)
    params = [(1 + 0.1 * f32(rng, 8)).astype(np.float32),
              0.1 * f32(rng, 8)] + _mixer_params(rng, 4)
    tp = [torch.from_numpy(a) for a in params]
    got = ln_mixer_head_ref(x, *tp, out_dtype=BF16)
    p = ln_mixer_head_ref(x, *tp, out_dtype=torch.float32)
    want = fused_ln_mixer_head_cm(to_jax(x), *map(jnp.asarray, params),
                                  interpret=True, trig="native",
                                  out_dtype=jnp.bfloat16)
    for g, v, w in zip(got, p, want):
        assert_storage_close(g, v, from_jax(w))


def test_global_mixer_bf16_matches_pallas():
    """B4 on bf16 in and out vs the Pallas mixer (interpret)."""
    rng = np.random.default_rng(42)
    x = stored(f32(rng, 2, 4, 32, 32), BF16)
    params = _mixer_params(rng, 4)
    tp = [torch.from_numpy(a) for a in params]
    want = fused_global_mixer_cm(to_jax(x), *map(jnp.asarray, params),
                                 interpret=True, trig="native")
    assert_storage_close(global_mixer_ref(x, *tp), global_mixer_ref(
        x, *tp, out_dtype=torch.float32), from_jax(want))


def test_window_attention_bf16_matches_pallas():
    """B2 on bf16 in and out vs the packed v3 Pallas kernel (interpret,
    plain exp) on the same bf16 window pairs."""
    rng = np.random.default_rng(43)
    heads, win, c = 2, 8, 8
    x = stored(f32(rng, 2, c, 16, 32), BF16)
    wqkv = f32(rng, c, 3 * c, scale=c ** -0.5)
    bqkv, pos = 0.1 * f32(rng, 3 * c), f32(rng, heads, 64, 64)
    tw = (torch.from_numpy(np.ascontiguousarray(wqkv.T)),
          torch.from_numpy(bqkv), torch.from_numpy(pos), heads, win)
    got = window_attention_ref(x, *tw)
    p = window_attention_ref(x, *tw, out_dtype=torch.float32)
    xp = lgteun_fast._window_pairs_cm(to_jax(x), win)
    packed = fused_window_attention_v3_packed(
        xp, jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(pos),
        heads=heads, scale=(c // heads) ** -0.5, interpret=True,
        tanh_exp=False)
    want = lgteun_fast._unwindow_pairs_cm(packed, win, (16, 32), 2)
    assert_storage_close(got, p, from_jax(want))


def _tail_case(rng, c=8, hw=(16, 128)):
    x = f32(rng, 1, c, *hw)
    x1, x2 = f32(rng, 1, c // 2, *hw), f32(rng, 1, c // 2, *hw)
    proj, pb = f32(rng, c, c, scale=c ** -0.5), 0.1 * f32(rng, c)
    return x, x1, x2, proj, pb, _ffn_inputs(rng, c)


@pytest.mark.parametrize("x_dtype,br_dtype", [(torch.float32, BF16),
                                              (BF16, BF16),
                                              (BF16, torch.float32)])
def test_block_tail_bf16_matches_pallas(x_dtype, br_dtype):
    """B3 with x (and out) and x1/x2 in each storage combination vs the
    Pallas tail (interpret, the row-tiled kernel); out takes x's dtype."""
    rng = np.random.default_rng(44)
    x, x1, x2, proj, pb, ffn = _tail_case(rng)
    tx = stored(x, x_dtype)
    t1, t2 = stored(x1, br_dtype), stored(x2, br_dtype)
    args = (tx, t1, t2, torch.from_numpy(np.ascontiguousarray(proj.T)),
            torch.from_numpy(pb), _port_ffn(ffn))
    want = fused_block_tail_cm(to_jax(tx), to_jax(t1), to_jax(t2),
                               jnp.asarray(proj), jnp.asarray(pb),
                               {k: jnp.asarray(v) for k, v in ffn.items()},
                               tile_rows=8, interpret=True)
    assert_storage_close(block_tail_ref(*args), block_tail_ref(
        *args, out_dtype=torch.float32), from_jax(want))


def test_ln_ffn_bf16_matches_pallas():
    """B5 on bf16 in and out vs the Pallas FFN kernel (interpret)."""
    rng = np.random.default_rng(45)
    x = stored(f32(rng, 1, 8, 16, 128), BF16)
    ffn = _ffn_inputs(rng, 8)
    want = fused_ln_ffn_cm(to_jax(x), {k: jnp.asarray(v)
                                       for k, v in ffn.items()})
    assert_storage_close(ln_ffn_ref(x, _port_ffn(ffn)), ln_ffn_ref(
        x, _port_ffn(ffn), out_dtype=torch.float32), from_jax(want))


def test_lgb_block_bf16_matches_pallas():
    """B8 on bf16 in and out vs the Pallas block kernel (interpret,
    native trig, plain exp), which keeps its branches in float32 (C.8):
    the plain version without branch rounding."""
    rng = np.random.default_rng(46)
    x, blk = stored(f32(rng, 1, 16, 16, 128), BF16), _jax_blk(rng, 16)
    want = fused_lgb_block_cm(to_jax(x), jax.tree.map(jnp.asarray, blk),
                              interpret=True, trig="native",
                              tanh_exp=False)
    assert_storage_close(lgb_block_ref(x, _port_blk(blk)), lgb_block_ref(
        x, _port_blk(blk), out_dtype=torch.float32), from_jax(want))


def _jax_chain(x, blk, out_dtype):
    """JAX level 2 on the TPU (`lgteun_fast.py:395-403`): the Pallas head
    with out_dtype, the packed attention on y1, the tail, in interpret
    mode."""
    g, loc = blk["global"], blk["local"]
    conv = blk["proj"]["Conv_0"]["Conv_0"]
    y1, x2 = fused_ln_mixer_head_cm(
        x, blk["norm"]["scale"], blk["norm"]["bias"],
        g["amp_scale"][0, 0, 0], g["amp_bias"], g["pha_scale"][0, 0, 0],
        g["pha_bias"], interpret=True, trig="native", out_dtype=out_dtype)
    b, c2, h, w = y1.shape
    packed = fused_window_attention_v3_packed(
        lgteun_fast._window_pairs_cm(y1, 8), loc["to_qkv_kernel"][0, 0],
        loc["to_qkv_bias"], loc["pos_emb"], heads=2,
        scale=(c2 // 2) ** -0.5, interpret=True, tanh_exp=False)
    x1 = lgteun_fast._unwindow_pairs_cm(packed, 8, (h, w), b)
    return fused_block_tail_cm(x, x1, x2, conv["kernel"][0, 0], conv["bias"],
                               blk["ffn"], tile_rows=8, interpret=True)


def test_level2_block_bf16res_matches_jax_chain():
    """One LGB block at level 2 under bf16res (the port's three wrappers,
    y1 / x2 / x1 stored as bf16, the mixer fed the float32 LN) vs JAX's
    B1 -> B2 -> B3 chained; the port's whole-block plain version with
    branch rounding (B8's) is the same function bit for bit."""
    rng = np.random.default_rng(47)
    x, blk = f32(rng, 1, 16, 16, 128), _jax_blk(rng, 16)
    p = _port_blk(blk)
    xt = torch.from_numpy(x)
    y1, x2 = ln_mixer_head(xt, *(p[k] for k in ("ln_w", "ln_b", "amp_w",
                                                 "amp_b", "pha_w", "pha_b")),
                           out_dtype=BF16)
    x1 = window_attention(y1, p["wqkv"], p["bqkv"], p["pos"], 2, 8)
    assert y1.dtype == x2.dtype == x1.dtype == BF16
    got = block_tail(xt, x1, x2, p["proj_w"], p["proj_b"], p["ffn"])
    assert torch.equal(got, lgb_block_ref(xt, p, branch_dtype=BF16))
    want = np.asarray(_jax_chain(jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, blk),
                                 jnp.bfloat16))
    drift = np.abs(got.numpy() - lgb_block_ref(xt, p).numpy())
    gap = np.abs(got.numpy() - want)
    assert gap.mean() <= 0.25 * drift.mean() and gap.max() <= drift.max()


def _model_case(seed=0):
    tree = flax_params(4, seed=seed)
    rng = np.random.default_rng(48)
    batch = {"input_lr": rng.uniform(0, 1, (2, 8, 8, 4)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (2, 32, 32, 1)).astype(
                 np.float32)}
    return tree, batch


def _port(tree, monkeypatch, mode=None, level="2", v2=False):
    setenv(monkeypatch, LGTEUN_EVAL_DTYPE=mode, LGTEUN_FUSE_LEVEL=level,
           LGTEUN_FUSED_ATTENTION="v2" if v2 else None)
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    return port


@pytest.fixture(scope="module")
def jax_modes():
    """JAX `lgteun_fast_forward` (its CPU path: level 1's mirror) under
    bf16res and bf16, on `_model_case` (its float32 output is the port's
    within 1e-6, so the drifts are taken from the port's)."""
    tree, batch = _model_case()
    params = jax.tree.map(jnp.asarray, tree)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mode in ("bf16res", "bf16"):
            setenv(mp, LGTEUN_EVAL_DTYPE=mode)
            fwd = jax.jit(lambda p, ms, pan: lgteun_fast_forward(
                p, ms, pan, stage=2))   # the mode is read at trace time
            out[mode] = np.asarray(fwd(params,
                                       jnp.asarray(batch["input_lr"]),
                                       jnp.asarray(batch["input_pan"])))
    return out


@pytest.fixture(scope="module")
def jax_stack():
    """JAX's level-1 mirror (`_lgb_cm`, jitted) on one LGB stack of
    `_model_case`'s weights (prior_1/enc_lgb_0, C 16, 32^2): the input x,
    the output with bf16 branches (bf16res; its float32 one is the
    port's within 1e-6), the global mixer's inputs in that call (read by
    a debug callback), and the output's dtype on a bf16 stream
    ("bf16")."""
    tree, _ = _model_case()
    params = jax.tree.map(jnp.asarray, tree["prior_1"]["enc_lgb_0"])
    x = f32(np.random.default_rng(49), 2, 16, 32, 32)
    seen = []
    orig = lgteun_fast._global_mixer_cm

    def spy(y, p, train=False):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), y)
        return orig(y, p, train)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lgteun_fast, "_global_mixer_cm", spy)
        run = lambda xs, bd: np.asarray(jax.jit(
            lambda a: lgteun_fast._lgb_cm(a, params, 2, 8, 2, bdtype=bd))(
                xs).astype(jnp.float32))
        out = {"bf16res": run(jnp.asarray(x), jnp.bfloat16)}
        mixer_inputs = list(seen)
        stream = jax.jit(lambda a: lgteun_fast._lgb_cm(a, params, 2, 8, 2))(
            jnp.asarray(x).astype(jnp.bfloat16))
    return x, out, mixer_inputs, stream.dtype


def _drift(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.mean(), d.max()


def test_level1_bf16res_matches_jax(monkeypatch, jax_modes, jax_stack):
    """The whole forward at level 1 under bf16res vs JAX's: inside the
    envelope, about as far from float32 as JAX's (within 1.5x), and
    nearer JAX's bf16res than JAX's bf16 (so the test tells the modes
    apart); one LGB stack at level 1 on the same input within a quarter
    of the drift of JAX's B1 -> B2 -> B3 chain (interpret mode, block by
    block, as `test_level2_block_bf16res_matches_jax_chain` holds one
    block at level 2), the function level 1 computes since ROADMAP C.35
    was mended (module docstring: the whole forward's own one-rounding
    spread is about that quarter)."""
    tree, batch = _model_case()
    f32_out = _port(tree, monkeypatch).apply(batch).numpy()
    scale = np.abs(f32_out).max()
    jax_drift = _drift(jax_modes["bf16res"], f32_out)[0]
    port = _port(tree, monkeypatch, "bf16res", "1")
    got = port.apply(batch).numpy()
    mean, mx = _drift(got, f32_out)
    assert mean <= DRIFT_MEAN * scale and mx <= DRIFT_MAX * scale
    assert mean <= 1.5 * jax_drift
    near = _drift(got, jax_modes["bf16res"])[0]
    assert near < _drift(got, jax_modes["bf16"])[0]
    assert _drift(got, jax_modes["bf16"])[0] > 0.25 * jax_drift

    # one stack on one input: JAX's chain, block by block, vs the port's
    # level-1 LGB
    x = jax_stack[0]
    params = jax.tree.map(jnp.asarray, tree["prior_1"]["enc_lgb_0"])
    want = jnp.asarray(x)
    for i in range(2):
        mx = params[f"mixer_{i}"]
        want = _jax_chain(want, {
            "norm": params[f"norm_mix_{i}"], "local": mx["local"],
            "global": mx["global"], "proj": mx["proj"],
            "ffn": lgteun_fast._ffn_flat(params[f"ffn_{i}"])}, jnp.bfloat16)
    want = np.asarray(want)
    stack = port.module.prior_module[1].encoder_layers[0][0]
    with torch.no_grad():
        got = stack(torch.from_numpy(x), None, BF16).numpy()
        ref = stack(torch.from_numpy(x)).numpy()
    assert _drift(got, want)[0] <= 0.25 * _drift(want, ref)[0]


def test_levels_inside_envelope(monkeypatch):
    """Levels 1, 2, 3 and v2 in each mode: inside the JAX envelope around
    the float32 forward; level 3 and v2 compute level 2's function (on
    the CPU the same values), and bf16res drifts at most 1.25x as far as
    bf16 at levels 1 and 2 (tests/test_lgteun.py:148-150). Every LGB
    stack takes and gives the stream's dtype: bf16 under "bf16" at every
    level (the inter-scale convs give bf16 too), float32 under
    bf16res."""
    tree, batch = _model_case()
    ref = _port(tree, monkeypatch).apply(batch).numpy()
    scale = np.abs(ref).max()
    drift = {}
    for mode, stream in (("bf16res", torch.float32), ("bf16", BF16)):
        outs = {}
        for label, level, v2 in (("1", "1", False), ("2", "2", False),
                                 ("3", "3", False), ("v2", "2", True)):
            port = _port(tree, monkeypatch, mode, level, v2)
            dtypes = []
            for m in port.module.modules():
                if isinstance(m, lgt.LGB):
                    m.register_forward_hook(
                        lambda mod, args, out: dtypes.append(
                            (args[0].dtype, out.dtype)))
            outs[label] = port.apply(batch).numpy()
            assert dtypes and all(d == (stream, stream) for d in dtypes)
            mean, mx = _drift(outs[label], ref)
            assert mean <= DRIFT_MEAN * scale and mx <= DRIFT_MAX * scale
            drift[mode, label] = mean
        for label in ("3", "v2"):
            assert _drift(outs[label], outs["2"])[0] <= 0.25 * drift[
                mode, "2"]
    for level in ("1", "2"):
        assert drift["bf16res", level] <= 1.25 * drift["bf16", level]


def test_c35_level1_rounds_the_mixer_input(monkeypatch, jax_stack):
    """ROADMAP C.35 (mended): under bf16res JAX's level-1 mirror rounds
    the global mixer's input to bf16; the port's level 1 feeds the mixer
    the float32 LN and rounds only its output (`global_mixer(...,
    out_dtype=bf16)`), as JAX's head kernel B1 and the port's level 2
    do: on the same x the level-1 mixer's x2 is the head's bit for
    bit."""
    tree, batch = _model_case()
    seen = jax_stack[2]
    assert len(seen) == 2 and all(np.array_equal(
        a, np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
            jnp.float32))) for a in seen)

    mixer_in = []
    monkeypatch.setattr(lgt, "global_mixer",
                        lambda x, *p, out_dtype=None: mixer_in.append(x)
                        or global_mixer_ref(x, *p, out_dtype))
    _port(tree, monkeypatch, "bf16res", "1").apply(batch)
    assert len(mixer_in) == 5 and all(t.dtype == torch.float32
                                      for t in mixer_in)
    assert not all(torch.equal(t, t.to(BF16).float()) for t in mixer_in)

    rng = np.random.default_rng(50)
    x = torch.from_numpy(f32(rng, 1, 8, 16, 16))
    params = [torch.from_numpy(a) for a in [
        (1 + 0.1 * f32(rng, 8)).astype(np.float32), 0.1 * f32(rng, 8)]
        + _mixer_params(rng, 4)]
    _, x2 = ln_mixer_head(x, *params, out_dtype=BF16)
    ln = lgt.channel_layer_norm(x, params[0], params[1])
    assert torch.equal(x2, global_mixer_ref(ln[:, 4:], *params[2:]).to(BF16))
    assert torch.equal(x2, global_mixer(ln[:, 4:].contiguous(), *params[2:],
                                        out_dtype=BF16))
    assert not torch.equal(x2, global_mixer_ref(ln[:, 4:].to(BF16),
                                                *params[2:]))


def test_c36_bf16_stream(monkeypatch, jax_stack):
    """ROADMAP C.36: JAX's level 1 given a bf16 stream ("bf16" mode)
    returns float32 (its proj has no storage dtype, so x + proj
    promotes); the port's level 1 keeps the stream bf16."""
    tree, _ = _model_case()
    x, _, _, jax_dtype = jax_stack
    assert jax_dtype == jnp.float32
    stack = _port(tree, monkeypatch, "bf16", "1").module.prior_module[
        1].encoder_layers[0][0]
    with torch.no_grad():
        got = stack(torch.from_numpy(x).to(BF16), None, BF16)
    assert got.dtype == BF16


def test_training_forward_ignores_mode(monkeypatch):
    """A training forward (module.train(), dropout drawn, gradients
    recorded) under either mode gives the float32 output bit for bit
    (JAX's `train` runs float32 storage), and a bf16 eval forward that
    records a gradient raises."""
    tree, batch = _model_case()
    ms = torch.from_numpy(batch["input_lr"]).permute(0, 3, 1, 2)
    pan = torch.from_numpy(batch["input_pan"]).permute(0, 3, 1, 2)
    out = {}
    for mode in (None, "bf16res", "bf16"):
        port = _port(tree, monkeypatch, mode).train()
        out[mode] = port.forward(ms, pan, torch.Generator().manual_seed(3))
        assert out[mode].requires_grad
    assert torch.equal(out[None], out["bf16res"])
    assert torch.equal(out[None], out["bf16"])
    port = _port(tree, monkeypatch, "bf16res")
    with pytest.raises(RuntimeError, match="eval mode without a backward"):
        port.forward(ms, pan)


def test_entries_name_their_dtypes():
    """The dtype checks of the entries name what they accept: an f32-only
    entry refuses bf16 naming float32, a storage entry names both."""
    dev = torch.device("cpu")
    t = torch.zeros(2, dtype=BF16)
    with pytest.raises(ValueError, match="contiguous float32 tensor"):
        _cuda.check_cuda_f32("block_tail_masked", dev, x=t)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _cuda.check_cuda("ln_mixer_head", dev,
                         (torch.float32, BF16), x=t.double())
    _cuda.check_cuda("ln_mixer_head", dev, (torch.float32, BF16), x=t)


def test_fuse_cli_takes_the_mode(tmp_path, monkeypatch):
    """`python -m lgteun_tpu_torch.fuse` reads the mode where it builds
    its method: under bf16res its scene is a direct `fuse_scene` of a
    method built under bf16res (within 1 DN of the uint16 rounding), and
    not float32 storage's."""
    rng = np.random.default_rng(53)
    write_tiff(str(tmp_path / "lr.tif"),
               rng.integers(0, 2047, (16, 16, 4)).astype(np.uint16))
    write_tiff(str(tmp_path / "pan.tif"),
               rng.integers(0, 2047, (64, 64)).astype(np.uint16))
    out = {}
    for mode in (None, "bf16res"):
        setenv(monkeypatch, LGTEUN_EVAL_DTYPE=mode)
        args = build_argparser().parse_args([
            "--lr", str(tmp_path / "lr.tif"), "--pan",
            str(tmp_path / "pan.tif"), "-o", str(tmp_path / f"{mode}.tif"),
            "--method", "UnlgFormer", "--stage", "1", "--tile", "32",
            "--halo", "8", "--batch", "2", "--device", "cpu", "--geo",
            "none"])
        out[mode] = read_tiff(fuse_scene_files(args)).astype(np.float64)
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 1}}), device="cpu")
    port.init_params(torch.Generator().manual_seed(Config().seed))
    scale = 2 ** 11 - 0.5
    lr = read_tiff(str(tmp_path / "lr.tif")).astype(np.float32) / scale
    pan = read_tiff(str(tmp_path / "pan.tif")).astype(np.float32) / scale
    want = fuse_scene(port, lr, pan[:, :, None], tile=32, halo=8,
                      batch=2).numpy()
    want = np.clip(np.round(want * scale), 0, 2047)
    assert float(np.max(np.abs(out["bf16res"] - want))) <= 1.0
    assert not np.array_equal(out["bf16res"], out[None])
