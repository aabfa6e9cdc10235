"""The rest of the zoo under `LGTEUN_EVAL_DTYPE=bf16` in the port (plain
PyTorch, CPU) against the JAX package: the blanket cast of
`TorchMethod.apply` (`models/base.py`), LightNet's bf16 tap path, and
the bf16 plain versions of B10-B12.

- Kernel contract (the bf16 entries of texture_match, patch_match and
  neighborhood_attention): bf16 inputs upcast, float32 math, outputs
  rounded once. Each plain version, fed bf16 inputs, is held to the JAX
  Pallas kernel (interpret mode) fed the same bf16 values: each JAX
  element equal to bf16(p) of the port's float32 value p before its
  rounding, or within one bf16 ulp of it. The searches are compared
  outside the footprint of the float64 near ties of the upcast inputs
  (a gap of NEAR_TIE), where another summation order may pick another
  ref; exact ties stay exact (the first maximum).
- The tap path against JAX's `lightnet_fast_forward(dtype=bfloat16)`
  (pure XLA) within JAX's own 5e-3 (tests/test_zoo.py:125-126).
- Each DL method under "bf16" (shipped model_cfg, 4 bands, LrMS 8^2,
  seeded weights carried to JAX with `convert_state_dict`): the port's
  drift from its own float32 output inside the JAX envelope (mean <= 5e-3,
  max <= 5e-2 of max|out|) and at most 1.5x the drift of JAX's CPU cast
  forward from the same float32 output (the port's float32 output is
  JAX's within the parity tests' bounds), and the module's output dtype
  under the cast JAX's (INNT, PanFormer and SFIIN return to float32
  where JAX's float32 constants promote their streams). JAX's CPU
  forward is not its TPU kernels' (INNT and MDCUN run their XLA searches
  and attention in bf16 arithmetic there; the port follows the kernels,
  float32 math), so the methods are held by drift, the kernels element
  by element. SFIIN's JAX side runs the matmul DFT (LGTEUN_MATMUL_DFT=1,
  the TPU's; `jnp.fft` refuses bf16).
- MutInf under "bf16" gives its float32 bits (JAX's MutInf never casts),
  and "bf16res" leaves every DL method float32, LightNet included
  (ROADMAP C.39).

Inputs are made with numpy from a seed (conftest turns on
jax_enable_x64: arrays are cast to float32 or bfloat16 by hand).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.lightnet import \
    lightnet_fast_forward as jax_lightnet_fast_forward
from lgteun_tpu.ops.nonlocal_kernel import _fused_na_impl
from lgteun_tpu.ops.patch_match_kernel import _fused_pm_impl
from lgteun_tpu.ops.texture_match_kernel import _fused_tm_impl
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.models.lightnet import lightnet_fast_forward
from lgteun_tpu_torch.ops.nonlocal_kernel import neighborhood_attention_ref
from lgteun_tpu_torch.ops.patch_match_kernel import patch_match_ref
from lgteun_tpu_torch.ops.texture_match_kernel import (row_normalize,
                                                       texture_match_ref)
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import from_jax, setenv, to_jax  # noqa: E402

BF16 = torch.bfloat16
F32 = torch.float32
NEAR_TIE = 1e-5
DRIFT_MEAN, DRIFT_MAX, JAX_DRIFT = 5e-3, 5e-2, 1.5
BANDS = 4
# the shipped configs' model_cfg (lgteun_tpu_torch/configs/*.py); the
# others ship an empty one
MODEL_CFG = {"PanFormer": {"core_module": dict(
    n_feats=64, n_heads=8, head_dim=8, win_size=4, n_blocks=3)}}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_input(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF16)


def assert_rounded_once(want: torch.Tensor, p: torch.Tensor,
                        keep: torch.Tensor | None = None) -> None:
    """Each element of JAX's bf16 `want` (where `keep`) equal to bf16(p)
    of the port's float32 value p, or within one bf16 ulp of p's
    rounding."""
    assert want.dtype == BF16 and p.dtype == F32
    mine = p.to(BF16).float()
    ulp = torch.where(mine == 0, torch.full_like(mine, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(mine.abs())) - 7))
    off = (want.float() - mine).abs() > ulp
    if keep is not None:
        off &= keep
    assert not off.any(), f"{int(off.sum())} elements beyond one bf16 ulp"


def _unfold(x: torch.Tensor, side: int) -> torch.Tensor:
    n, c, _ = x.shape
    return F.unfold(x.view(n, c, side, side), 3, padding=1)


def near_ties(lr_n: torch.Tensor, ref_n: torch.Tensor) -> torch.Tensor:
    """[N, L] bool: queries whose best float64 similarity lies within
    NEAR_TIE of the best value below it (refs tied exactly at the best
    are one value), as chip_smoke.near_ties."""
    r = torch.bmm(lr_n.double(), ref_n.double().transpose(1, 2))
    best = r.max(dim=2, keepdim=True).values
    below = r.masked_fill(r == best, -torch.inf).max(dim=2).values
    return best[..., 0] - below <= NEAR_TIE


def _patch_images(rng, n, c, side):
    """Seeded bf16 patch-images [N, C, side^2], half of them with
    PatchFusion's zero rims (zero sub-patches: exact ties)."""
    x = rng.standard_normal((n, c, side, side)).astype(np.float32)
    x[: n // 2, :, : side // 3] = 0
    x[: n // 2, :, :, : side // 3] = 0
    return torch.from_numpy(x.reshape(n, c, side * side)).to(BF16)


@pytest.mark.parametrize("c,side", [(4, 8), (8, 12)])
def test_texture_match_bf16_matches_pallas(c, side):
    """B10's plain version on bf16 lr / ref vs `_fused_tm_impl`
    (interpret) on the same values: t and s of lr's dtype, each JAX
    element bf16(p) or within one ulp, t outside the near ties' 3x3
    footprint."""
    rng = np.random.default_rng(60 + c)
    lr, ref = _patch_images(rng, 4, c, side), _patch_images(rng, 4, c, side)
    t, s = texture_match_ref(lr, ref)
    tp, sp = texture_match_ref(lr, ref, out_dtype=F32)
    assert t.dtype == s.dtype == BF16
    assert torch.equal(t, tp.to(BF16)) and torch.equal(s, sp.to(BF16))
    jt, js = _fused_tm_impl(to_jax(lr), to_jax(ref), interpret=True)
    jt, js = from_jax(jt), from_jax(js)
    near = near_ties(row_normalize(_unfold(lr.float(), side), 1)
                     .transpose(1, 2), row_normalize(
                         _unfold(ref.float(), side), 1).transpose(1, 2))
    foot = F.max_pool2d(near.view(-1, 1, side, side).float(), 3, stride=1,
                        padding=1).view(-1, 1, side * side) > 0
    assert foot.float().mean() <= 0.05
    assert_rounded_once(jt, tp, ~foot.expand_as(tp))
    assert_rounded_once(js, sp)


@pytest.mark.parametrize("c,side", [(4, 8), (8, 10)])
def test_patch_match_bf16_matches_pallas(c, side):
    """B11's plain version on bf16 lr_n / ref_n / ref_u: T copies bf16 ref
    values and S is rounded once. The Pallas kernel cannot take bf16
    inputs (ROADMAP C.40, `test_c40_pallas_patch_match_refuses_bf16`), so
    it is fed their upcast values, which it would load: each of the
    port's S equal to bf16 of JAX's float32 value or within one ulp, T
    equal to JAX's outside the near ties' columns."""
    rng = np.random.default_rng(70 + c)
    lr = _patch_images(rng, 4, c, side)
    ref_u = _unfold(_patch_images(rng, 4, c, side), side)
    lr_n = row_normalize(_unfold(lr, side), 1).transpose(1, 2).contiguous()
    ref_n = row_normalize(ref_u, 1).transpose(1, 2).contiguous()
    assert lr_n.dtype == ref_n.dtype == BF16
    t, s = patch_match_ref(lr_n, ref_n, ref_u)
    tp, sp = patch_match_ref(lr_n, ref_n, ref_u, out_dtype=F32)
    assert t.dtype == s.dtype == BF16 and torch.equal(t.float(), tp)
    assert torch.equal(s, sp.to(BF16))
    jt, js = _fused_pm_impl(*(to_jax(a.float()) for a in (lr_n, ref_n,
                                                          ref_u)),
                            interpret=True)
    jt, js = from_jax(jt), from_jax(js)
    near = near_ties(lr_n.float(), ref_n.float())
    assert near.float().mean() <= 0.05
    keep = ~near[:, None, :].expand_as(tp)
    assert torch.equal(jt * keep, t.float() * keep)
    assert_rounded_once(s, js)


def test_c40_pallas_patch_match_refuses_bf16():
    """ROADMAP C.40: JAX's patch-match kernel stores its float32 column
    maxima into the bf16 output without a cast
    (`lgteun_tpu/ops/patch_match_kernel.py:62`), which Pallas refuses,
    so JAX's INNT with LGTEUN_FUSED_TM=0 cannot run under the blanket
    cast on the TPU; the port's bf16 entry rounds S once on store."""
    rng = np.random.default_rng(75)
    lr_n = bf16_input(rng, 4, 16, 36)
    with pytest.raises(ValueError, match="dtype"):
        _fused_pm_impl(to_jax(lr_n), to_jax(lr_n),
                       to_jax(lr_n.transpose(1, 2).contiguous()),
                       interpret=True)


@pytest.mark.parametrize("c,hw", [(4, (16, 16)), (8, (16, 24))])
def test_neighborhood_attention_bf16_matches_pallas(c, hw):
    """B12's plain version on a bf16 x and bf16 weights (the cast's) vs
    `_fused_na_impl` (interpret, NHWC, the weights as [C_in, C_out]):
    out of x's dtype, the residual on the upcast x, each JAX element
    bf16(p) or within one ulp. A 7-wide window: the rounding contract
    does not depend on it, and Pallas' interpret mode unrolls every
    offset (15 x 15 took 12 s to trace here)."""
    rng = np.random.default_rng(80 + c)
    x = bf16_input(rng, 1, c, *hw)
    mats = [bf16_input(rng, c, c) * c ** -0.5 for _ in range(4)]
    got = neighborhood_attention_ref(x, *mats, fs=7)
    p = neighborhood_attention_ref(x, *mats, fs=7, out_dtype=F32)
    assert got.dtype == BF16 and torch.equal(got, p.to(BF16))
    want = _fused_na_impl(to_jax(x.permute(0, 2, 3, 1)),
                          *(to_jax(m.t().contiguous()) for m in mats), fs=7,
                          interpret=True)
    assert want.dtype == jnp.bfloat16
    assert_rounded_once(from_jax(want).permute(0, 3, 1, 2), p)


def test_lightnet_tap_path_matches_jax():
    """The port's bf16 tap path vs JAX's `lightnet_fast_forward(dtype=
    bfloat16)` on the same weights: float32 out, within JAX's own 5e-3
    of each other, and not the float32 kernel path's output."""
    port, tree = _port_and_tree("lightnet")
    batch = _batch(90)
    ms, pan = (torch.from_numpy(batch[k]).permute(0, 3, 1, 2).contiguous()
               for k in ("input_lr", "input_pan"))
    with torch.no_grad():
        got = lightnet_fast_forward(port.module, ms, pan)
        f32 = port.module(ms, pan)
    want = jax.jit(functools.partial(jax_lightnet_fast_forward,
                                     dtype=jnp.bfloat16))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
        jnp.asarray(batch["input_lr"]), jnp.asarray(batch["input_pan"]))
    assert got.dtype == F32 and want.dtype == jnp.float32
    gap = np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max()
    assert gap < 5e-3
    assert not torch.equal(got, f32)


def _batch(seed, b=2, ms=8):
    rng = np.random.default_rng(seed)
    return {"input_lr": rng.uniform(0, 1, (b, ms, ms, BANDS)).astype(
                np.float32),
            "input_pan": rng.uniform(0, 1, (b, 4 * ms, 4 * ms, 1)).astype(
                np.float32)}


def _cfg(name):
    return Config(model_type=name, ms_chans=BANDS,
                  model_cfg=MODEL_CFG.get(name, {}))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The port's seeded state_dict of `name` (no environment)."""
    port = build_model(name, _cfg(name), device="cpu").init_params(
        torch.Generator().manual_seed(11))
    return {k: v.clone() for k, v in port.state_dict().items()}


def _port_and_tree(name, **env):
    """(the port's method built under `env`, with `_weights`, and the
    flax tree of those weights)."""
    with pytest.MonkeyPatch.context() as mp:
        setenv(mp, **{"LGTEUN_EVAL_DTYPE": None, "LGTEUN_LIGHTNET_DTYPE": None,
                      **env})
        port = build_model(name, _cfg(name), device="cpu")
    port.load_state_dict(_weights(name))
    tree = convert_state_dict(name, {k: v.numpy() for k, v in
                                     _weights(name).items()})
    return port, tree


def _drift(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.mean(), d.max()


@pytest.mark.parametrize("name,env", [
    ("lightnet", {}), ("MDCUN", {}), ("INNT", {"LGTEUN_FUSED_TM": "1"}),
    ("INNT", {"LGTEUN_FUSED_TM": "0"}), ("PanFormer", {}), ("SFIIN", {})])
def test_method_bf16_drift_matches_jax(name, env, monkeypatch):
    """The method under "bf16": float32 out, its drift from the port's
    float32 output inside the envelope and at most JAX_DRIFT x the drift
    of JAX's CPU cast forward on the same weights; the module's output
    dtype under the cast is JAX's; the float32 parameters stay float32
    and untouched."""
    batch = _batch(91)
    f32_port, tree = _port_and_tree(name, **env)
    ref = f32_port.apply(batch).numpy()
    port, _ = _port_and_tree(name, LGTEUN_EVAL_DTYPE="bf16", **env)
    got = port.apply(batch)
    assert got.dtype == F32 and torch.isfinite(got).all()
    assert all(p.dtype == F32 for p in port.module.parameters())
    assert all(torch.equal(p, _weights(name)[k]) for k, p in
               port.module.state_dict().items())
    scale = np.abs(ref).max()
    mean, mx = _drift(got.numpy(), ref)
    assert mean <= DRIFT_MEAN * scale and mx <= DRIFT_MAX * scale

    if name == "SFIIN":
        monkeypatch.setenv("LGTEUN_MATMUL_DFT", "1")
    monkeypatch.setenv("LGTEUN_EVAL_DTYPE", "bf16")
    method = build_jax_model(name, JaxConfig(
        model_type=name, ms_chans=BANDS, model_cfg=MODEL_CFG.get(name, {})))
    params = {"core_module": jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), tree)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jax.jit(method.apply)(params, jbatch))
    jax_mean = _drift(want, ref)[0]
    assert mean <= JAX_DRIFT * jax_mean, (mean, jax_mean)

    if name != "lightnet":   # the tap path, not the blanket cast
        cast = lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16), t)
        jax_dtype = jax.eval_shape(lambda p, lr, pan: method.module.apply(
            {"params": p}, lr, pan, deterministic=True),
            cast(params["core_module"]), cast(jbatch["input_lr"]),
            cast(jbatch["input_pan"])).dtype
        seen = []
        port.module.register_forward_hook(
            lambda m, a, out: seen.append(out.dtype))
        port.apply(batch)
        assert seen == [F32 if jax_dtype == jnp.float32 else BF16]


def test_mutinf_bf16_gives_float32_bits():
    """JAX's MutInf overrides `apply` and never casts: under "bf16" the
    port's builds, runs float32 and gives the float32 bits."""
    batch = _batch(92)
    ref = _port_and_tree("MutInf")[0].apply(batch)
    port = _port_and_tree("MutInf", LGTEUN_EVAL_DTYPE="bf16")[0]
    assert port.eval_dtype is None
    assert torch.equal(port.apply(batch), ref)


@pytest.mark.parametrize("name", ["lightnet", "MDCUN", "INNT", "PanFormer",
                                  "SFIIN", "MutInf"])
def test_bf16res_leaves_the_zoo_float32(name):
    """"bf16res" is UnlgFormer's mixer-branch mode: every other DL method
    gives its float32 bits. LightNet too (ROADMAP C.39: JAX's LightNet
    tests `"bf16" in` the variable, so its TPU path takes bf16res as
    bf16; the port does not copy that)."""
    batch = _batch(93)
    ref = _port_and_tree(name)[0].apply(batch)
    port = _port_and_tree(name, LGTEUN_EVAL_DTYPE="bf16res")[0]
    assert port.eval_dtype is None
    assert getattr(port, "tap_dtype", None) is None
    assert torch.equal(port.apply(batch), ref)
    if name == "lightnet":
        assert "bf16" in "bf16res"   # JAX's test would take it


@pytest.mark.parametrize("name", ["SFIIN", "lightnet"])
def test_bf16_forward_with_a_gradient_raises(name):
    """The blanket cast and LightNet's tap path are eval modes: a forward
    that records a gradient raises, as UnlgFormer's storage modes do; a
    training forward (module.train()) runs float32 as JAX's
    `apply(train=True)` does."""
    port = _port_and_tree(name, LGTEUN_EVAL_DTYPE="bf16")[0]
    batch = _batch(94, b=1)
    ms, pan = (torch.from_numpy(batch[k]).permute(0, 3, 1, 2).contiguous()
               for k in ("input_lr", "input_pan"))
    with pytest.raises(RuntimeError, match="eval mode without a backward"):
        port.eval_forward(ms, pan)
    port.train()
    out = port.eval_forward(ms, pan)
    assert out.requires_grad and out.dtype == F32


@pytest.mark.parametrize("name", ["SFIIN", "PanFormer"])
def test_fuse_cli_casts_the_zoo(name, tmp_path, monkeypatch):
    """`python -m lgteun_tpu_torch.fuse --method NAME` reads the mode
    where it builds its method: under "bf16" its scene is a direct
    `fuse_scene` of a method built under "bf16" (within 1 DN of the
    uint16 rounding), and not float32's."""
    from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
    from lgteun_tpu_torch.fuse import build_argparser, fuse_scene_files
    from lgteun_tpu_torch.parallel.scene import fuse_scene
    rng = np.random.default_rng(95)
    write_tiff(str(tmp_path / "lr.tif"),
               rng.integers(0, 2047, (16, 16, BANDS)).astype(np.uint16))
    write_tiff(str(tmp_path / "pan.tif"),
               rng.integers(0, 2047, (64, 64)).astype(np.uint16))
    out = {}
    for mode in (None, "bf16"):
        setenv(monkeypatch, LGTEUN_EVAL_DTYPE=mode)
        args = build_argparser().parse_args([
            "--lr", str(tmp_path / "lr.tif"), "--pan",
            str(tmp_path / "pan.tif"), "-o", str(tmp_path / f"{mode}.tif"),
            "--method", name, "--tile", "32", "--halo", "8", "--batch",
            "4", "--device", "cpu", "--geo", "none"])
        out[mode] = read_tiff(fuse_scene_files(args)).astype(np.float64)
    port = build_model(name, Config(ms_chans=BANDS), device="cpu")
    assert port.eval_dtype == BF16
    port.init_params(torch.Generator().manual_seed(Config().seed))
    scale = 2 ** 11 - 0.5
    lr = read_tiff(str(tmp_path / "lr.tif")).astype(np.float32) / scale
    pan = read_tiff(str(tmp_path / "pan.tif")).astype(np.float32) / scale
    want = fuse_scene(port, lr, pan[:, :, None], tile=32, halo=8,
                      batch=4).numpy()
    want = np.clip(np.round(want * scale), 0, 2047)
    assert float(np.max(np.abs(out["bf16"] - want))) <= 1.0
    assert not np.array_equal(out["bf16"], out[None])
