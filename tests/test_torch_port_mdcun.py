"""The port's MDCUN slice (plain PyTorch path, CPU) vs the JAX package.

Neighbourhood attention, the resizes, the whole PanUnfolding and the
weight converter, on float32 inputs made with numpy from a seed. The
CUDA kernel itself is held against `neighborhood_attention_ref` on the
card by `chip_smoke.py`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.mdcun import PanUnfolding
from lgteun_tpu.ops import resize as jax_resize
from lgteun_tpu.ops.nonlocal_kernel import (_fused_na_impl,
                                            neighborhood_attention_xla)
from lgteun_tpu_torch.config import Config as PortConfig
from lgteun_tpu_torch.convert.from_jax import mdcun_from_flax
from lgteun_tpu_torch.ops.nonlocal_kernel import neighborhood_attention_ref
from lgteun_tpu_torch.ops.resize import resize_bicubic, resize_bilinear
from lgteun_tpu_torch.registry import build_model

T, MID = 2, 16          # stages and mid_channels of the small model


def f32(rng, *shape, scale=1.0):
    """float32 explicitly: conftest turns on jax_enable_x64."""
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def _na_case(rng, b, h, w, c):
    """NHWC x and the four JAX [in, out] matrices."""
    return f32(rng, b, h, w, c), [f32(rng, c, c, scale=0.2) for _ in range(4)]


def _port_na(x, mats, fs):
    """The port's plain version on the same values, back in NHWC."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = neighborhood_attention_ref(
        t(x.transpose(0, 3, 1, 2)), *(t(m.T) for m in mats), fs)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 128, 8), (1, 32, 128, 4)])
def test_neighborhood_attention_matches_jax(b, h, w, c):
    """Plain version vs the XLA path and the Pallas kernel in interpret
    mode at fs = 15: f32 softmax and sums in other orders, within 5e-5
    as tests/test_nonlocal_kernel.py holds them."""
    x, mats = _na_case(np.random.default_rng(c), b, h, w, c)
    got = _port_na(x, mats, 15)
    jx, jm = jnp.asarray(x), [jnp.asarray(m) for m in mats]
    want_xla = neighborhood_attention_xla(jx, *jm, 15)
    want_kernel = _fused_na_impl(jx, *jm, fs=15, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=5e-5,
                               rtol=5e-5)


def test_neighborhood_attention_ragged_borders():
    """H = 20, W = 36: every output pixel is within 7 of a border, so
    the zero-padded neighbours (logit 0, g = 0) enter every softmax."""
    x, mats = _na_case(np.random.default_rng(7), 2, 20, 36, 8)
    got = _port_na(x, mats, 15)
    want = neighborhood_attention_xla(jnp.asarray(x),
                                      *[jnp.asarray(m) for m in mats], 15)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("mode,size,out", [
    ("bicubic", 128, 64), ("bicubic", 128, 32), ("bicubic", 128, 16),
    ("bicubic", 64, 128), ("bicubic", 32, 128), ("bicubic", 16, 128),
    ("bilinear", 32, 128)])
def test_resize_matches_jax(mode, size, out):
    """F.interpolate(size=..., align_corners=False) vs the JAX resize
    matrices at MDCUN's resamples (PAN /2, /4, /8 and back, MS x4
    bilinear): the same taps summed in another order, <= 1e-6."""
    x = f32(np.random.default_rng(size + out), 2, 3, size, size)
    fn = {"bicubic": (resize_bicubic, jax_resize.resize_bicubic),
          "bilinear": (resize_bilinear, jax_resize.resize_bilinear)}[mode]
    got = fn[0](torch.from_numpy(x), (out, out)).numpy()
    want = fn[1](jnp.asarray(x.transpose(0, 2, 3, 1)), (out, out),
                 align_corners=False)
    assert got.shape == (2, 3, out, out)
    assert max_err(got, np.asarray(want).transpose(0, 3, 1, 2)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _param_shapes(c):
    module = PanUnfolding(ms_chans=c, mid_channels=MID, stages=T)
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, c)), jnp.zeros((1, 32, 32, 1)))[
        "params"]


def flax_params(c, seed=0):
    """A flax PanUnfolding tree filled from numpy: conv kernels
    U(+-1/sqrt(fan_in)), biases U(+-0.1), PReLU slopes 0.5 + U(+-0.1),
    u/eta/gama 0.5 + U(+-0.1), delta 0.1 + U(+-0.02)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "alpha" or name.split("_")[0] in ("u", "eta", "gama"):
            v = 0.5 + rng.uniform(-0.1, 0.1, shape)
        elif name.startswith("delta_"):
            v = 0.1 + rng.uniform(-0.02, 0.02, shape)
        elif len(shape) == 4:
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, _param_shapes(c))


def _cfg(c):
    return PortConfig(model_type="MDCUN", ms_chans=c, model_cfg={
        "core_module": {"mid_channels": MID, "T": T}})


@pytest.mark.parametrize("c", [4, 8])
def test_pan_unfolding_matches_flax(c):
    """TorchMethod.apply vs flax PanUnfolding.apply at 32^2 PAN (T = 2,
    mid_channels 16): within 1e-3 max-abs, the bound
    tests/test_torch_parity.py holds JAX to against the reference."""
    tree = flax_params(c, seed=c)
    rng = np.random.default_rng(20 + c)
    ms = rng.uniform(0, 1, (2, 8, 8, c)).astype(np.float32)
    pan = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    port = build_model("MDCUN", _cfg(c), device="cpu")
    port.load_state_dict(mdcun_from_flax(tree), strict=True)
    got = port.apply({"input_lr": ms, "input_pan": pan}).numpy()
    module = PanUnfolding(ms_chans=c, mid_channels=MID, stages=T)
    want = jax.jit(module.apply)({"params": jax.tree.map(jnp.asarray, tree)},
                                 jnp.asarray(ms), jnp.asarray(pan))
    assert got.shape == (2, 32, 32, c) and np.isfinite(got).all()
    assert max_err(got, want) <= 1e-3


@pytest.mark.parametrize("c", [4, 8])
def test_mdcun_roundtrip_is_exact_and_loads_strict(c):
    """mdcun_from_flax -> convert_state_dict gives the tree back bit for
    bit; the state_dict has the reference's full key set (ResnetBlock
    aliases, conv1x1 at 4 bands too) and loads strictly."""
    tree = flax_params(c)
    sd = mdcun_from_flax(tree)
    port = build_model("MDCUN", _cfg(c), device="cpu")
    port.load_state_dict(sd, strict=True)
    assert set(port.module.state_dict()) == set(sd)
    res = "rm1.block.2"
    assert torch.equal(sd[f"{res}.layers.0.weight"], sd[f"{res}.conv1.weight"])
    assert torch.equal(sd[f"{res}.layers.2.bias"], sd[f"{res}.conv2.bias"])
    for alias in ("layers.1.weight", "layers.3.weight"):
        assert torch.equal(sd[f"{res}.{alias}"], sd[f"{res}.act.weight"])
    assert tuple(sd["conv1x1.weight"].shape) == (c, 4, 1, 1)
    assert tuple(sd["NLBlock.t.weight"].shape) == (c, c, 1, 1)
    assert tuple(sd["u.0"].shape) == (1,)
    assert tuple(sd["rm1.spatial.act.weight"].shape) == (1,)
    assert "rm1.block.0.conv.bias" not in sd
    back = convert_state_dict("MDCUN", {k: v.numpy() for k, v in sd.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def test_unknown_mdcun_flax_key_is_refused():
    tree = flax_params(4)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        mdcun_from_flax(tree)
