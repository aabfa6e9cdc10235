"""JAX -> port weight conversion: `lgteun_from_flax` is the exact
inverse of the existing reference-torch -> flax converter."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.lgteun import LGTEUN
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.registry import build_model


@functools.lru_cache(maxsize=None)
def _param_shapes(c, stage):
    ms = jnp.zeros((1, 8, 8, c), jnp.float32)
    pan = jnp.zeros((1, 32, 32, 1), jnp.float32)
    return jax.eval_shape(LGTEUN(ms_chans=c, stage=stage).init,
                          jax.random.PRNGKey(0), ms, pan)["params"]


def flax_params(c, stage=2, seed=0):
    """A flax LGTEUN param tree (the structure `LGTEUN.init` gives,
    traced without running it) filled from numpy with torch-default
    scales: kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), LN scales
    1 + 0.1 N, pos_emb N(0, 1) clipped to +-2, eta 0.1. float32
    throughout (conftest turns on jax_enable_x64)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name.startswith("eta_"):
            v = np.full(shape, 0.1)
        elif name in ("scale", "ln_gamma"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "pos_emb":
            v = np.clip(rng.standard_normal(shape), -2, 2)
        elif len(shape) == 4:  # HWIO kernels, incl. w1/w2/w3/dw/amp_scale
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, _param_shapes(c, stage))


@pytest.mark.parametrize("c", [4, 8])
def test_roundtrip_is_exact_and_loads_strict(c):
    tree = flax_params(c)
    sd = lgteun_from_flax(tree)
    port = build_model("UnlgFormer", Config(
        ms_chans=c, model_cfg={"core_module": {"stage": 2}}), device="cpu")
    port.load_state_dict(sd, strict=True)
    assert set(port.module.state_dict()) == set(sd)
    back = convert_state_dict("UnlgFormer",
                              {k: v.numpy() for k, v in sd.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def test_reference_key_layouts():
    """The layouts the converter must flip: pos_emb gains a leading 1,
    HWIO kernels become OIHW, amp/pha scales become [C, 1, 1, 1]."""
    sd = lgteun_from_flax(flax_params(8))
    blk = "prior_module.1.encoder_layers.0.0.blocks.0.0.fn.fn"
    assert tuple(sd[f"{blk}.local_mixer.pos_emb"].shape) == (1, 2, 64, 64)
    assert tuple(sd[f"{blk}.local_mixer.to_qkv.weight"].shape) == (48, 16, 1, 1)
    assert tuple(sd[f"{blk}.global_mixer.conv_amp.0.weight"].shape) == (16, 1, 1, 1)
    ffn = "prior_module.1.bottleneck.blocks.0.1.fn.fn.net"
    assert tuple(sd[f"{ffn}.2.depth_conv.weight"].shape) == (256, 1, 3, 3)
    assert tuple(sd["D.1.weight"].shape) == (8, 1, 3, 3)
    assert tuple(sd["eta.0"].shape) == ()


def test_unknown_flax_key_is_refused():
    tree = flax_params(4)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        lgteun_from_flax(tree)
