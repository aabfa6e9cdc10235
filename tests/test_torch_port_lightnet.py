"""The port's LightNet slice (plain PyTorch path, CPU) vs the JAX
package.

Same weights (a flax LightNetModule tree filled from numpy, mapped with
`lightnet_from_flax`), same float32 inputs made with numpy from a seed.
The CUDA kernel itself is held against `lightnet_stack_ref` on the card
by `chip_smoke.py`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.lightnet import LightNetModule
from lgteun_tpu.ops.lightnet_kernel import lightnet_fused_forward
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config as PortConfig
from lgteun_tpu_torch.convert.from_jax import lightnet_from_flax
from lgteun_tpu_torch.ops import lightnet_kernel
from lgteun_tpu_torch.ops.lightnet_kernel import (lightnet_layers,
                                                  lightnet_stack,
                                                  lightnet_stack_ref)
from lgteun_tpu_torch.ops.resize import sample_scale
from lgteun_tpu_torch.registry import build_model


@functools.lru_cache(maxsize=None)
def _param_shapes(c):
    return jax.eval_shape(LightNetModule(ms_chans=c).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, c)),
                          jnp.zeros((1, 32, 32, 1)))["params"]


def flax_params(c, seed=0):
    """A flax LightNetModule tree filled from numpy: kernels
    N(0, 2 / fan_out) as the reference's kaiming init, biases U(+-0.1)
    (non-zero, so that a pointwise output outside the image is not 0 and
    the depthwise zero padding is exercised on every layer)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = leaf.shape
        if path[-1].key == "kernel":
            v = rng.standard_normal(shape) * np.sqrt(
                2.0 / (shape[0] * shape[1] * shape[3]))
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, _param_shapes(c))


def _inputs(c, b, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, h, h, c)).astype(np.float32),
            rng.uniform(0, 1, (b, 4 * h, 4 * h, 1)).astype(np.float32))


def _port(c, tree):
    port = build_model("lightnet", PortConfig(model_type="lightnet",
                                              ms_chans=c), device="cpu")
    port.load_state_dict(lightnet_from_flax(tree), strict=True)
    return port


def _stack_args(port, ms, pan):
    """(x, lms, layers) as LightNetModule.forward hands them over."""
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    lms = sample_scale(sample_scale(nchw(ms), 2), 2)
    x = torch.cat([nchw(pan), lms], dim=1)
    return x, lms, [s.weights() for s in port.module.spans()]


@pytest.mark.parametrize("c", [4, 8])
def test_lightnet_stack_matches_pallas_kernel(c):
    """The port's stack on [2, 32, 32, C] MS / 128^2 PAN vs the fused
    Pallas kernel in interpret mode (exact f32 arithmetic in another
    order): atol 2e-5, as tests/test_lightnet_kernel.py uses."""
    tree = flax_params(c, seed=c)
    ms, pan = _inputs(c, 2, 32, seed=1)
    with torch.inference_mode():
        got = lightnet_stack(*_stack_args(_port(c, tree), ms, pan))
    want = lightnet_fused_forward(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(ms), jnp.asarray(pan),
                                  interpret=True)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 128, 128, c)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("c", [4, 8])
def test_lightnet_method_matches_jax(c):
    """TorchMethod.apply vs the JAX Method (flax LightNetModule.apply on
    the CPU): within 1e-4 max-abs."""
    tree = flax_params(c, seed=10 + c)
    ms, pan = _inputs(c, 2, 16, seed=2)
    got = _port(c, tree).apply({"input_lr": ms, "input_pan": pan}).numpy()
    method = build_jax_model("lightnet", Config(model_type="lightnet",
                                                ms_chans=c))
    want = jax.jit(method.apply)(
        {"core_module": jax.tree.map(jnp.asarray, tree)},
        {"input_lr": jnp.asarray(ms), "input_pan": jnp.asarray(pan)})
    assert got.shape == (2, 64, 64, c) and np.isfinite(got).all()
    assert float(np.max(np.abs(got - np.asarray(want)))) <= 1e-4


@pytest.mark.parametrize("c", [4, 8])
def test_lightnet_roundtrip_is_exact_and_loads_strict(c):
    tree = flax_params(c)
    sd = lightnet_from_flax(tree)
    port = _port(c, tree)
    assert set(port.module.state_dict()) == set(sd)
    assert tuple(sd["head_conv.0.point_wise_1.weight"].shape) == (
        c + 1, c + 1, 1, 1)
    assert tuple(sd["belly_conv.1.conv2.depth_wise_2.weight"].shape) == (
        32, 1, 3, 3)
    back = convert_state_dict("lightnet",
                              {k: v.numpy() for k, v in sd.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def _unpack_stack(x, lms, weights, groups):
    """The stack computed from the weight layout as csrc/lightnet.cu
    reads it (whole image, no tiling): the pointwise weights as the sum
    of their TF32 hi and lo parts from the lanes' B fragments (lane 4g +
    t: b0 = W[8 ks + t][g], b1 = W[8 ks + t + 4][g], column g: branch
    g // 4, channel 4 q + g % 4); checks the layout."""
    rows = torch.cat([g[0] for g in groups])
    for cin, cout, coutp, relu, off in rows.tolist():
        ks = -(-cin // 8)
        q = coutp // 4
        frag = weights[off:off + q * ks * 128].view(q, ks, 8, 4, 4)
        # [q][ks][g][t][b0h, b1h, b0l, b1l] -> W [q][k = 8 ks + 4 half + t][g]
        part = lambda i: frag[..., i:i + 2].permute(0, 1, 4, 3, 2).reshape(
            q, 8 * ks, 8)
        wq = part(0) + part(2)   # hi + lo, columns in chunk order
        pw = wq.view(q, 8 * ks, 2, 4).permute(1, 2, 0, 3).reshape(
            8 * ks, 2, coutp)[:cin]
        at = off + q * ks * 128
        pb = weights[at:at + 2 * coutp].view(q, 2, 4).permute(1, 0, 2) \
            .reshape(2, coutp)
        dw = weights[at + 2 * coutp:at + 20 * coutp].view(2, coutp, 3, 3)
        db = weights[at + 20 * coutp:at + 22 * coutp].view(2, coutp)
        y = 0
        for br in range(2):
            p = torch.einsum("bihw,io->bohw", x, pw[:, br]) \
                + pb[br][None, :, None, None]
            y = y + torch.nn.functional.conv2d(
                p, dw[br][:, None], db[br], padding=1, groups=coutp)
        x = (torch.relu(y) if relu else y)[:, :cout]
    return lms + x


@pytest.mark.parametrize("c", [4, 8])
def test_packed_weights_follow_the_kernel_layout(c):
    """The weight layout read as the kernel reads it reproduces the
    plain stack; the launches are five of 2 layers, each fits in a
    block's shared memory (at most 112,256 bytes: two blocks an SM); a
    new weight version remakes the layout; weights of the wrong shape
    are refused when it is made."""
    port = _port(c, flax_params(c, seed=3))
    x, lms, layers = _stack_args(port, *_inputs(c, 1, 8, seed=4))
    table = lightnet_layers(c)
    with torch.inference_mode():
        weights, groups = lightnet_kernel._packed(layers, table, x.device)
        got = _unpack_stack(x, lms, weights, groups)
        want = lightnet_stack_ref(x, lms, layers)
    assert float((got - want).abs().max()) <= 1e-5
    assert [(n, cout) for _rows, n, cout in groups] == [
        (2, 20), (2, 32), (2, 32), (2, 16), (2, c)]
    for rows, _n, cout in groups:
        assert rows.dtype == torch.int32 and rows.shape[1] == 5
        assert all(off % 4 == 0 for off in rows[:, 4].tolist())
        assert lightnet_kernel.group_smem(rows.tolist()) <= 112_256
    with pytest.raises(ValueError, match="do not match"):
        lightnet_kernel._packed(layers[:-1], table, x.device)
    with torch.inference_mode():
        assert lightnet_kernel._packed(layers, table, x.device)[0] is weights
    with torch.no_grad():
        port.module.tail_conv[2].point_wise_1.bias.add_(1.0)
    with torch.inference_mode():
        again = lightnet_kernel._packed(layers, table, x.device)[0]
    assert again is not weights and not torch.equal(again, weights)
