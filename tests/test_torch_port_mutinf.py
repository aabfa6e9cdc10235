"""The port's MutInf core module (plain PyTorch, CPU) vs the JAX package.

The central-difference convolution (taps scattered into the cross and
diagonal 3x3 patterns), the multi-scale dense block, the invertible block
over it, the edge feature extractor, the whole GPPNNMutInf (its three
outputs), the weight converter both ways, the parameter count and the
seeded init of both modules with the mutual-information loss. float32 inputs made with numpy from a
seed (conftest turns on jax_enable_x64); weights a seeded flax tree
carried across by `mutinf_from_flax`.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models import mutinf as jax_mutinf
from lgteun_tpu.models.common.cdc import CDCConv as JaxCDC
from lgteun_tpu_torch.config import Config, LossCfg, load_config
from lgteun_tpu_torch.convert.from_jax import mutinf_from_flax
from lgteun_tpu_torch.models import mutinf
from lgteun_tpu_torch.models.common import cdc
from lgteun_tpu_torch.models.common.cdc import CDCConv
from lgteun_tpu_torch.models.common.inv_blocks import InvBlock
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_innt import _fill, f32, max_err  # noqa: E402
from test_torch_port_sfiin import (_init_tree, _nchw, _nhwc,  # noqa: E402
                                   _run_flax, _sub_sd)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module_case(case):
    """(flax module, port module, input channels, the subtree's place in
    the whole tree and the port's prefix there)."""
    return {
        "cdc": (JaxCDC(6), CDCConv(6), 6,
                ["extract_pan", "block1", "cdc"], "extract_pan.block1.CDC."),
        "edge_extract": (jax_mutinf._FeatureExtract(4),
                         mutinf._FeatureExtract(3, 4), 3,
                         ["extract_ms"], "extract_ms."),
        "dense_mscale": (jax_mutinf._DenseBlockMscale(4),
                         mutinf._DenseBlockMscale(4, 4), 4,
                         ["inv_0", "F"], "interact.operations.0.F."),
        "inv_mscale": (jax_mutinf._InvBlockMscale(8, 4),
                       InvBlock(8, 4, subnet=mutinf._DenseBlockMscale), 8,
                       ["inv_1"], "interact.operations.1."),
    }[case]


@pytest.mark.parametrize("case", ["cdc", "edge_extract", "dense_mscale",
                                  "inv_mscale"])
def test_module_matches_flax(case):
    """CDC (with a non-zero gate), the edge feature extractor, the
    multi-scale dense block (one dense block at 1x, 1/2x, 1/4x, bilinear
    down and up) and the invertible block over it vs flax, non-square:
    <= 1e-5."""
    flax_mod, port, c, path, prefix = _module_case(case)
    x = f32(np.random.default_rng(len(case)), 2, 16, 24, c)
    tree = _init_tree(flax_mod, x, seed=3)
    port.load_state_dict(_sub_sd(mutinf_from_flax, tree, path, prefix),
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert max_err(_nhwc(got), _run_flax(flax_mod, tree, x)) <= 1e-5


def test_cdc_kernel_layout():
    """The taps land at the reference's cross / diagonal positions: with
    theta 0 and the gate at +inf (cross only) or -inf (diagonal only), one
    tap k of a 1-channel CDC is a shift of the input by that position."""
    x = torch.arange(1.0, 26.0).view(1, 1, 5, 5)
    cdc = CDCConv(1, theta=0.0)
    positions = {"h": [(0, 1), (1, 0), (1, 1), (1, 2), (2, 1)],
                 "d": [(0, 0), (0, 2), (1, 1), (2, 0), (2, 2)]}
    for branch, gate in (("h", 1e9), ("d", -1e9)):
        for t, (r, c) in enumerate(positions[branch]):
            with torch.no_grad():
                for conv in (cdc.h_conv, cdc.d_conv):
                    conv.conv.weight.zero_()
                getattr(cdc, f"{branch}_conv").conv.weight[0, 0, 0, t] = 1.0
                cdc.HP_branch.fill_(gate)
                got = cdc(x) - x
            want = torch.nn.functional.pad(x, (1, 1, 1, 1))[
                ..., r:r + 5, c:c + 5]
            assert torch.equal(got, want), (branch, t)


def test_dense_mscale_refuses_sides_off_multiples_of_4():
    block = mutinf._DenseBlockMscale(4, 4)
    block.to_empty(device="cpu")
    with pytest.raises(ValueError, match="multiples of 4"):
        block(torch.zeros(1, 4, 16, 18))


@functools.lru_cache(maxsize=None)
def _shapes(c):
    return jax.eval_shape(jax_mutinf.GPPNNMutInf(ms_chans=c).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, c), jnp.float32),
                          jnp.zeros((1, 32, 32, 1), jnp.float32))["params"]


def _port(c, tree=None, **kw):
    port = build_model("MutInf", Config(model_type="MutInf", ms_chans=c,
                                        **kw), device="cpu")
    if tree is not None:
        port.load_state_dict(mutinf_from_flax(tree), strict=True)
    return port


@pytest.mark.parametrize("c,ms_hw", [(4, (8, 8)), (8, (16, 16)),
                                     (8, (8, 16))])
def test_mutinf_matches_flax(c, ms_hw):
    """GPPNNMutInf vs flax: hr within 5e-4 (the bound of
    tests/test_torch_parity.py), and panf and mhrf; at 8 bands and 16^2 MS
    the shipped model (n_feat 8), and non-square; apply returns hr."""
    tree = _fill(_shapes(c), seed=c)
    rng = np.random.default_rng(60 + c)
    hw = (4 * ms_hw[0], 4 * ms_hw[1])
    ms = rng.uniform(0, 1, (2, *ms_hw, c)).astype(np.float32)
    pan = rng.uniform(0, 1, (2, *hw, 1)).astype(np.float32)
    want = jax.jit(jax_mutinf.GPPNNMutInf(ms_chans=c).apply)(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(ms),
        jnp.asarray(pan))
    port = _port(c, tree)
    with torch.no_grad():
        got = port.module(_nchw(ms), _nchw(pan))
    for g, w in zip(got, want):
        assert np.isfinite(_nhwc(g)).all() and max_err(_nhwc(g), w) <= 5e-4
    applied = port.apply({"input_lr": ms, "input_pan": pan})
    assert torch.equal(applied, got[0].permute(0, 2, 3, 1))


def test_mutinf_roundtrip_is_exact_and_param_count():
    """mutinf_from_flax -> convert_state_dict gives the core tree back bit
    for bit; the state_dict is the port's whole key set; the parameters
    are the flax leaves less the frozen LU values (119,212 at WV-3)."""
    tree = _fill(_shapes(8), seed=5)
    sd = mutinf_from_flax(tree)
    port = _port(8, tree)
    assert set(port.module.state_dict()) == set(sd)
    assert "extract_pan.block2.CDC.HP_branch" in sd
    assert "interact.operations.3.G.fusepool.1.weight" in sd
    assert "refine.process.1.conv_du.2.bias" in sd
    back = convert_state_dict("MutInf", {k: v.numpy() for k, v in sd.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    leaves = jax.tree_util.tree_leaves_with_path(_shapes(8))
    want = sum(int(np.prod(v.shape)) for p, v in leaves
               if not p[-1].key.startswith("frozen_"))
    assert port.param_count() == want
    with pytest.raises(KeyError, match="extra"):
        mutinf_from_flax({**tree, "extra": np.zeros(2, np.float32)})


def test_mutinf_seeded_init_and_mi_loss_refused():
    """(Named for the refusal it tested until the port computed the MI
    loss.) init_params draws both modules from one generator: a finite
    core (HP_branch 0, the LU factors of an orthogonal matrix) and the
    `mi` module sized for the PAN side of `sample_hw` (heads of 4 x 8 x 8
    at PAN 32: 5,152 parameters; 66,592 at the default 128), each of its
    layers within torch's default bounds; the shipped config's losses
    give rec_loss and MI_rec_loss, ramped by the iteration; rec_loss
    alone trains, also after an inference call made the CDC tap index
    the step saves."""
    cfg = load_config(os.path.join(REPO, "lgteun_tpu_torch", "configs",
                                   "MutInf.py"))
    port = build_model("MutInf", cfg, device="cpu")
    assert port.param_counts()["mi"] == 66592
    port.init_params(torch.Generator().manual_seed(0), (8, 32))
    assert port.param_counts() == {"core_module": 119212, "mi": 5152}
    assert not port.module.extract_ms.block1.CDC.HP_branch.any()
    w = port.module.interact.operations[0].invconv.weight().detach()
    assert torch.allclose(w @ w.T, torch.eye(8), atol=1e-5)
    for layer in port.mi.children():
        bound = layer.weight[0].numel() ** -0.5
        for t in (layer.weight, layer.bias):
            assert t.abs().max() <= bound and t.std() > bound / 4
    again = build_model("MutInf", cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0), (8, 32))
    assert all(torch.equal(a, b) for a, b in zip(port.mi.parameters(),
                                                 again.mi.parameters()))
    rng = np.random.default_rng(6)
    batch = {"input_lr": rng.uniform(0, 1, (1, 8, 8, 8)),
             "input_pan": rng.uniform(0, 1, (1, 32, 32, 1)),
             "target": rng.uniform(0, 1, (1, 32, 32, 8))}
    cdc._positions_on.cache_clear()
    assert torch.isfinite(port.apply(batch)).all()
    gen = torch.Generator().manual_seed(1)
    for iter_id in (0, cfg.max_iter // 2, cfg.max_iter):
        total, parts = port.losses(batch, gen, iter_id)
        assert set(parts) == {"rec_loss", "MI_rec_loss", "full_loss"}
        ramp = iter_id / cfg.max_iter
        assert total.item() == pytest.approx(
            parts["rec_loss"].item() + 0.1 * ramp
            * parts["MI_rec_loss"].item(), rel=1e-6)
        assert iter_id or total.item() == parts["rec_loss"].item()
    rec = _port(8, loss_cfg={"rec_loss": LossCfg("l1", 1.0)})
    rec.load_state_dict(port.state_dict())
    total, parts = rec.losses(batch)
    assert set(parts) == {"rec_loss", "full_loss"} and torch.isfinite(total)
    total.backward()
    assert rec.module.extract_pan.block1.CDC.h_conv.conv.weight.grad.abs() \
        .max() > 0
