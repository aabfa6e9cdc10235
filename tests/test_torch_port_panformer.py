"""The port's PanFormer (plain PyTorch, CPU) vs the JAX package.

The Swin machinery block by block (regular, shifted and cross blocks on
square and non-square grids, where a transposed window-mask index would
show), the SwinModule, the whole CrossSwinTransformer at small widths and
at the shipped ones (n_feats 64, 8 heads of 8, window 4, 3 cross blocks)
before and after its clamp, the weight converter both ways, the
reference's mask keys, the parameter count and one training step's loss
and gradients. Inputs are float32, made with numpy from a seed (conftest
turns on jax_enable_x64); weights are a seeded flax tree carried across
by `panformer_from_flax`.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config as JaxConfig, LossCfg as JaxLossCfg
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.common import swin as jax_swin
from lgteun_tpu.models.panformer import CrossSwinTransformer as JaxCST
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config, LossCfg
from lgteun_tpu_torch.convert.from_jax import (_from_table, _swin_rows,
                                               _tensors, panformer_from_flax)
from lgteun_tpu_torch.models.common import swin
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_innt import f32, max_err  # noqa: E402

SMALL = dict(n_feats=16, n_heads=2, head_dim=8, win_size=4, n_blocks=1)
SHIPPED = dict(n_feats=64, n_heads=8, head_dim=8, win_size=4, n_blocks=3)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(tree, seed):
    """A flax tree of shapes filled from numpy at torch-default scales:
    conv and Dense kernels U(+-1/sqrt(fan_in)), LayerNorm scales
    1 + 0.1 N, position tables N(0, 1), biases U(+-0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "pos_embedding":
            v = rng.standard_normal(shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _nhwc_sd(module_tree, prefix: str) -> dict:
    """A flax SwinModule subtree -> the port's keys of the module, or of
    one block when `prefix` names it (the converter's own rows)."""
    rows = _swin_rows("m", "m", module_tree)
    sd = _tensors(_from_table({"m": module_tree}, rows, "swin"))
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("shifted,cross,hw", [
    (False, False, (8, 8)), (True, False, (8, 16)), (True, False, (16, 8)),
    (True, True, (8, 16)), (False, True, (12, 8))])
def test_swin_block_matches_flax(shifted, cross, hw):
    """One SwinBlock (window 4, 2 heads of 8) vs flax: <= 1e-5. The
    non-square grids put nw_h != nw_w, where the masks' placement by
    window row and column shows."""
    rng = np.random.default_rng(hw[0] * 10 + shifted + 2 * cross)
    x = f32(rng, 2, *hw, 16)
    y = f32(rng, 2, *hw, 16) if cross else None
    flax_mod = jax_swin.SwinBlock(16, 2, 8, 64, shifted, 4, True, cross)
    args = [jnp.asarray(x)] + ([jnp.asarray(y)] if cross else [])
    tree = _fill(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0),
                                *args)["params"], seed=3)
    want = flax_mod.apply({"params": jax.tree.map(jnp.asarray, tree)}, *args)
    name = "shifted_0" if shifted else "regular_0"
    port = swin.SwinBlock(16, 2, 8, 64, shifted, 4, cross)
    port.load_state_dict(_nhwc_sd({name: tree},
                                  f"m.layers.0.{int(shifted)}."), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if y is None else torch.from_numpy(y))
    assert max_err(got, want) <= 1e-5


@pytest.mark.parametrize("ds,cross,hw", [(2, False, (16, 32)),
                                         (1, True, (8, 12))])
def test_swin_module_matches_flax(ds, cross, hw):
    """SwinModule (patch merge with the channel-outermost unfold order, a
    regular and a shifted block; y merged with x's weights) vs flax:
    <= 1e-5."""
    rng = np.random.default_rng(ds + 7 * cross)
    c = 3 if ds > 1 else 16
    x = f32(rng, 2, *hw, c)
    y = f32(rng, 2, *hw, c) if cross else None
    flax_mod = jax_swin.SwinModule(16, 2, ds, 2, 8, 4, True, cross)
    args = [jnp.asarray(x)] + ([jnp.asarray(y)] if cross else [])
    tree = _fill(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0),
                                *args)["params"], seed=4)
    want = flax_mod.apply({"params": jax.tree.map(jnp.asarray, tree)}, *args)
    port = swin.SwinModule(c, 16, 2, ds, 2, 8, 4, cross)
    port.load_state_dict(_nhwc_sd(tree, "m."), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if y is None else torch.from_numpy(y))
    assert got.shape == (2, hw[0] // ds, hw[1] // ds, 16)
    assert max_err(got, want) <= 1e-5


def test_window_tables_and_pixel_shuffle_match_jax():
    """The masks, the relative index and the per-window mask placement
    equal the JAX package's (-1e9, not -inf); torch's PixelShuffle equals
    its NHWC `pixel_shuffle`."""
    for w in (4, 6):
        for got, want in zip(swin._shift_masks(w), jax_swin._shift_masks(w)):
            assert np.array_equal(got, want) and want.min() == -1e9
        assert np.array_equal(swin._relative_index(w),
                              jax_swin._relative_index(w))
    # 2 x 3 windows: the last row takes upper/lower, the last column
    # left/right
    mask = swin._window_mask(4, 2, 3, torch.device("cpu")).numpy()
    ul, lr = jax_swin._shift_masks(4)
    for i, want in enumerate((0, 0, lr, ul, ul, ul + lr)):
        assert np.array_equal(mask[i], np.broadcast_to(want, ul.shape)), i
    x = f32(np.random.default_rng(5), 2, 3, 5, 12)
    got = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert np.array_equal(got.numpy(), np.asarray(
        jax_swin.pixel_shuffle(jnp.asarray(x), 2)))


@functools.lru_cache(maxsize=None)
def _shapes(c, widths, ms_hw):
    g = dict(widths)
    return jax.eval_shape(
        JaxCST(ms_chans=c, **g).init, jax.random.PRNGKey(0),
        jnp.zeros((1, *ms_hw, c)),
        jnp.zeros((1, 4 * ms_hw[0], 4 * ms_hw[1], 1)))["params"]


def _config(c, widths, **kw):
    return Config(model_type="PanFormer", ms_chans=c,
                  model_cfg={"core_module": dict(widths)}, **kw)


def _case(c, widths, ms_hw, seed):
    """(tree, batch, JAX output, JAX output before the clamp)."""
    tree = _fill(_shapes(c, tuple(widths.items()), ms_hw), seed)
    rng = np.random.default_rng(seed)
    batch = {"input_lr": rng.uniform(0, 1, (2, *ms_hw, c)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (2, 4 * ms_hw[0], 4 * ms_hw[1],
                                             1)).astype(np.float32)}
    want, state = JaxCST(ms_chans=c, **widths).apply(
        {"params": jax.tree.map(jnp.asarray, tree)},
        jnp.asarray(batch["input_lr"]), jnp.asarray(batch["input_pan"]),
        capture_intermediates=lambda mdl, _: mdl.name == "tail_conv3",
        mutable=["intermediates"])
    pre = state["intermediates"]["tail_conv3"]["__call__"][0]
    return tree, batch, np.asarray(want), np.asarray(pre)


@pytest.mark.parametrize("c,widths,ms_hw", [
    (4, SMALL, (8, 8)), (8, SMALL, (8, 16)), (8, SHIPPED, (16, 16))],
    ids=["small", "small-nonsquare", "shipped"])
def test_panformer_matches_flax(c, widths, ms_hw):
    """TorchMethod.apply vs flax CrossSwinTransformer (within the 5e-4 of
    tests/test_torch_parity.py), and the tail before the clamp, which
    random weights leave mostly outside [0, 1]."""
    tree, batch, want, pre = _case(c, widths, ms_hw, seed=c + len(widths))
    port = build_model("PanFormer", _config(c, widths), device="cpu")
    port.load_state_dict(panformer_from_flax(tree), strict=True)
    got = port.apply(batch).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert max_err(got, want) <= 5e-4
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_pre = port.module.unclamped(nchw(batch["input_lr"]),
                                        nchw(batch["input_pan"]))
    assert max_err(got_pre.permute(0, 2, 3, 1), pre) <= 5e-4
    assert 0.05 < float(np.mean((pre < 0) | (pre > 1))) < 0.95


def _reference_keyed(tree, widths):
    """panformer_from_flax plus the 20 (shipped: 2 x 10 shifted blocks)
    mask entries a reference checkpoint carries, -inf where masked."""
    sd = panformer_from_flax(tree)
    ul, lr = (torch.from_numpy(np.where(m < 0, -np.inf, m).astype(np.float32))
              for m in swin._shift_masks(widths["win_size"]))
    blocks = {k.split(".attention_block")[0] for k in sd
              if ".layers." in k and ".attention_block" in k
              and k.split(".attention_block")[0].endswith(".1")}
    for b in blocks:
        sd[f"{b}.attention_block.fn.fn.upper_lower_mask"] = ul
        sd[f"{b}.attention_block.fn.fn.left_right_mask"] = lr
    return sd, sorted(blocks)


def test_reference_mask_keys_load_and_wrong_masks_fail():
    """A state_dict with the reference's 20 `*_mask` entries (3 cross
    blocks, as shipped) loads (each
    held against the recomputed mask, then dropped) and gives the same
    forward; a mask with one entry moved, or a mask on a regular block,
    fails the load."""
    widths = dict(SMALL, n_blocks=3)
    tree, batch, want, _ = _case(4, widths, (8, 8), seed=11)
    sd, blocks = _reference_keyed(tree, widths)
    assert len(blocks) == 10 and sum(k.endswith("_mask") for k in sd) == 20
    cfg = _config(4, widths)
    port = build_model("PanFormer", cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    assert not any(k.endswith("_mask") for k in port.state_dict())
    plain = build_model("PanFormer", cfg, device="cpu")
    plain.load_state_dict(panformer_from_flax(tree), strict=True)
    assert torch.equal(port.apply(batch), plain.apply(batch))
    assert max_err(port.apply(batch), want) <= 5e-4

    wrong = dict(sd)
    key = f"{blocks[3]}.attention_block.fn.fn.left_right_mask"
    wrong[key] = sd[key].clone()
    wrong[key][0, 1] = 0.0 if wrong[key][0, 1] < 0 else -np.inf
    with pytest.raises(RuntimeError, match="left_right_mask"):
        build_model("PanFormer", cfg, device="cpu").load_state_dict(wrong)
    extra = dict(sd)
    extra["pan_encoder.0.layers.0.0.attention_block.fn.fn.upper_lower_mask"] \
        = sd[f"{blocks[0]}.attention_block.fn.fn.upper_lower_mask"]
    with pytest.raises(RuntimeError, match="Unexpected key"):
        build_model("PanFormer", cfg, device="cpu").load_state_dict(extra)


def test_panformer_roundtrip_is_exact_and_loads_strict():
    """panformer_from_flax -> convert_state_dict gives the tree back bit
    for bit; the state_dict is the port's whole key set; a leaf the
    converter does not know is refused."""
    tree = _fill(_shapes(8, tuple(SHIPPED.items()), (8, 8)), seed=2)
    sd = panformer_from_flax(tree)
    port = build_model("PanFormer", _config(8, SHIPPED), device="cpu")
    assert set(port.module.state_dict()) == set(sd)
    assert "ms_cross_pan.2.layers.0.1.attention_block.fn.fn.to_q.weight" in sd
    back = convert_state_dict("PanFormer",
                              {k: v.numpy() for k, v in sd.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    with pytest.raises(KeyError, match="extra"):
        panformer_from_flax({**tree, "extra": np.zeros(2, np.float32)})


def test_panformer_param_count_and_seeded_init():
    """At the shipped WV-3 config the port's parameters are the flax
    tree's leaves (PanFormer has no frozen leaves; the reference also
    counts its 20 masks); init_params draws a finite model."""
    leaves = jax.tree_util.tree_leaves(_shapes(8, tuple(SHIPPED.items()),
                                               (8, 8)))
    port = build_model("PanFormer", _config(8, SHIPPED), device="cpu")
    assert port.param_count() == sum(int(np.prod(v.shape)) for v in leaves)
    port.init_params(torch.Generator().manual_seed(0))
    pos = port.module.pan_encoder[0].layers[0][0].attention_block.fn.fn
    assert 0.5 < float(pos.pos_embedding.detach().std()) < 1.5
    rng = np.random.default_rng(1)
    out = port.apply({"input_lr": rng.uniform(0, 1, (1, 8, 8, 8)),
                      "input_pan": rng.uniform(0, 1, (1, 32, 32, 1))})
    assert out.shape == (1, 32, 32, 8) and torch.isfinite(out).all()


def test_panformer_loss_and_grads_match_jax():
    """PanFormer's shipped loss is rec_loss alone, so the generic
    TorchMethod.losses trains it: one step's loss (3e-6) and every
    gradient (3e-5 max-abs) vs jax.value_and_grad of the JAX Method's
    losses on the same weights, at small widths (8 bands, ms 8x8), after
    an inference call made the window tables the step saves."""
    tree, batch, _, _ = _case(8, SMALL, (8, 8), seed=21)
    batch["target"] = np.random.default_rng(22).uniform(
        0, 1, (2, 32, 32, 8)).astype(np.float32)
    loss = {"rec_loss": dict(type="l1", w=1.0)}
    jcfg = JaxConfig(model_type="PanFormer", ms_chans=8,
                     model_cfg={"core_module": dict(SMALL)},
                     loss_cfg={"rec_loss": JaxLossCfg("l1", 1.0)})
    method = build_jax_model("PanFormer", jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: method.losses(p, b, rng=jax.random.PRNGKey(0))[0]))(
            {"core_module": jax.tree.map(jnp.asarray, tree)},
            {k: jnp.asarray(v) for k, v in batch.items()})
    port = build_model("PanFormer", _config(
        8, SMALL, loss_cfg={"rec_loss": LossCfg(**loss["rec_loss"])}),
        device="cpu")
    port.load_state_dict(panformer_from_flax(tree))
    swin._window_mask.cache_clear()
    swin._relative_index_on.cache_clear()
    port.apply(batch)
    port.train()
    total, parts = port.losses(batch)
    total.backward()
    assert set(parts) == {"rec_loss", "full_loss"}
    assert abs(total.item() - float(want_loss)) <= 3e-6
    grads = {k: p.grad.numpy() for k, p in port.module.named_parameters()}
    back = convert_state_dict("PanFormer", grads)
    want_tree = want_grads["core_module"]
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want_tree))
    largest = 0.0
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(want_tree),
            jax.tree_util.tree_leaves(back)):
        assert max_err(got, want) <= 3e-5, jax.tree_util.keystr(path)
        largest = max(largest, float(np.abs(np.asarray(want)).max()))
    assert largest > 1e-3
