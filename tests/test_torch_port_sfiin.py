"""The port's SFIIN (plain PyTorch, CPU) vs the JAX package.

The invertible coupling parts, the spectrum's amplitude and phase (the
branch JAX's CPU FFT takes at the self-conjugate bins of a plane with a
negative mean, and the exact zero bins of constant planes), FreProcess,
SpaFre, the whole SFIINNet (also on a constant PAN), the weight converter
both ways, the parameter count, the frequency losses against JAX's and
SFIIN through `main --test-only` against JAX `main`. float32 inputs made with
numpy from a seed (conftest turns on jax_enable_x64); weights a seeded
flax tree carried across by `sfiin_from_flax`.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import load_config as jax_load_config
from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.common import inv_blocks as jax_inv
from lgteun_tpu.models.sfiin import FreProcess as JaxFre
from lgteun_tpu.models.sfiin import SFIINNet as JaxSFIIN
from lgteun_tpu.models.sfiin import SpaFre as JaxSpaFre
from lgteun_tpu.models.sfiin import _safe_amp_pha
from lgteun_tpu.ops.fft import rfft2_pair
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config, LossCfg, load_config
from lgteun_tpu_torch.convert.from_jax import sfiin_from_flax
from lgteun_tpu_torch.models.common import inv_blocks
from lgteun_tpu_torch.models.sfiin import FreProcess, SpaFre
from lgteun_tpu_torch.ops.spectral_kernel import amp_phase, plane_rfft2
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_innt import _fill, f32, max_err  # noqa: E402
from test_torch_port_main import (BANDS,  # noqa: E402
                                  check_main_against_jax, data_root)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _sub_sd(from_flax, sub_tree, flax_path, t_prefix):
    """A flax subtree placed at `flax_path` of a whole model's tree,
    through the model's converter, with the port's `t_prefix` stripped."""
    tree = sub_tree
    for name in reversed(flax_path):
        tree = {name: tree}
    return {k[len(t_prefix):]: v for k, v in from_flax(tree).items()}


def _run_flax(mod, tree, *xs):
    return np.asarray(jax.jit(mod.apply)(
        {"params": jax.tree.map(jnp.asarray, tree)}, *map(jnp.asarray, xs)))


def _init_tree(mod, *xs, seed=1):
    return _fill(jax.eval_shape(mod.init, jax.random.PRNGKey(0),
                                *map(jnp.asarray, xs))["params"], seed)


@pytest.mark.parametrize("case", ["unet", "unet_dilated", "dense",
                                  "invblock"])
def test_inv_parts_match_flax(case):
    """UNetConvBlock (dilation 1 and 2), DenseBlock and InvBlock vs flax:
    <= 1e-5."""
    rng = np.random.default_rng(len(case))
    x = f32(rng, 2, 16, 16, 8 if case == "invblock" else 4)
    inv = ["block0", "spa_inv"]
    flax_mod, port, path = {
        "unet": (jax_inv.UNetConvBlock(6), inv_blocks.UNetConvBlock(4, 6),
                 inv + ["F", "conv1"]),
        "unet_dilated": (jax_inv.UNetConvBlock(6, 2),
                         inv_blocks.UNetConvBlock(4, 6, 2),
                         inv + ["F", "conv1"]),
        "dense": (jax_inv.DenseBlock(5), inv_blocks.DenseBlock(4, 5),
                  inv + ["F"]),
        "invblock": (jax_inv.InvBlock(8, 4), inv_blocks.InvBlock(8, 4), inv),
    }[case]
    tree = _init_tree(flax_mod, x)
    prefix = "process.block.spa_process.0." + "".join(
        f"{name}." for name in path[2:])
    port.load_state_dict(_sub_sd(sfiin_from_flax, tree, path, prefix),
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert max_err(_nhwc(got), _run_flax(flax_mod, tree, x)) <= 1e-5


def _planes(kind, rng, shape=(2, 16, 32, 6)):
    x = f32(rng, *shape)
    if kind == "negative_mean":
        return (x - 3.0).astype(np.float32)
    if kind == "constant":
        return np.broadcast_to(x[:, :1, :1], shape).copy()
    return x


@pytest.mark.parametrize("kind", ["random", "negative_mean", "constant"])
def test_amp_phase_matches_jax(kind):
    """amp_phase(plane_rfft2(x)) vs the JAX package's rfft2 (XLA's CPU
    FFT) and `_safe_amp_pha`. At power-of-two sides XLA leaves +0.0 as the
    imaginary part of the self-conjugate bins, so a negative real part
    there has phase +pi, the branch the port takes; constant planes keep
    every bin off DC exactly zero (amp and phase 0) in both."""
    x = _planes(kind, np.random.default_rng(40))
    re, im = rfft2_pair(jnp.asarray(x), axes=(-3, -2))
    want_amp, want_pha = (np.asarray(v) for v in _safe_amp_pha(re, im))
    amp, pha = (_nhwc(v) for v in amp_phase(plane_rfft2(_nchw(x)),
                                            x.shape[2]))
    selfconj = np.asarray(im)[:, [0, 0, 8, 8], [0, 16, 0, 16]]
    assert not np.signbit(selfconj).any() and not selfconj.any()
    np.testing.assert_allclose(amp, want_amp, rtol=1e-5,
                               atol=1e-5 * want_amp.max())
    assert max_err(pha, want_pha) <= 1e-4
    if kind == "negative_mean":
        assert (pha[:, 0, 0] == np.float32(np.pi)).all()
        assert (want_pha[:, 0, 0] == np.float32(np.pi)).all()
    if kind == "constant":
        assert not amp[:, 1:].any() and not amp[:, :, 1:].any()
        assert not want_amp[:, 1:].any() and not want_amp[:, :, 1:].any()


@pytest.mark.parametrize("kind", ["random", "negative_mean", "constant"])
def test_fre_process_matches_flax(kind):
    """FreProcess vs flax within 1e-4. With a negative mean some of pre1's
    planes have a negative DC (phase +pi on both sides: the fused phase
    conv would carry a -pi there into the output as a 2 pi w change);
    constant features give exact zero bins off DC."""
    rng = np.random.default_rng(41)
    msf, panf = _planes(kind, rng), _planes(kind, rng)
    flax_mod = JaxFre(6)
    tree = _init_tree(flax_mod, msf, panf, seed=2)
    port = FreProcess(6)
    port.load_state_dict(_sub_sd(sfiin_from_flax, tree,
                                 ["block0", "fre_process"],
                                 "process.block.fre_process."), strict=True)
    with torch.no_grad():
        got = _nhwc(port(_nchw(msf), _nchw(panf)))
        dc = plane_rfft2(port.pre1(_nchw(msf)) + 1e-8)[:, :, 0, 0].real
    if kind == "negative_mean":
        assert (dc < 0).any() and (dc > 0).any()
    assert max_err(got, _run_flax(flax_mod, tree, msf, panf)) <= 1e-4


def test_spafre_matches_flax():
    """One SpaFre block (spatial InvBlock branch, frequency branch,
    attention gates, population-std contrast) vs flax: <= 1e-4."""
    rng = np.random.default_rng(42)
    msf, pan = f32(rng, 2, 16, 16, 8), f32(rng, 2, 16, 16, 8)
    flax_mod = JaxSpaFre(8)
    tree = _fill(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0),
                                jnp.asarray(msf), jnp.asarray(pan))["params"],
                 seed=3)
    want = flax_mod.apply({"params": jax.tree.map(jnp.asarray, tree)},
                          jnp.asarray(msf), jnp.asarray(pan))
    port = SpaFre(8)
    port.load_state_dict(_sub_sd(sfiin_from_flax, tree, ["block0"],
                                 "process.block."), strict=True)
    with torch.no_grad():
        got = port(_nchw(msf), _nchw(pan))
    for g, w in zip(got, want):
        assert max_err(_nhwc(g), w) <= 1e-4


@functools.lru_cache(maxsize=None)
def _shapes(c):
    return jax.eval_shape(JaxSFIIN(ms_chans=c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, c)),
                          jnp.zeros((1, 32, 32, 1)))["params"]


def _port(c, tree=None, **kw):
    port = build_model("SFIIN", Config(model_type="SFIIN", ms_chans=c, **kw),
                       device="cpu")
    if tree is not None:
        port.load_state_dict(sfiin_from_flax(tree), strict=True)
    return port


@pytest.mark.parametrize("c,ms_hw,pan", [
    (4, (8, 8), "random"), (8, (16, 16), "random"), (8, (8, 16), "random"),
    (4, (8, 8), "constant")])
def test_sfiin_matches_flax(c, ms_hw, pan):
    """TorchMethod.apply vs flax SFIINNet within 5e-4 (the bound of
    tests/test_torch_parity.py), at 8 bands and 16^2 MS (the shipped
    model: its widths are fixed), non-square, and with a constant PAN."""
    tree = _fill(_shapes(c), seed=c)
    rng = np.random.default_rng(50 + c)
    hw = (4 * ms_hw[0], 4 * ms_hw[1])
    batch = {"input_lr": rng.uniform(0, 1, (2, *ms_hw, c)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (2, *hw, 1)).astype(np.float32)}
    if pan == "constant":
        batch["input_pan"][:] = 0.6
    want = _run_flax(JaxSFIIN(ms_chans=c), tree, batch["input_lr"],
                     batch["input_pan"])
    got = _port(c, tree).apply(batch).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert max_err(got, want) <= 5e-4


def test_sfiin_roundtrip_is_exact_and_param_count():
    """sfiin_from_flax -> convert_state_dict gives the tree back bit for
    bit; the state_dict is the port's whole key set (the LU buffers
    included); the parameters are the flax leaves less the frozen LU
    values (85,850 at WV-3, the reference's 85.8 K)."""
    tree = _fill(_shapes(8), seed=5)
    sd = sfiin_from_flax(tree)
    port = _port(8, tree)
    assert set(port.module.state_dict()) == set(sd)
    assert "process.block4.spa_process.0.invconv.p" in sd
    back = convert_state_dict("SFIIN", {k: v.numpy() for k, v in sd.items()})
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
        sfiin_from_flax({**tree, "extra": np.zeros(2, np.float32)})


def test_sfiin_frequency_losses_refused():
    """(Named for the refusal it tested until the port computed these
    losses.) The shipped config weights the rfft2 amplitude and phase
    losses: on a seeded init carried to JAX, `losses` gives the three
    parts and the total of the JAX `SFIIN.losses` within 3e-4 relative
    (8 bands, PAN 32^2); a config of `rec_loss` alone still reports only
    that part."""
    cfg = load_config(os.path.join(REPO, "lgteun_tpu_torch", "configs",
                                   "SFIIN.py"))
    port = build_model("SFIIN", cfg, device="cpu")
    port.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    batch = {"input_lr": rng.uniform(0, 1, (1, 8, 8, 8)),
             "input_pan": rng.uniform(0, 1, (1, 32, 32, 1)),
             "target": rng.uniform(2, 3, (1, 32, 32, 8))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    with torch.no_grad():
        total, parts = port.losses(batch)
    jcfg = jax_load_config(os.path.join(REPO, "lgteun_tpu", "configs",
                                        "SFIIN.py"))
    tree = convert_state_dict("SFIIN", {k: v.numpy() for k, v in
                                        port.state_dict().items()})
    method = build_jax_model("SFIIN", jcfg)
    want_total, want = jax.jit(lambda p, b: method.losses(
        p, b, rng=jax.random.PRNGKey(0)))(
        {"core_module": jax.tree.map(jnp.asarray, tree)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(parts) == set(want) == {"rec_loss", "fre_amp_rec_loss",
                                       "fre_pha_rec_loss", "full_loss"}
    for k in want:
        assert abs(parts[k].item() - float(want[k])) <= 3e-4 * abs(
            float(want[k])), k
    assert total.item() == parts["full_loss"].item()
    rec = _port(8, loss_cfg={"rec_loss": LossCfg("l1", 1.0)})
    rec.load_state_dict(port.state_dict())
    total, parts = rec.losses(batch)
    assert set(parts) == {"rec_loss", "full_loss"} and torch.isfinite(total)


def test_sfiin_main_test_only_matches_jax_main(data_root, tmp_path,
                                               monkeypatch):
    """`main --test-only --device cpu` on SFIIN (4 bands, 64^2 and 128^2
    PAN) against JAX `main` on the same flax weights: log, curves, TIFFs
    and every per-image metric within the metric bounds."""
    check_main_against_jax("SFIIN", data_root, tmp_path, monkeypatch,
                           _fill(_shapes(BANDS), seed=7), sfiin_from_flax)
