"""The port's whole-scene engine and CLI (CPU) vs the JAX package:
`lgteun_tpu_torch/parallel/scene.py` against `lgteun_tpu/parallel/
scene.py`, and `python -m lgteun_tpu_torch.fuse` against a direct
`fuse_scene` call.

The engines share their geometry, so with the same weights (a flax
tree mapped by `lgteun_from_flax`) the port's scene must match JAX's
within the port's 5e-4 max-abs; the model is tests/test_scene.py's
(UnlgFormer, 4 bands, stage 1). Tile 48 gives 48^2 and 24^2 LGB blocks,
the sizes that need the mixed-radix mixer on a card, at test scale. At
those sizes the CPU XLA FFT leaves rounding noise in the imaginary part
of the self-conjugate bins (ROADMAP C.9), so the weights get integer
phase scales, under which a phase of -pi or +pi gives the same values
(tests/test_torch_port_lgb_engines.py).
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lgteun_tpu.models  # noqa: F401  (registers the JAX methods)
from lgteun_tpu.config import Config as JaxConfig, LossCfg
from lgteun_tpu.parallel import scene as jax_scene
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
from lgteun_tpu_torch.fuse import build_argparser, fuse_scene_files
from lgteun_tpu_torch.parallel import scene
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402


@pytest.mark.parametrize("n,t,s", [(1, 32, 16), (2, 32, 16), (5, 32, 24),
                                   (3, 128, 96), (4, 16, 16), (8, 144, 128)])
def test_cosine_ramp_weights_match_jax(n, t, s):
    assert np.array_equal(scene.cosine_ramp_weights(n, t, s),
                          jax_scene.cosine_ramp_weights(n, t, s))


@pytest.mark.parametrize("ny,nx,t,s,c", [(3, 5, 8, 6, 2), (1, 1, 8, 8, 1),
                                         (2, 3, 32, 16, 4),
                                         (4, 2, 16, 12, 3)])
def test_overlap_add_matches_jax(ny, nx, t, s, c):
    """The two-parity reshape overlap-add sums the same two terms per
    axis in the same order as JAX's: bit-equal."""
    tiles = np.random.default_rng(31).normal(
        size=(ny, nx, t, t, c)).astype(np.float32)
    wp, hp = (nx - 1) * s + t, (ny - 1) * s + t
    want = jax_scene._overlap_add_y(
        jax_scene._overlap_add_x(jnp.asarray(tiles), s, wp), s, hp)
    got = scene._overlap_add_y(
        scene._overlap_add_x(torch.from_numpy(tiles), s, wp), s, hp)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def methods():
    """(JAX method, its params, the port's method with the same
    weights): UnlgFormer, 4 bands, stage 1."""
    cfg = JaxConfig(model_type="UnlgFormer", ms_chans=4,
                    loss_cfg={"rec_loss": LossCfg()},
                    model_cfg={"core_module": {"stage": 1}})
    method = build_jax_model("UnlgFormer", cfg)
    rng = np.random.default_rng(30)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.choice([-2.0, -1.0, 1.0, 2.0], v.shape).astype(
            np.float32) if path[-1].key == "pha_scale" else v),
        flax_params(4, stage=1))
    port = build_model("UnlgFormer", Config(
        ms_chans=4, model_cfg={"core_module": {"stage": 1}}), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    return method, {"core_module": jax.tree.map(jnp.asarray, tree)}, port


def _scene(rng, h, w, c=4):
    ms = rng.uniform(0.1, 0.9, (h // 4, w // 4, c)).astype(np.float32)
    pan = rng.uniform(0.1, 0.9, (h, w, 1)).astype(np.float32)
    return ms, pan


@pytest.mark.parametrize("h,w,tile,halo", [(96, 96, 32, 8), (84, 68, 32, 8),
                                           (96, 96, 48, 8)])
def test_fuse_scene_matches_jax(methods, h, w, tile, halo):
    """Port vs JAX fuse_scene: the exactly tiling 96^2 scene, the
    non-divisible 84x68 (reflect padding and crop), and tile 48."""
    method, params, port = methods
    ms, pan = _scene(np.random.default_rng(32), h, w)
    want = np.asarray(jax_scene.fuse_scene(method, params, ms, pan,
                                           tile=tile, halo=halo, batch=4))
    got = scene.fuse_scene(port, ms, pan, tile=tile, halo=halo,
                           batch=4).numpy()
    assert got.shape == (h, w, 4) and np.isfinite(got).all()
    assert float(np.max(np.abs(got - want))) <= 5e-4


def test_fuse_scene_validation_errors(methods):
    """The JAX engine's checks and messages."""
    port = methods[2]
    ms, pan = _scene(np.random.default_rng(33), 64, 64)
    with pytest.raises(ValueError, match="halo"):
        scene.fuse_scene(port, ms, pan, tile=32, halo=12)
    with pytest.raises(ValueError, match="smaller"):
        scene.fuse_scene(port, ms, pan, tile=128)
    with pytest.raises(ValueError, match="does not match"):
        scene.fuse_scene(port, ms[:-1], pan, tile=32, halo=8)
    with pytest.raises(ValueError, match="multiples of 4"):
        scene.fuse_scene(port, ms, pan, tile=30, halo=4)


def _write_scene(tmp_path, rng, h, w, c):
    lr = rng.integers(0, 2047, (h // 4, w // 4, c)).astype(np.uint16)
    pan = rng.integers(0, 2047, (h, w)).astype(np.uint16)
    write_tiff(str(tmp_path / "lr.tif"), lr)
    write_tiff(str(tmp_path / "pan.tif"), pan)
    return lr, pan


def _cli(tmp_path, *extra):
    out = str(tmp_path / "fused.tif")
    args = build_argparser().parse_args([
        "--lr", str(tmp_path / "lr.tif"), "--pan", str(tmp_path / "pan.tif"),
        "-o", out, "--method", "UnlgFormer", "--stage", "1", "--tile", "32",
        "--halo", "8", "--batch", "2", "--device", "cpu", *extra])
    assert fuse_scene_files(args) == out
    return read_tiff(out)


def test_fuse_cli_matches_direct(tmp_path, methods):
    """The CLI with a state_dict checkpoint equals a direct fuse_scene
    call on the same weights (within 1 DN of the uint16 rounding): pins
    the normalise/denormalise round trip and the checkpoint load."""
    port = methods[2]
    lr, pan = _write_scene(tmp_path, np.random.default_rng(34), 64, 96, 4)
    ckpt = tmp_path / "weights.pt"
    torch.save(port.module.state_dict(), ckpt)
    got = _cli(tmp_path, "--checkpoint", str(ckpt)).astype(np.float64)
    assert got.shape == (64, 96, 4)
    scale = 2 ** 11 - 0.5
    want = scene.fuse_scene(port, lr / scale, pan[:, :, None] / scale,
                            tile=32, halo=8, batch=2).numpy()
    want = np.clip(np.round(want * scale), 0, 2047)
    assert float(np.max(np.abs(got - want))) <= 1.0


def test_fuse_cli_seeded_init_warns(tmp_path, caplog):
    """Without --checkpoint the CLI warns and fuses with the config's
    seeded init; the output is a uint16 scene of the input's size."""
    _write_scene(tmp_path, np.random.default_rng(35), 64, 64, 4)
    with caplog.at_level(logging.WARNING):
        fused = _cli(tmp_path, "--geo", "none")
    assert any("without --checkpoint" in r.message for r in caplog.records)
    assert fused.shape == (64, 64, 4) and fused.dtype == np.uint16
    assert fused.max() <= 2047
