"""The port's classical methods (GSA, SFIM, Wavelet) and their ops
(`ops/interp23.py`, `ops/wavelet.py`, `models/classical.py`) on the CPU
against the JAX package's: in float64 at the bounds of
`tests/test_classical.py` (interp23 1e-10, Haar 1e-12, SFIM and Wavelet
1e-8, GSA 1e-6) and in float32 within 1e-5 max-abs (GSA 1e-4), GSA also
with a constant band (a rank-deficient least squares); and the registered
methods through the Runner: no module, no parameters, nothing to train,
an empty checkpoint; GSA through `python -m lgteun_tpu_torch.main
--test-only` against JAX `main` (the checks of
tests/test_torch_port_main.py)."""

import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.models import classical as jax_classical
from lgteun_tpu.ops import interp23 as jax_interp23
from lgteun_tpu.ops import wavelet as jax_wavelet
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.models import classical
from lgteun_tpu_torch.ops import interp23, wavelet
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_main import (check_main_against_jax,  # noqa: E402
                                  data_root)

FUSE = ("sfim_fuse", "gsa_fuse", "wavelet_fuse")
F64_ATOL = {"sfim_fuse": 1e-8, "gsa_fuse": 1e-6, "wavelet_fuse": 1e-8}
F32_ATOL = {"sfim_fuse": 1e-5, "gsa_fuse": 1e-4, "wavelet_fuse": 1e-5}


def _inputs(rng, b, h, c, dtype, constant_band=False):
    lrms = rng.uniform(0.1, 0.9, (b, h, h, c))
    pan = rng.uniform(0.1, 0.9, (b, 4 * h, 4 * h, 1))
    if constant_band:
        lrms[..., 1] = 0.4375
    return lrms.astype(dtype), pan.astype(dtype)


@pytest.mark.parametrize("n_in,ratio", [(8, 4), (32, 4), (16, 2), (5, 8)])
def test_interp23_matrix_equals_jax(n_in, ratio):
    np.testing.assert_array_equal(interp23.interp23_matrix(n_in, ratio),
                                  jax_interp23.interp23_matrix(n_in, ratio))


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-10),
                                        (np.float32, 1e-5)])
def test_interp23_upsample_matches_jax(dtype, atol):
    x = np.random.default_rng(1).uniform(0, 1, (2, 8, 12, 3)).astype(dtype)
    got = interp23.interp23_upsample(torch.from_numpy(x), 4)
    want = jax_interp23.interp23_upsample(jnp.asarray(x), 4)
    assert got.shape == (2, 32, 48, 3) and got.dtype == torch.from_numpy(
        x).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_haar_pair_matches_jax(dtype, atol):
    x = np.random.default_rng(2).standard_normal((2, 3, 32, 16)).astype(dtype)
    got = wavelet.haar_wavedec2(torch.from_numpy(x), level=2)
    want = jax_wavelet.haar_wavedec2(jnp.asarray(x), level=2)
    flat = lambda cs: [cs[0]] + [d for det in cs[1:] for d in det]
    for g, w in zip(flat(got), flat(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)
    rec = wavelet.haar_waverec2(got)
    np.testing.assert_allclose(rec.numpy(), np.asarray(
        jax_wavelet.haar_waverec2(want)), rtol=0, atol=atol)
    np.testing.assert_allclose(rec.numpy(), x, rtol=0, atol=10 * atol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("b,h,c", [(2, 8, 4), (1, 32, 8)])
@pytest.mark.parametrize("fn", FUSE)
def test_fuse_matches_jax(fn, b, h, c, dtype):
    lrms, pan = _inputs(np.random.default_rng(h + c), b, h, c, dtype)
    got = getattr(classical, fn)(torch.from_numpy(lrms),
                                 torch.from_numpy(pan))
    want = np.asarray(jax.jit(getattr(jax_classical, fn))(
        jnp.asarray(lrms), jnp.asarray(pan)))
    atol = (F64_ATOL if dtype == np.float64 else F32_ATOL)[fn]
    assert got.shape == (b, 4 * h, 4 * h, c)
    assert got.dtype == torch.from_numpy(lrms).dtype
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gsa_with_a_constant_band_matches_jax(dtype):
    """A constant LrMS band is collinear with the bias column of GSA's
    design: the minimum-norm solution (SVD), as jnp.linalg.lstsq."""
    lrms, pan = _inputs(np.random.default_rng(5), 2, 32, 4, dtype,
                        constant_band=True)
    got = classical.gsa_fuse(torch.from_numpy(lrms), torch.from_numpy(pan))
    want = np.asarray(jax.jit(jax_classical.gsa_fuse)(jnp.asarray(lrms),
                                                      jnp.asarray(pan)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0,
        atol=F64_ATOL["gsa_fuse"] if dtype == np.float64 else
        F32_ATOL["gsa_fuse"])


def test_lstsq_min_norm_on_a_rank_deficient_design():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((3, 40, 4))
    a[..., 2] = a[..., 0]                       # rank 3
    y = rng.standard_normal((3, 40, 1))
    got = classical.lstsq_min_norm(torch.from_numpy(a), torch.from_numpy(y))
    for i in range(3):
        want = np.linalg.lstsq(a[i], y[i], rcond=None)[0]
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[:, 0].numpy(), got[:, 2].numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["GSA", "SFIM", "Wavelet"])
def test_classical_method_through_the_runner(name, tmp_path):
    """The registered method applies its fuse function on NHWC tensors on
    its device; the Runner's init, set_optim, train, save and
    load_checkpoint take a method with no module."""
    cfg = Config(model_type=name, ms_chans=4, work_dir=str(tmp_path),
                 max_iter=3)
    method = build_model(name, cfg, device="cpu")
    assert not method.trainable and not hasattr(method, "module")
    runner = Runner(cfg, method, "cpu", logger=logging.getLogger("t"))
    runner.init().set_optim().train()
    assert runner.optimizer is None and runner.last_iter == 0
    path = runner.save(0)
    assert torch.load(path, weights_only=True)["state_dict"] == {}
    runner.load_checkpoint(path)
    lrms, pan = _inputs(np.random.default_rng(0), 2, 8, 4, np.float32)
    got = method.apply({"input_lr": lrms, "input_pan": pan})
    fn = getattr(classical, f"{name.lower()}_fuse")
    np.testing.assert_array_equal(got.numpy(), fn(
        torch.from_numpy(lrms), torch.from_numpy(pan)).numpy())
    with pytest.raises(ValueError, match="no parameters"):
        method.load_state_dict({"w": torch.zeros(1)})


def test_gsa_main_test_only_matches_jax_main(data_root, tmp_path,
                                             monkeypatch):
    check_main_against_jax("GSA", data_root, tmp_path, monkeypatch)
