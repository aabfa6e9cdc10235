"""The port's metric suite (`lgteun_tpu_torch/metrics`, `ops/filters.py`)
on the CPU against the JAX package's: every batched torch metric against
`jax_metrics` (float32, same inputs) and against the port's float64
oracle `numpy_ref`, at the bounds `tests/test_metrics.py` holds JAX to
(PSNR, SSIM, ERGAS rtol 1e-4; Q, SAM rtol 1e-3; D_lambda, D_s atol
2e-4; QNR atol 4e-4), at 4 and 8 bands on 128^2 predictions and 32^2
LrMS, with and without flat 8x8 / 32x32 windows (saturated and constant
blocks, where E[a^2] - mu^2 cancels in float32 and `_uqi_map`'s 1e-8
thresholds pick a branch); the differentiable global family in value and
gradient against `jax.grad`; and the port's `numpy_ref`, a copy, against
the JAX package's bit for bit."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from lgteun_tpu.metrics import jax_metrics as JM
from lgteun_tpu.metrics import numpy_ref as JR
from lgteun_tpu.ops import filters as jax_filters
from lgteun_tpu_torch.metrics import numpy_ref as R
from lgteun_tpu_torch.metrics import oracle
from lgteun_tpu_torch.metrics import torch_metrics as TM
from lgteun_tpu_torch.ops import filters

REF_RTOL = {"psnr": 1e-4, "ssim": 1e-4, "ergas": 1e-4, "qindex": 1e-3,
            "sam": 1e-3}
NO_REF_ATOL = {"d_lambda": 2e-4, "d_s": 2e-4, "qnr": 4e-4}


def _ref_pair(rng, c, flat):
    """Two [128, 128, C] DN images (float32 values): gt uniform, pred gt
    plus noise; `flat` adds saturated (2047.5) and zero 24x24 blocks in
    both and a block flat in pred only."""
    gt = rng.uniform(0.0, 2047.5, (2, 128, 128, c))
    pred = np.clip(gt + rng.normal(0, 40.0, gt.shape), 0, 2047.5)
    if flat:
        for a in (pred, gt):
            a[:, 8:32, 8:32] = 2047.5
            a[:, 40:64, 40:64] = 0.0
        pred[:, 80:104, 80:104] = 1800.0
    return pred.astype(np.float32), gt.astype(np.float32)


def _no_ref_inputs(rng, c, flat):
    """Normalised pred [1, 128, 128, C], LrMS [1, 32, 32, C], PAN
    [1, 128, 128, 1]; `flat` saturates a 64x64 block of pred (every band
    1.0: flat 32x32 windows in every band pair) and makes LrMS and PAN
    constant over blocks."""
    pred = rng.uniform(0, 1, (1, 128, 128, c))
    lrms = rng.uniform(0, 1, (1, 32, 32, c))
    pan = rng.uniform(0, 1, (1, 128, 128, 1))
    if flat:
        pred[:, 16:80, 16:80] = 1.0
        lrms[:, 4:20, 4:20] = 0.5
        pan[:, 16:80, 16:80] = 0.75
    return tuple(x.astype(np.float32) for x in (pred, lrms, pan))


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("c", [4, 8])
def test_ref_metrics_match_jax_and_oracle(c, flat):
    rng = np.random.default_rng(c + 10 * flat)
    pred, gt = _ref_pair(rng, c, flat)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    got = {
        "psnr": TM.psnr_batch(tp, tg), "ssim": TM.ssim_batch(tp, tg),
        "qindex": TM.qindex_batch(tp, tg), "sam": TM.sam_batch(tp, tg),
        "ergas": TM.ergas_batch(tp, tg)}
    assert {k: v.numpy().tolist() for k, v in got.items()} == {
        k: v.numpy().tolist() for k, v in TM.ref_evaluate_batch(
            tp, tg).items()}
    want_jax = jax.jit(JM.ref_evaluate_batch)(pred, gt)
    oracle = [R.ref_evaluate(pred[i].astype(np.float64),
                             gt[i].astype(np.float64)) for i in range(2)]
    for j, k in enumerate(("psnr", "ssim", "qindex", "sam", "ergas")):
        assert got[k].dtype == torch.float32 and got[k].shape == (2,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_jax[k]),
                                   rtol=REF_RTOL[k], err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), [o[j] for o in oracle],
                                   rtol=REF_RTOL[k], err_msg=k)


def test_sam_at_small_angles_matches_oracle():
    """A good fusion's SAM (about 5 mrad, with zero pixels and a pixel of
    opposite sign): the port's atan2 form stays within 1e-5 of float64,
    where float32's arccos of a cosine near 1 does not; JAX's arccos form
    within the suite's 1e-3."""
    rng = np.random.default_rng(21)
    gt = rng.uniform(100, 2000, (2, 64, 64, 8))
    pred = gt * (1 + rng.normal(0, 0.004, gt.shape))
    pred[0, :5, :5] = 0
    gt[1, :3, :3] = 0
    pred[1, 10:12, 10:12] *= -1
    pred, gt = pred.astype(np.float32), gt.astype(np.float32)
    got = TM.sam_batch(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    want = [R.sam(pred[i].astype(np.float64), gt[i].astype(np.float64))
            for i in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(JM.sam_batch(pred, gt)),
                               rtol=REF_RTOL["sam"])


@pytest.mark.parametrize("c,flat", [(4, False), (8, True)],
                         ids=["4-random", "8-flat"])
def test_no_ref_metrics_match_jax_and_oracle(c, flat):
    """D_lambda (all band pairs in one conv), D_s (the PAN's MTF lowpass
    on the device) and QNR; the oracle's qnr is (1 - D_lambda)(1 - D_s)
    of its own D_lambda and D_s, as `numpy_ref.qnr` at alpha = beta = 1
    computes it (`oracle.no_ref_scores`)."""
    rng = np.random.default_rng(100 + c + 10 * flat)
    pred, lrms, pan = _no_ref_inputs(rng, c, flat)
    t = [torch.from_numpy(x) for x in (pred, lrms, pan)]
    got = TM.no_ref_evaluate_batch(*t)
    np.testing.assert_array_equal(got["d_lambda"].numpy(),
                                  TM.d_lambda_batch(t[0], t[1]).numpy())
    np.testing.assert_array_equal(got["d_s"].numpy(),
                                  TM.d_s_batch(*t).numpy())
    want_jax = jax.jit(JM.no_ref_evaluate_batch)(pred, lrms, pan)
    want = oracle.no_ref_scores(pred[0], lrms[0], pan[0])
    for k, atol in NO_REF_ATOL.items():
        assert got[k].shape == (1,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_jax[k]),
                                   atol=atol, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k].numpy()[0], want[k], atol=atol,
                                   rtol=0, err_msg=k)


def test_no_ref_oracle_equals_numpy_ref_bit_for_bit():
    """With each window statistic filtered once (`shared_window_stats`),
    numpy_ref's D_lambda and D_s keep every bit, and QNR formed from them
    as `oracle.no_ref_scores` forms it is `numpy_ref.qnr`'s (3 bands,
    64^2 with 16^2 LrMS, a flat block in each, 8x8 windows); numpy_ref's
    filter is put back."""
    rng = np.random.default_rng(7)
    pred = rng.uniform(0, 1, (64, 64, 3))
    lrms = rng.uniform(0, 1, (16, 16, 3))
    pan = rng.uniform(0, 1, (64, 64, 1))
    pred[8:40, 8:40] = 0.75
    lrms[2:10, 2:10] = 0.5
    plain = R._filter_valid
    want = [R.d_lambda(pred, lrms, 8), R.d_s(pred, lrms, pan, block_size=8)]
    with oracle.shared_window_stats():
        assert R._filter_valid is not plain
        got = [R.d_lambda(pred, lrms, 8),
               R.d_s(pred, lrms, pan, block_size=8)]
    assert R._filter_valid is plain
    assert np.isfinite(got).all() and got == want
    assert (1.0 - got[0]) * (1.0 - got[1]) == R.qnr(pred, lrms, pan,
                                                    block_size=8)


@pytest.mark.parametrize("size,shape", [(8, (2, 32, 32, 3)),
                                        (11, (1, 24, 40, 2)),
                                        (32, (1, 32, 32, 2)),
                                        (5, (2, 17, 9, 1))])
def test_filter2d_reflect101_matches_jax_and_scipy(size, shape):
    """cv2.filter2D semantics: reflect-101 border, centre anchor, the
    uneven (4, 3) pad of an 8x8 box and (16, 15) of D_lambda's 32x32 on
    a 32x32 LrMS, against JAX (float32) and scipy's correlate with the
    'mirror' border (float64)."""
    rng = np.random.default_rng(size)
    x = rng.uniform(0, 1, shape)
    kernel = rng.uniform(-1, 1, (size, size))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    got64 = filters.filter2d_reflect101(nchw(x), kernel).permute(0, 2, 3, 1)
    want64 = np.stack([np.stack([ndimage.correlate(x[b, ..., ch], kernel,
                                                   mode="mirror")
                                 for ch in range(shape[-1])], -1)
                       for b in range(shape[0])])
    np.testing.assert_allclose(got64.numpy(), want64, rtol=1e-12,
                               atol=1e-12)
    x32 = x.astype(np.float32)
    got32 = filters.filter2d_reflect101(nchw(x32), kernel)
    want32 = jax_filters.filter2d_reflect101(
        jnp.asarray(x32), kernel.astype(np.float32))
    assert got32.dtype == torch.float32
    # float32 sums of up to 1024 products in two orders
    np.testing.assert_allclose(got32.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want32), rtol=0,
                               atol=1e-5 * np.abs(want64).max())


def test_depthwise_conv2d_is_a_valid_correlation():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    k = rng.standard_normal((4, 3)).astype(np.float32)
    got = filters.depthwise_conv2d(torch.from_numpy(x), k, stride=2)
    want = jax_filters.depthwise_conv2d(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(k), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


def _global_inputs(rng):
    pred = rng.uniform(0, 1, (2, 16, 16, 4)).astype(np.float32)
    lrms = rng.uniform(0, 1, (2, 16, 16, 4)).astype(np.float32)
    pan = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    lpan = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    return pred, lrms, pan, lpan


@pytest.mark.parametrize("name", ["qindex_global", "d_lambda_global",
                                  "d_s_global"])
def test_global_family_value_and_gradient_match_jax(name):
    """The QNR loss's differentiable family: value and the gradient with
    respect to the prediction, torch autograd vs jax.grad (float32 in
    both: values, which are O(1) differences of O(1) terms, within 1e-5;
    gradients allclose with an atol of 1e-5 x the largest)."""
    pred, lrms, pan, lpan = _global_inputs(np.random.default_rng(7))
    calls = {
        "qindex_global": (lambda m, p: m.qindex_global(p[..., 0],
                                                       p[..., 1])),
        "d_lambda_global": (lambda m, p, l=lrms: m.d_lambda_global(
            _as(m, l), p)),
        "d_s_global": (lambda m, p: m.d_s_global(
            _as(m, lrms), _as(m, pan), _as(m, lpan), p)),
    }
    fn = calls[name]
    tp = torch.from_numpy(pred).requires_grad_(True)
    value = fn(TM, tp)
    value.backward()
    jvalue, jgrad = jax.value_and_grad(lambda p: fn(JM, p))(
        jnp.asarray(pred))
    assert value.dtype == torch.float32
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=0,
                               atol=1e-5)
    g, jg = tp.grad.numpy(), np.asarray(jgrad)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, jg, rtol=1e-4,
                               atol=1e-5 * np.abs(jg).max())


def _as(module, a):
    return torch.from_numpy(a) if module is TM else jnp.asarray(a)


def test_numpy_ref_copy_equals_the_jax_packages_bit_for_bit():
    """The port's oracle is a copy: every function gives the JAX
    package's numbers, exactly (4 bands at 64^2 / 16^2 with 8x8 windows;
    the default 32x32 windows on a 2-band 128^2 / 32^2 image)."""
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 2047.5, (64, 64, 4))
    gt = np.clip(pred + rng.normal(0, 30, pred.shape), 0, 2047.5)
    lrms = rng.uniform(0, 1, (16, 16, 4))
    pan = rng.uniform(0, 1, (64, 64))
    pn = pred / 2047.5
    assert R.DYNAMIC_RANGE == JR.DYNAMIC_RANGE
    assert R._SAT_GNYQ == JR._SAT_GNYQ
    for fn in ("psnr", "ssim", "qindex", "sam", "ergas", "scc",
               "ref_evaluate"):
        assert getattr(R, fn)(pred, gt) == getattr(JR, fn)(pred, gt), fn
    for fn in ("d_lambda", "d_s"):
        args = (pn, lrms) + ((pan[..., None],) if fn == "d_s" else ())
        assert getattr(R, fn)(*args, block_size=8) == getattr(JR, fn)(
            *args, block_size=8), fn
    assert R.qnr(pn, lrms, pan[..., None], block_size=8, alpha=0.5,
                 beta=2.0) == JR.qnr(pn, lrms, pan[..., None],
                                     block_size=8, alpha=0.5, beta=2.0)
    big = [rng.uniform(0, 1, s) for s in ((128, 128, 2), (128, 128),
                                          (32, 32, 2))]
    no_ref = R.no_ref_evaluate(*big)
    assert np.isfinite(no_ref).all() and no_ref == JR.no_ref_evaluate(*big)
    for args in ((0.15, 4, 41), (0.29, 4, 41), (0.34, 2, 21)):
        np.testing.assert_array_equal(R.mtf_kernel(*args),
                                      JR.mtf_kernel(*args))
    np.testing.assert_array_equal(R.mtf_kernel_from_alpha(3.7, 41),
                                  JR.mtf_kernel_from_alpha(3.7, 41))
    np.testing.assert_array_equal(R.mtf_degrade_pan(pan, "IKONOS"),
                                  JR.mtf_degrade_pan(pan, "IKONOS"))
