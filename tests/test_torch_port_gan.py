"""Adversarial training and the QNR loss in the port (plain PyTorch, CPU)
against the JAX package.

- The three discriminators (`models/common/discriminators.py`) against
  JAX's flax modules on weights carried by `discriminator_from_flax`:
  the port's float32 within 1e-5 of max|out| of JAX's float64 run, the
  two float64 runs within 1e-12; `norm_type="BN"` raises in both.
- ROADMAP C.41: `VGGDiscriminator`'s stride-2 3x3 convs pad as flax's
  "SAME", (0, 1) on an even side: torch's symmetric (1, 1) gives another
  function. C.42: its fc0 takes JAX's NHWC flatten; the carry permutes
  fc0's rows to the port's NCHW flatten, and a transpose-only carry
  gives another function.
- `gan_d_loss` and `gan_g_loss` against JAX's for "GAN" (the inverted
  labels), "LSGAN" and "WGAN-GP" (the same eps given to both; the
  penalty's gradient made with create_graph): values within 1e-5
  relative, the discriminator's gradients and the generator output's
  gradient within 1e-4 of each tensor's largest.
- One adversarial `Runner.train_step` of LightNet with a
  PatchDiscriminator(n_feats=8, n_layers=2) against the JAX Runner's
  adversarial step (SGD on both; optimisers that also hand back the
  gradients): the losses (`adv_loss_G`, `adv_loss_D`, full) within 5e-4
  relative, both networks' gradients within 1e-2 of each tensor's
  largest and both networks' parameters after the step (PERF.md section
  2's training bounds). The G term is taken against the updated
  discriminator, whose weights get no gradient from it.
- A `QNR_loss` step (l1 + 0.1 QNR) against the JAX Runner's step.
- A checkpoint of both modules and both optimisers resumes bit-equal;
  `mixed_precision` with an adversarial loss warns and runs float32.

Inputs are made with numpy from a seed and cast to float32 (conftest
turns on jax_enable_x64).
"""

import logging
import os
import sys

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu.config import LossCfg as JaxLossCfg
from lgteun_tpu.losses import gan_d_loss as jax_gan_d_loss
from lgteun_tpu.losses import gan_g_loss as jax_gan_g_loss
from lgteun_tpu.models.common import discriminators as jax_disc
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config, LossCfg, OptimCfg
from lgteun_tpu_torch.convert.from_jax import (discriminator_from_flax,
                                               lightnet_from_flax)
from lgteun_tpu_torch.losses import gan_d_loss, gan_g_loss
from lgteun_tpu_torch.models.common import discriminators as disc
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_port_lightnet as t_lightnet  # noqa: E402
from test_torch_port_remat import (GRAD_TOL, LOSS_RTOL, batch32,  # noqa: E402
                                   grab, hold, jax_step, port_grads)

BANDS = 4
DISC = {"PixelDiscriminator": dict(n_feats=8),
        "PatchDiscriminator": dict(n_feats=8, n_layers=2),
        "VGGDiscriminator": {}}
LR_G, LR_D = 1e-2, 1e-1


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, b=2, side=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, side, side, BANDS)).astype(np.float32)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _pair(kind, side=32, seed=0, **kw):
    """(flax module, its params as numpy, the port's module with them)."""
    jmod = getattr(jax_disc, kind)(**{**DISC[kind], **kw})
    params = jmod.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, side, side, BANDS), jnp.float32))
    params = jax.tree.map(np.asarray, params["params"])
    extra = {"in_size": side} if kind == "VGGDiscriminator" else {}
    port = getattr(disc, kind)(BANDS, **{**DISC[kind], **kw, **extra})
    port.load_state_dict(discriminator_from_flax(params), strict=True)
    return jmod, params, port


def _jax_out(jmod, params, x):
    return np.asarray(jmod.apply({"params": jax.tree.map(jnp.asarray,
                                                          params)},
                                 jnp.asarray(x)))


@pytest.mark.parametrize("kind", sorted(DISC))
def test_discriminator_matches_jax(kind):
    """The port's float32 logits within 1e-5 of max|out| of the JAX module
    on the same weights, both run in float64 as the function; the two
    float64 runs within 1e-12. (JAX's own float32 run is the yardstick's
    weak side here: its one-pass instance-norm variance, summed by XLA's
    CPU reduction, is 2.1e-4 of max|out| off float64 on the
    PixelDiscriminator case; the port's float32 is 7e-6.)"""
    jmod, params, port = _pair(kind)
    x = _images(90)
    want = _jax_out(jmod, jax.tree.map(lambda a: a.astype(np.float64),
                                       params), x.astype(np.float64))
    nhwc = lambda t: (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()
    with torch.no_grad():
        got = nhwc(port(_nchw(x)))
        got64 = nhwc(port.double()(_nchw(x).double()))
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got64 - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("kind", ["PixelDiscriminator", "PatchDiscriminator"])
def test_batch_norm_raises_in_both(kind):
    with pytest.raises(ValueError, match="BN"):
        getattr(disc, kind)(BANDS, norm_type="BN")
    with pytest.raises(ValueError, match="BN"):
        getattr(jax_disc, kind)(norm_type="BN").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, BANDS)))


def test_c41_vgg_pads_as_flax_same():
    """"SAME" at stride 2 on an even side pads (0, 1), on an odd side
    (1, 1); the port's VGG computes JAX's function, and torch's symmetric
    padding another."""
    assert disc.same_pad(32, 3, 2) == (0, 1)
    assert disc.same_pad(33, 3, 2) == (1, 1)
    assert disc.same_pad(32, 3, 1) == (1, 1)
    jmod, params, port = _pair("VGGDiscriminator")
    x = _images(91)
    want = _jax_out(jmod, params, x)
    sym = _nchw(x)
    with torch.no_grad():
        for i in range(len(disc.VGG_FEATS)):
            conv = getattr(port, f"conv{i}")
            sym = F.leaky_relu(F.conv2d(sym, conv.weight, conv.bias,
                                        conv.stride, 1), 0.2)
        sym = port.fc1(F.leaky_relu(port.fc0(sym.flatten(1)), 0.2))
        got = port(_nchw(x))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert np.abs(sym.numpy() - want).max() > 1e-2 * scale


def test_c42_vgg_fc0_takes_the_nhwc_flatten():
    """fc0's rows permuted from (h, w, c) to (c, h, w): the carried port
    computes JAX's function; a carry that only transposes fc0 does not."""
    jmod, params, port = _pair("VGGDiscriminator", side=64)
    x = _images(92, side=64)
    assert disc.vgg_side(64) == 2
    want = _jax_out(jmod, params, x)
    bare = dict(discriminator_from_flax(params))
    bare["fc0.weight"] = torch.from_numpy(
        np.ascontiguousarray(params["fc0"]["kernel"].T))
    other = disc.VGGDiscriminator(BANDS, in_size=64)
    other.load_state_dict(bare)
    with torch.no_grad():
        got, off = port(_nchw(x)), other(_nchw(x))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert np.abs(off.numpy() - want).max() > 1e-3 * scale


@pytest.mark.parametrize("gan_type", ["GAN", "LSGAN", "WGAN-GP"])
def test_gan_losses_match_jax(gan_type):
    """Both losses' values and gradients against JAX's on the same
    PatchDiscriminator, fake and real (WGAN-GP: the same eps)."""
    jmod, params, port = _pair("PatchDiscriminator")
    fake, real = _images(93), _images(94)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)), np.float32)
    d_apply = lambda p, x: jmod.apply({"params": p}, x)
    jp = jax.tree.map(jnp.asarray, params)
    d_val, d_grads = jax.jit(jax.value_and_grad(lambda p: jax_gan_d_loss(
        d_apply, p, jnp.asarray(fake), jnp.asarray(real), gan_type,
        rng=key)))(jp)
    g_val, g_grad = jax.jit(jax.value_and_grad(lambda f: jax_gan_g_loss(
        d_apply, jp, f, gan_type)))(jnp.asarray(fake))

    got_d = gan_d_loss(port, _nchw(fake), _nchw(real), gan_type,
                       eps=torch.from_numpy(eps.transpose(0, 3, 1, 2)))
    got_d.backward()
    tf = _nchw(fake).requires_grad_()
    fixed = {k: v.detach() for k, v in port.named_parameters()}
    got_g = gan_g_loss(lambda x: torch.func.functional_call(
        port, fixed, (x,)), tf, gan_type)
    got_g.backward()
    for got, want in ((got_d, d_val), (got_g, g_val)):
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_d = {k: v.numpy() for k, v in discriminator_from_flax(
        jax.tree.map(np.asarray, d_grads)).items()}
    assert hold(port_grads(port), want_d, 1e-4) == len(want_d)
    gx = tf.grad.permute(0, 2, 3, 1).numpy()
    assert np.abs(gx - np.asarray(g_grad)).max() <= 1e-4 * np.abs(
        np.asarray(g_grad)).max()


def _adv_cfgs(gan_type, loss_extra=None):
    losses = {"rec_loss": ("l1", 1.0), "adv_loss": (gan_type, 1e-1),
              **(loss_extra or {})}
    mc = {"discriminator": dict(type="PatchDiscriminator", n_feats=8,
                                n_layers=2)}
    port = Config(model_type="lightnet", ms_chans=BANDS, max_iter=10,
                  model_cfg=mc,
                  optim_cfg={"core_module": OptimCfg(type="SGD", lr=LR_G),
                             "discriminator": OptimCfg(type="SGD",
                                                       lr=LR_D)},
                  loss_cfg={k: LossCfg(t, w) for k, (t, w) in
                            losses.items()})
    jcfg = JaxConfig(model_type="lightnet", ms_chans=BANDS, max_iter=10,
                     model_cfg=mc, loss_cfg={k: JaxLossCfg(t, w) for k, (t, w)
                                             in losses.items()})
    return port, jcfg


def _adv_port(cfg, tree, dparams):
    port = build_model("lightnet", cfg, device="cpu")
    port.init_params(torch.Generator().manual_seed(0), (8, 32))
    port.load_state_dict(lightnet_from_flax(tree))
    port.load_module_state_dict("discriminator",
                                discriminator_from_flax(dparams))
    return port


@pytest.mark.parametrize("gan_type", ["GAN", "LSGAN"])
def test_adversarial_step_matches_jax(gan_type):
    """One alternating step on the same weights and batch: losses, both
    networks' gradients and parameters after the step against JAX's."""
    cfg, jcfg = _adv_cfgs(gan_type)
    tree = t_lightnet.flax_params(BANDS, seed=31)
    _, dparams, _ = _pair("PatchDiscriminator", seed=32)
    batch = batch32(95, target=(0.0, 1.0))
    port = _adv_port(cfg, tree, dparams)
    assert port.module_names == ("core_module", "discriminator")
    runner = Runner(cfg, port, "cpu").set_optim()
    before = {m: {k: v.clone() for k, v in mod.state_dict().items()}
              for m, mod in port.modules().items()}
    parts = runner.train_step(runner.to_device(batch), 0)
    assert set(parts) == {"rec_loss", "adv_loss_G", "adv_loss_D",
                          "full_loss"}

    method = build_jax_model("lightnet", jcfg)
    params = {"core_module": jax.tree.map(jnp.asarray, tree),
              "discriminator": jax.tree.map(jnp.asarray, dparams)}
    txs = {"core_module": optax.chain(grab(keep=True), optax.sgd(LR_G)),
           "discriminator": optax.chain(grab(keep=True), optax.sgd(LR_D))}
    new, opt, want_parts = jax_step(jcfg, method, params, batch, txs=txs)
    for k, want in want_parts.items():
        assert abs(float(parts[k]) - want) <= LOSS_RTOL * abs(want), k
    carry = {"core_module": lightnet_from_flax,
             "discriminator": discriminator_from_flax}
    for m, mod in port.modules().items():
        to = lambda t: {k: v.numpy() for k, v in carry[m](
            jax.tree.map(np.asarray, t)).items()}
        assert hold(port_grads(mod), to(opt[m][0])) > 5
        lr = LR_G if m == "core_module" else LR_D
        moved = {k: (before[m][k] - v).numpy() / lr
                 for k, v in mod.state_dict().items()}
        want = {k: (before[m][k].numpy() - v) / lr
                for k, v in to(new[m]).items()}
        assert hold(moved, want, GRAD_TOL) > 5


def test_qnr_loss_step_matches_jax():
    """l1 + 0.1 QNR_loss (the PAN downsampled bicubic x1/4, align_corners
    True): one step's losses and gradients against the JAX Runner's."""
    losses = {"rec_loss": ("l1", 1.0), "QNR_loss": ("qnr", 0.1)}
    cfg = Config(model_type="lightnet", ms_chans=BANDS, max_iter=10,
                 loss_cfg={k: LossCfg(t, w) for k, (t, w) in losses.items()})
    jcfg = JaxConfig(model_type="lightnet", ms_chans=BANDS, max_iter=10,
                     loss_cfg={k: JaxLossCfg(t, w) for k, (t, w)
                               in losses.items()})
    tree = t_lightnet.flax_params(BANDS, seed=33)
    batch = batch32(96, target=(0.0, 1.0))
    port = build_model("lightnet", cfg, device="cpu")
    port.load_state_dict(lightnet_from_flax(tree))
    runner = Runner(cfg, port, "cpu").set_optim()
    parts = runner.train_step(runner.to_device(batch), 0)
    method = build_jax_model("lightnet", jcfg)
    _, opt, want_parts = jax_step(jcfg, method, {"core_module": jax.tree.map(
        jnp.asarray, tree)}, batch)
    assert set(parts) == set(want_parts) == {"rec_loss", "QNR_loss",
                                             "full_loss"}
    for k, want in want_parts.items():
        assert abs(float(parts[k]) - want) <= LOSS_RTOL * abs(want), k
    want = {k: v.numpy() for k, v in lightnet_from_flax(jax.tree.map(
        np.asarray, opt["core_module"])).items()}
    assert hold(port_grads(port.module), want) > 10


def test_adversarial_checkpoint_resumes_bit_equal(tmp_path):
    """Both modules and both optimisers (Adam) go into the checkpoint: a
    new Runner loaded from it takes the next step as the first does."""
    cfg, _ = _adv_cfgs("WGAN-GP")
    cfg.optim_cfg = {}
    cfg.work_dir = str(tmp_path)
    tree = t_lightnet.flax_params(BANDS, seed=34)
    _, dparams, _ = _pair("PatchDiscriminator", seed=35)
    first = Runner(cfg, _adv_port(cfg, tree, dparams), "cpu").set_optim()
    second = Runner(cfg, _adv_port(cfg, tree, dparams), "cpu")
    for it in range(2):
        first.train_step(first.to_device(batch32(97 + it)), it)
    path = first.save(2)
    second.load_checkpoint(path).set_optim()
    assert second.last_iter == 2
    for opt in ("core_module", "discriminator"):
        assert second.optimizers[opt].state_dict()["state"].keys() == \
            first.optimizers[opt].state_dict()["state"].keys()
    a = first.train_step(first.to_device(batch32(99)), 2)
    b = second.train_step(second.to_device(batch32(99)), 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for m in ("core_module", "discriminator"):
        sa = first.method.modules()[m].state_dict()
        sb = second.method.modules()[m].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_mixed_precision_with_adversarial_runs_float32(caplog):
    """As the JAX Runner: a warning, and the GAN step runs float32."""
    cfg, _ = _adv_cfgs("LSGAN")
    cfg.extras["mixed_precision"] = True
    port = build_model("lightnet", cfg, device="cpu")
    port.init_params(torch.Generator().manual_seed(0), (8, 32))
    with caplog.at_level(logging.WARNING, logger="lgteun_torch"):
        runner = Runner(cfg, port, "cpu").set_optim()
    assert "adversarial" in caplog.text and runner.blanket is None
    parts = runner.train_step(runner.to_device(batch32(98)), 0)
    assert all(v.dtype == torch.float32 for v in parts.values())
