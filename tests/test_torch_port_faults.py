"""The port's mended faults (ROADMAP C.14, C.27, C.28, C.29, C.33), on the
CPU.

- C.14: MDCUN's stage scalars and PReLU slopes load from a state_dict
  that holds them as [1] or as [] (the flax tree's form), stored as [1];
- C.27 (retired: the QNR and adversarial losses train, tests/
  test_torch_port_gan.py): an entry of weight 0 is no term of the loss;
- C.28: one checkpoint loader takes a Runner checkpoint and a bare
  state_dict, in `Runner.load_checkpoint` and in the scene CLI;
- C.29 (retired: `mixed_precision` and `remat` train, tests/
  test_torch_port_remat.py, test_torch_port_mixed*.py): the shipped
  config sets neither flag, and a Runner takes either set to False;
- C.33: the plain FFT mixer keeps the zero bins of planes constant along
  an axis (within rounding) exactly zero whatever the FFT library leaves
  there, so its output on them does not depend on the host or the thread
  count.
"""

import os

import numpy as np
import pytest
import torch

from lgteun_tpu_torch.config import Config, LossCfg, OptimCfg, load_config
from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
from lgteun_tpu_torch.fuse import build_argparser, fuse_scene_files
from lgteun_tpu_torch.parallel import scene
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "lgteun_tpu", "configs", "unlg_former.py")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU ops on one thread (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, bands, b=1, side=32):
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    return {"input_lr": u(b, side // 4, side // 4, bands),
            "input_pan": u(b, side, side, 1),
            "target": u(b, side, side, bands)}


# ---------------------------------------------------------------- C.14

def _mdcun():
    cfg = Config(model_type="MDCUN", ms_chans=4, model_cfg={
        "core_module": {"mid_channels": 16, "T": 2}})
    return build_model("MDCUN", cfg, device="cpu")


def _is_scalar_key(key: str, group: str) -> bool:
    """The PReLU slopes (`...act.weight`) or the stage scalars
    (`u.0`, `eta.1`, ...) of MDCUN's state_dict."""
    if group == "prelu":
        return key.endswith("act.weight")
    return key.split(".")[-2] in ("u", "eta", "gama", "delta")


@pytest.mark.parametrize("groups", [("prelu", "stage"), ("stage",),
                                    ("prelu",)],
                         ids=["all-0d", "stage-0d", "prelu-0d"])
def test_mdcun_loads_scalars_as_1_or_0d(groups):
    """A strict load of a state_dict whose scalars are [] (all, or only
    one group, the rest [1]) gives the forward of the [1] form, and the
    module keeps [1]."""
    src = _mdcun().init_params(torch.Generator().manual_seed(3))
    with torch.no_grad():       # distinct values, so a mix-up shows
        for i, p in enumerate(src.module.parameters()):
            if p.numel() == 1:
                p.fill_(0.3 + 0.01 * i)
    sd = src.module.state_dict()
    zero_d = {k: (v.reshape(()) if any(_is_scalar_key(k, g) for g in groups)
                  else v) for k, v in sd.items()}
    assert sum(v.dim() == 0 for v in zero_d.values()) >= 5 * len(groups)
    dst = _mdcun()
    dst.load_state_dict(zero_d, strict=True)
    assert all(p.shape == q.shape for p, q in zip(
        dst.module.parameters(), src.module.parameters()))
    batch = _batch(np.random.default_rng(4), 4, side=32)
    assert torch.equal(dst.apply(batch), src.apply(batch))


def test_mdcun_other_scalar_shape_still_raises():
    """Only [1] and [] are accepted for a scalar: [2] raises."""
    sd = _mdcun().init_params(torch.Generator().manual_seed(3)) \
        .module.state_dict()
    key = next(k for k in sd if _is_scalar_key(k, "stage"))
    sd[key] = torch.zeros(2)
    with pytest.raises(RuntimeError, match="size mismatch"):
        _mdcun().load_state_dict(sd, strict=True)


# ---------------------------------------------------------------- C.27

def _unlg(loss_cfg, **kw):
    cfg = Config(ms_chans=4, model_cfg={"core_module": {"stage": 1}},
                 loss_cfg=loss_cfg, **kw)
    return cfg, build_model("UnlgFormer", cfg, device="cpu")


def test_zero_weight_loss_entry_is_skipped():
    """An entry of weight 0 is no term of the loss: the total equals the
    l1 alone, and no part is reported for it."""
    rec = {"rec_loss": LossCfg("l1", 1.0)}
    _, alone = _unlg(rec)
    _, with_zero = _unlg(dict(rec, QNR_loss=LossCfg("l1", 0.0),
                              adv_loss=LossCfg("l1", 0.0)))
    alone.init_params(torch.Generator().manual_seed(0))
    with_zero.init_params(torch.Generator().manual_seed(0))
    batch = _batch(np.random.default_rng(2), 4)
    with torch.no_grad():
        (a, _), (b, parts) = alone.losses(batch), with_zero.losses(batch)
    assert torch.equal(a, b) and set(parts) == {"rec_loss", "full_loss"}


def test_shipped_unlg_former_config_trains():
    """The shipped config (l1 only) takes a training step: a finite loss
    and a gradient on the live parameters."""
    cfg = load_config(SHIPPED)
    runner = Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"),
                    "cpu").init().set_optim()
    parts = runner.train_step(runner.to_device(
        _batch(np.random.default_rng(5), cfg.ms_chans)), 0)
    assert torch.isfinite(parts["full_loss"]) and float(parts["rec_loss"]) > 0
    grads = [p.grad for p in runner.method.module.parameters()
             if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------- C.28

def _trained_runner(tmp_path):
    """A 4-band stage-1 UnlgFormer (the CLI's architecture for
    `--stage 1`) after 2 Adam steps, saved at iteration 2."""
    cfg, method = _unlg({"rec_loss": LossCfg("l1", 1.0)},
                        optim_cfg={"core_module": OptimCfg(lr=1e-3)},
                        work_dir=str(tmp_path / "runs"))
    runner = Runner(cfg, method, "cpu").init(7).set_optim()
    batch = runner.to_device(_batch(np.random.default_rng(8), 4))
    for it in range(2):
        runner.train_step(batch, it)
    method.eval()
    return runner, runner.save(2)


def test_cli_fuses_with_a_runner_checkpoint(tmp_path):
    """train 2 steps -> Runner.save -> the scene CLI with --checkpoint on
    that file gives a direct fuse_scene's output with those weights
    (within 1 DN of the uint16 rounding)."""
    runner, path = _trained_runner(tmp_path)
    rng = np.random.default_rng(9)
    lr = rng.integers(0, 2047, (16, 24, 4)).astype(np.uint16)
    pan = rng.integers(0, 2047, (64, 96)).astype(np.uint16)
    write_tiff(str(tmp_path / "lr.tif"), lr)
    write_tiff(str(tmp_path / "pan.tif"), pan)
    out = str(tmp_path / "fused.tif")
    args = build_argparser().parse_args([
        "--lr", str(tmp_path / "lr.tif"), "--pan", str(tmp_path / "pan.tif"),
        "-o", out, "--stage", "1", "--tile", "32", "--halo", "8",
        "--batch", "2", "--device", "cpu", "--checkpoint", path])
    assert fuse_scene_files(args) == out
    got = read_tiff(out).astype(np.float64)
    scale = 2 ** 11 - 0.5
    want = scene.fuse_scene(runner.method, lr / scale,
                            pan[:, :, None] / scale, tile=32, halo=8,
                            batch=2).numpy()
    want = np.clip(np.round(want * scale), 0, 2047)
    assert got.shape == (64, 96, 4)
    assert float(np.max(np.abs(got - want))) <= 1.0


def test_load_checkpoint_takes_a_bare_state_dict(tmp_path):
    """A bare state_dict (the CLI's and convert/from_jax.py's form)
    loads through Runner.load_checkpoint: the same weights, and no
    iteration or optimizer state; a Runner checkpoint still restores
    both."""
    runner, path = _trained_runner(tmp_path)
    bare = tmp_path / "bare.pt"
    torch.save(runner.method.module.state_dict(), bare)
    cfg, method = _unlg({"rec_loss": LossCfg("l1", 1.0)})
    fresh = Runner(cfg, method, "cpu").init(11)
    fresh.load_checkpoint(str(bare))
    want = runner.method.module.state_dict()
    got = fresh.method.module.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert fresh.last_iter == 0 and fresh._restored is None
    fresh.load_checkpoint(path)
    assert fresh.last_iter == 2 and fresh._restored is not None


# ---------------------------------------------------------------- C.29

def test_shipped_config_flags_do_not_raise():
    """The shipped config sets neither flag (steps_per_dispatch stays
    ignored), and a Runner is built from it; a flag set to False is
    accepted too."""
    cfg = load_config(SHIPPED)
    assert not cfg.get("mixed_precision") and not cfg.get("remat")
    Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"), "cpu")
    cfg.extras.update(mixed_precision=False, remat=False)
    Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"), "cpu")


# ---------------------------------------------------------------- C.33

def _noisy_rfft2(rfft2):
    """An FFT library that leaves rounding noise (2^-30 of the plane's
    scale) in every bin, as one on another host may in the zero bins."""
    def noisy(x, *args, **kwargs):
        z = rfft2(x, *args, **kwargs)
        gen = torch.Generator().manual_seed(0)
        scale = 2.0 ** -30 * x.abs().amax((-2, -1), keepdim=True)
        noise = torch.complex(torch.randn(z.shape, generator=gen),
                              torch.randn(z.shape, generator=gen))
        return z + noise.to(z.dtype) * scale
    return noisy


def _constant_planes(axis, b=2, c=8, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, c, 1, w) if axis == "H" else (b, c, h, 1)
    return torch.from_numpy(np.broadcast_to(
        rng.standard_normal(shape), (b, c, h, w)).astype(np.float32))


def _mixer_params(c, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(c).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("axis", ["H", "W"])
def test_plane_rfft2_keeps_exact_zero_bins_on_any_backend(axis,
                                                          monkeypatch):
    """C.33: on planes constant along an axis, the plain mixer's spectrum
    is exactly zero off that axis's bin 0, also through an FFT library
    that leaves noise there; planes that are not constant keep every
    bin."""
    from lgteun_tpu_torch.ops.spectral_kernel import plane_rfft2
    monkeypatch.setattr(torch.fft, "rfft2", _noisy_rfft2(torch.fft.rfft2))
    x = _constant_planes(axis)
    z = plane_rfft2(x)
    off = z[..., 1:, :] if axis == "H" else z[..., :, 1:]
    assert torch.all(off == 0)
    kept = z[..., :1, :] if axis == "H" else z[..., :, :1]
    assert torch.all(kept != 0)
    y = x.clone()
    y[:, :, 3, 5] += 1.0
    assert torch.count_nonzero(plane_rfft2(y)) == z.numel()


@pytest.mark.parametrize("axis", ["H", "W"])
def test_plain_mixer_on_constant_planes_ignores_fft_noise(axis, monkeypatch):
    """C.33: the mixer head's plain version on planes constant along an
    axis gives within 1e-6 the same output through an FFT library that
    leaves 2^-30 noise in its bins: the zero bins take no noise phase
    (unmended, the phase scale carries it into the output at O(amp_b))."""
    from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head_ref
    x = _constant_planes(axis, c=16)
    ln = [torch.ones(16), torch.zeros(16)]
    want = ln_mixer_head_ref(x, *ln, *_mixer_params(8))[1]
    monkeypatch.setattr(torch.fft, "rfft2", _noisy_rfft2(torch.fft.rfft2))
    got = ln_mixer_head_ref(x, *ln, *_mixer_params(8))[1]
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("axis", ["H", "W"])
def test_plain_mixer_on_planes_constant_within_rounding(axis):
    """C.33: a constant plane whose values are a rounding apart here and
    there (as a CPU LayerNorm's reductions may leave them) mixes as the
    exact constant plane does, within 1e-6: its off-axis bins, rounding
    noise, are zero and take no noise phase; a plane that is not
    constant keeps them."""
    from lgteun_tpu_torch.ops.spectral_kernel import (global_mixer_ref,
                                                      plane_rfft2)
    x = _constant_planes(axis, c=8)
    rng = np.random.default_rng(5)
    bits = x.clone().view(torch.int32)
    pick = torch.from_numpy(rng.random(x.shape) < 0.05)
    bits[pick] += torch.from_numpy(rng.integers(-2, 3, x.shape).astype(
        np.int32))[pick]
    near = bits.view(torch.float32)
    assert not torch.equal(near, x)
    params = _mixer_params(8)
    want = global_mixer_ref(x, *params)
    got = global_mixer_ref(near, *params)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    z = plane_rfft2(near)
    assert torch.all((z[..., 1:, :] if axis == "H" else z[..., :, 1:]) == 0)
    y = near.clone()
    y[:, :, 2, 3] += 1e-3
    z = plane_rfft2(y)
    assert torch.count_nonzero(z) == z.numel()


@pytest.mark.parametrize("axis", ["H", "W"])
def test_plain_mixer_on_constant_planes_same_bits_at_any_thread_count(axis):
    """C.33: the mixer head's plain version on constant planes gives the
    same bits on 1 thread and on 4."""
    from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head_ref
    x = _constant_planes(axis, b=4, c=32, h=72, w=72)
    args = [torch.ones(32), torch.zeros(32), *_mixer_params(16)]
    one = ln_mixer_head_ref(x, *args)
    torch.set_num_threads(4)
    four = ln_mixer_head_ref(x, *args)
    assert all(torch.equal(a, b) for a, b in zip(one, four))
