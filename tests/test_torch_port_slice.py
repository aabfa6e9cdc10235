"""The port's UnlgFormer eval slice on CPU vs the JAX package.

Same weights (a flax tree mapped with `lgteun_from_flax`), same float32
inputs: the port's plain path must match the JAX Method (flax module
path) and the channel-major `lgteun_fast_forward` within 5e-4 max-abs,
the port bound of ROADMAP.md.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.config import Config, load_config as jax_load_config
from lgteun_tpu.metrics.jax_metrics import psnr_batch as jax_psnr_batch
from lgteun_tpu.models.lgteun_fast import lgteun_fast_forward
from lgteun_tpu.registry import build_model as build_jax_model
from lgteun_tpu_torch.config import Config as PortConfig, load_config
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.data.pipeline import data_denormalize, eval_batches
from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(c, config=Config, **kw):
    return config(ms_chans=c, model_cfg={"core_module": {"stage": 2}}, **kw)


def _port(c, tree):
    port = build_model("UnlgFormer", _cfg(c, PortConfig), device="cpu")
    port.load_state_dict(lgteun_from_flax(tree))
    return port


@pytest.mark.parametrize("c", [4, 8])
def test_unlgformer_matches_jax(c):
    rng = np.random.default_rng(11)
    batch = {"input_lr": rng.uniform(0, 1, (2, 8, 8, c)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)}
    tree = flax_params(c, seed=c)
    got = _port(c, tree).apply(batch).numpy()
    jtree = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    method = build_jax_model("UnlgFormer", _cfg(c))
    want_module = jax.jit(method.apply)({"core_module": jtree}, jbatch)
    want_fast = jax.jit(lambda p, ms, pan: lgteun_fast_forward(
        p, ms, pan, stage=2))(jtree, jbatch["input_lr"], jbatch["input_pan"])
    assert got.shape == (2, 32, 32, c) and np.isfinite(got).all()
    for want in (want_module, want_fast):
        err = float(np.max(np.abs(got - np.asarray(want))))
        assert err <= 5e-4, err


class _MemoryDataset:
    """PSDataset-shaped items (NHWC, 11-bit DN) held in memory."""

    def __init__(self, n, c, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{
            "input_lr": rng.uniform(0, 2047, (8, 8, c)).astype(np.float32),
            "input_pan": rng.uniform(0, 2047, (32, 32, 1)).astype(np.float32),
            "target": rng.uniform(0, 2047, (32, 32, c)).astype(np.float32),
        } for _ in range(n)]
        self.pairs = [(f"img{i}",) for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_runner_psnr_matches_jax_metric():
    """Runner.test over 3 images at batch 2 (a padded, ragged tail)
    scores the same PSNR as the JAX psnr_batch on the same predictions
    (float32 metric in both: <= 1e-4 dB)."""
    c = 4
    cfg = _cfg(c, PortConfig, eval_batch_size=2)
    ds = _MemoryDataset(3, c)
    runner = Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"), "cpu")
    runner.load(lgteun_from_flax(flax_params(c)))
    mean, std = runner.test(ds)["psnr"]
    want = []
    for batch, n_valid in eval_batches(ds, 2):
        pred = runner.predict(runner.to_device(batch)).numpy()
        scores = jax_psnr_batch(
            data_denormalize(jnp.asarray(pred), cfg.bit_depth),
            data_denormalize(jnp.asarray(batch["target"], jnp.float32),
                             cfg.bit_depth),
            dynamic_range=2.0 ** cfg.bit_depth - 0.5)
        want.extend(np.asarray(scores)[:n_valid].tolist())
    assert len(want) == 3
    assert abs(mean - np.mean(want)) <= 1e-4
    assert abs(std - np.std(want)) <= 1e-4
    assert runner.last_time_per_image > 0
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_port_imports_no_jax(tmp_path):
    """The port runs a forward of every registered method, one UnlgFormer
    training step on a synthetic dataset, the metric suite and the entry
    point (`main.cli --test-only --device cpu` on GSA) in a fresh process
    without jax, flax or the JAX package."""
    code = textwrap.dedent("""
        import contextlib, io, os, sys, tempfile
        import numpy as np, torch
        from lgteun_tpu_torch import losses, main
        from lgteun_tpu_torch.metrics import (no_ref_evaluate_batch,
                                              ref_evaluate_batch, numpy_ref,
                                              oracle)
        from lgteun_tpu_torch.models import classical
        from lgteun_tpu_torch.ops import filters, interp23, wavelet
        from lgteun_tpu_torch.config import Config, LoaderCfg, LossCfg
        from lgteun_tpu_torch.data.dataset import PSDataset
        from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
        from lgteun_tpu_torch.ops import autograd
        from lgteun_tpu_torch.registry import MODELS, build_model
        from lgteun_tpu_torch.runner import Runner
        # not all zero: the classical methods divide by the PAN's spread
        rng = np.random.default_rng(0)
        batch = {"input_lr": rng.uniform(0, 1, (1, 8, 8, 4)).astype(
                     np.float32),
                 "input_pan": rng.uniform(0, 1, (1, 32, 32, 1)).astype(
                     np.float32)}
        for name in ("UnlgFormer", "lightnet", "MDCUN", "INNT", "GSA",
                     "SFIM", "Wavelet"):
            cfg = Config(model_type=name, ms_chans=4,
                         model_cfg={"core_module": {"stage": 2}})
            m = build_model(name, cfg, device="cpu")
            m.init_params(torch.Generator().manual_seed(0))
            out = m.apply(batch)
            assert out.shape == (1, 32, 32, 4) and torch.isfinite(out).all()
        assert sorted(MODELS._entries) == ["GSA", "INNT", "MDCUN", "SFIM",
                                           "UnlgFormer", "Wavelet",
                                           "lightnet"]
        root = tempfile.mkdtemp(dir=sys.argv[1])
        data = make_synthetic_dataset(root, 2, 0, bands=4, size=32, seed=0)
        cfg = Config(ms_chans=4, max_iter=1, save_freq=0, work_dir=root,
                     model_cfg={"core_module": {"stage": 2}},
                     train_set_cfg=LoaderCfg(batch_size=2),
                     loss_cfg={"rec_loss": LossCfg("l1")})
        runner = Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"),
                        "cpu", train_ds=PSDataset([data["train"]]))
        assert runner.init().train().last_iter == 1
        with open(os.path.join(root, "gsa.py"), "w") as f:
            f.write(f"model_type = 'GSA'\\nms_chans = 4\\n"
                    f"work_dir = {root!r}\\nlog_dir = {root!r}\\n"
                    f"test_set1_cfg = dict(dataset=dict("
                    f"image_dirs=[{data['train']!r}]))\\n")
        with contextlib.redirect_stdout(io.StringIO()):  # its log lines
            gsa = main.cli(["-c", os.path.join(root, "gsa.py"),
                            "--test-only", "--device", "cpu"])
        assert set(gsa.image_scores["reduced-res (ref)"]) == {
            "image_id", "psnr", "ssim", "qindex", "sam", "ergas"}
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "lgteun_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_shipped_config_loads_as_in_the_jax_package():
    """The port's load_config reads the shipped UnlgFormer config into
    the same values as the JAX package's, for every field it keeps (the
    nested configs field by field: they are the port's own
    dataclasses)."""
    path = os.path.join(REPO, "lgteun_tpu", "configs", "unlg_former.py")
    got, want = load_config(path), jax_load_config(path)

    def plain(v):
        if dataclasses.is_dataclass(v):
            return dataclasses.asdict(v)
        return {k: plain(x) for k, x in v.items()} if isinstance(
            v, dict) else v

    for f in dataclasses.fields(PortConfig):
        if f.name != "extras":
            assert plain(getattr(got, f.name)) == plain(
                getattr(want, f.name)), f.name
    assert (got.model_type, got.ms_chans, got.eval_batch_size) == (
        "UnlgFormer", 8, 16)
    assert got.get("max_iter") == want.max_iter
    assert got.get("step") == want.get("step")


def test_kernel_loader_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc -> the loader raises; it never hands back a missing
    library for a caller to skip."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build_library(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_kernel_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu (all started before any is waited for),
    then one link into the hash-keyed library; no object is left
    behind (the compile log, ptxas's report, is kept beside the
    library), and a failing compile raises with its log. A stand-in nvcc
    records its arguments and writes its -o file."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        with open({str(tmp_path / "calls.txt")!r}, "a") as f:
            f.write(" ".join(args) + "\\n")
        if any(a.endswith("broken.cu") for a in args):
            print("error: bad source")
            sys.exit(2)
        open(args[args.index("-o") + 1], "w").close()
        """))
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    lib = _cuda.build_library(tmp_path / "build")
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    sources = sorted(p.name for p in _cuda.CSRC.glob("*.cu"))
    assert {"lightnet.cu", "neighborhood_attention.cu",
            "texture_match.cu"} <= set(sources)
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == \
        sources
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert calls[-1].startswith("-shared -o ") and len(calls) == \
        len(sources) + 1
    assert lib.is_file() and sorted(p.name for p in lib.parent.iterdir()) \
        == [lib.name, _cuda.ptxas_log(lib).name]
    assert _cuda.build_library(tmp_path / "build") == lib
    assert len((tmp_path / "calls.txt").read_text().splitlines()) == \
        len(calls)
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "fine.cu").write_text("")
    (bad / "broken.cu").write_text("")
    monkeypatch.setattr(_cuda, "CSRC", bad)
    with pytest.raises(RuntimeError, match="bad source"):
        _cuda.build_library(tmp_path / "build2")
    assert not any((tmp_path / "build2").iterdir())
