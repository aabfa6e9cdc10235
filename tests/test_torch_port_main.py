"""The port's entry point (`python -m lgteun_tpu_torch.main`) and the
Runner's evaluation lifecycle on the CPU, against the JAX package's
`main` on the same synthetic splits and weights (4 bands: 4
reduced-resolution scenes with targets at 64^2 PAN, 4 full-resolution
ones without at 128^2, at eval batch 3, so that the last batch is
padded; UnlgFormer on the first two of each at batch 2).

- `--test-only --device cpu` writes the log, both splits' metrics in the
  JAX Runner's words, the uint16 GeoTIFFs (the rounded prediction) and
  `eval_curves.json`; its per-image metrics equal those of JAX `main`
  (UnlgFormer K=1 on numpy-made flax weights carried over by
  `convert/from_jax.py`; GSA) within the metric bounds of
  `tests/test_metrics.py`;
- without `--device` it asks for CUDA and raises where there is none;
- `runner.test(dataset)` scores as `test(ref=True)` on the configured
  split; `train` scores the reduced split at `eval_freq` and the full one
  at `test_freq`.
"""

import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from lgteun_tpu import registry as jax_registry
from lgteun_tpu import runner as jax_runner_mod
from lgteun_tpu.config import load_config as jax_load_config
from lgteun_tpu.main import main as jax_main
from lgteun_tpu.metrics import jax_metrics as JM
from lgteun_tpu_torch import main as port_main
from lgteun_tpu_torch.config import Config, LoaderCfg, LossCfg
from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax
from lgteun_tpu_torch.data.dataset import PSDataset
from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
from lgteun_tpu_torch.data.tiff import read_tiff
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402

BANDS, N_IMAGES, BATCH = 4, 4, 3
DR = 2.0 ** 11 - 0.5
REF_RTOL = {"psnr": 1e-4, "ssim": 1e-4, "ergas": 1e-4, "qindex": 1e-3,
            "sam": 1e-3}
NO_REF_ATOL = {"d_lambda": 2e-4, "d_s": 2e-4, "qnr": 4e-4}
TAGS = {True: "reduced-res (ref)", False: "full-res (no-ref)"}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """{root}/GF-2/test_reduce_res (64^2 scenes with targets) and
    {root}/GF-2/test_full_res (the LrMS and PAN of other scenes at 128^2,
    the least at which D_lambda's and D_s's 32x32 windows fit the LrMS);
    the first two of each under {root}/pair/GF-2 (UnlgFormer's: a JAX
    forward of it takes seconds here)."""
    root = tmp_path_factory.mktemp("main_data")
    made = make_synthetic_dataset(str(root / "made"), N_IMAGES, 0,
                                  bands=BANDS, size=128, seed=12,
                                  sensor="QB")
    reduced = make_synthetic_dataset(str(root / "made64"), 0, N_IMAGES,
                                     bands=BANDS, size=64, seed=13,
                                     sensor="QB")
    shutil.copytree(reduced["test"], root / "GF-2" / "test_reduce_res")
    full = root / "GF-2" / "test_full_res"
    full.mkdir()
    for name in os.listdir(made["train"]):
        if not name.endswith("_mul.tif"):
            shutil.copy(os.path.join(made["train"], name), full)
    for split in ("test_reduce_res", "test_full_res"):
        pair = root / "pair" / "GF-2" / split
        pair.mkdir(parents=True)
        for name in os.listdir(root / "GF-2" / split):
            if name.split("_")[0][-3:] in ("000", "001"):
                shutil.copy(root / "GF-2" / split / name, pair)
    return root


def _config(path, root, model_type, out, batch=BATCH):
    path.write_text(f'''
name = "{model_type}_main"
model_type = "{model_type}"
datas = "GF-2"
ms_chans = {BANDS}
only_test = False
max_iter = 0
work_dir = {str(out / "work")!r}
log_dir = {str(out / "logs")!r}
eval_batch_size = {batch}
test_set0_cfg = dict(dataset=dict(type="PSDataset",
    image_dirs=[{str(root / "GF-2" / "test_full_res")!r}], bit_depth=11),
    batch_size=1, shuffle=False)
test_set1_cfg = dict(dataset=dict(type="PSDataset",
    image_dirs=[{str(root / "GF-2" / "test_reduce_res")!r}], bit_depth=11),
    batch_size=1, shuffle=False)
model_cfg = {{"core_module": dict(stage=1)}}
''')
    return str(path)


def _jax_main_scores(cfg_path, tree, out, monkeypatch):
    """JAX `main` on the config (its work_dir under `out`), then its
    full-resolution test: the per-image metrics its Runner computes (read
    by a debug callback on its batched metrics, each batch sliced to its
    real images), {tag: {metric: [per image]}}."""
    cfg = jax_load_config(cfg_path)
    cfg.work_dir = str(out / "jax_work")
    cfg.only_test = True
    if tree is not None:
        cls = jax_registry.MODELS.get(cfg.model_type)
        monkeypatch.setattr(cls, "init_params",
                            lambda self, rng, sample_hw=None: {
                                "core_module": tree})
    batches = {True: [], False: []}

    def tap(fn, ref):
        def scored(*args, **kw):
            out = fn(*args, **kw)
            jax.debug.callback(lambda o: batches[ref].append(
                {k: np.asarray(v) for k, v in o.items()}), out)
            return out
        return scored

    monkeypatch.setattr(jax_runner_mod, "ref_evaluate_batch",
                        tap(JM.ref_evaluate_batch, True))
    monkeypatch.setattr(jax_runner_mod, "no_ref_evaluate_batch",
                        tap(JM.no_ref_evaluate_batch, False))
    monkeypatch.setenv("LGTEUN_MATMUL_PRECISION", "highest")
    precision = jax.config.jax_default_matmul_precision
    try:
        runner = jax_main(cfg, logging.getLogger("jax_main"))
        runner.test(iter_id=0, ref=False)
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
    scores = {}
    for ref, ds in ((True, runner.test_ds_reduced),
                    (False, runner.test_ds_full)):
        n, bs = len(ds), cfg.eval_batch_size
        assert len(batches[ref]) == -(-n // bs)
        scores[TAGS[ref]] = {"image_id": [p[0] for p in ds.pairs], **{
            k: np.concatenate([b[k][:min(bs, n - i * bs)] for i, b in
                               enumerate(batches[ref])]).tolist()
            for k in batches[ref][0]}}
    return scores


def check_main_against_jax(model_type, data_root, tmp_path, monkeypatch):
    """Run the port's main --test-only --device cpu on `model_type`
    (UnlgFormer with converted flax weights) and check its log, curves,
    TIFFs and per-image metrics against JAX `main`."""
    if model_type == "UnlgFormer":
        data_root, n_images, batch = data_root / "pair", 2, 2
    else:
        n_images, batch = N_IMAGES, BATCH
    cfg_path = _config(tmp_path / "cfg.py", data_root, model_type, tmp_path,
                       batch=batch)
    args = ["-c", cfg_path, "--test-only", "--device", "cpu"]
    tree = None
    if model_type == "UnlgFormer":
        tree = flax_params(BANDS, stage=1, seed=3)
        ckpt = tmp_path / "weights.pt"
        torch.save(lgteun_from_flax(tree), ckpt)
        args += ["--checkpoint", str(ckpt)]
    runner = port_main.cli(args)

    log = (tmp_path / "logs" / f"{model_type}_main.log").read_text()
    for text in ("[iter 0] reduced-res (ref) psnr:",
                 "[iter 0] reduced-res (ref) ergas:",
                 "[iter 0] full-res (no-ref) d_lambda:",
                 "[iter 0] full-res (no-ref) qnr:",
                 "full-res (no-ref) avg time per img:"):
        assert text in log, text
    curves = json.loads((tmp_path / "work" / "GF-2" /
                         "eval_curves.json").read_text())
    assert sorted(curves) == sorted(
        [f"{TAGS[True]}/{k}" for k in REF_RTOL]
        + [f"{TAGS[False]}/{k}" for k in NO_REF_ATOL])
    assert all(len(v) == 1 and v[0][0] == 0 for v in curves.values())

    # the TIFFs: the prediction in DN, rounded and clipped to uint16
    for ref, split in ((True, "reduced"), (False, "full")):
        ds = runner.test_ds_reduced if ref else runner.test_ds_full
        out_dir = tmp_path / "work" / "GF-2" / "test_out" / "iter_0" / split
        assert sorted(os.listdir(out_dir)) == sorted(
            f"{i}_mul_hat.tif" for i, _ in ds.pairs)
        item = ds[0]
        pred = runner.method.apply({
            "input_lr": item["input_lr"][None] / DR,
            "input_pan": item["input_pan"][None] / DR})[0].numpy()
        tif = read_tiff(str(out_dir / f"{ds.pairs[0][0]}_mul_hat.tif"))
        side = 64 if ref else 128
        assert tif.dtype == np.uint16 and tif.shape == (side, side, BANDS)
        want = np.clip(np.round(pred.astype(np.float64) * DR), 0, 65535)
        err = np.abs(tif.astype(np.float64) - want).max()
        assert err <= 1.0, err

    want = _jax_main_scores(cfg_path, tree, tmp_path, monkeypatch)
    for ref in (True, False):
        got = runner.image_scores[TAGS[ref]]
        assert got["image_id"] == want[TAGS[ref]]["image_id"]
        assert len(got["image_id"]) == n_images
        for k, bound in (REF_RTOL if ref else NO_REF_ATOL).items():
            a, b = np.asarray(got[k]), np.asarray(want[TAGS[ref]][k])
            assert np.isfinite(a).all(), k
            if ref:
                np.testing.assert_allclose(a, b, rtol=bound, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=bound,
                                           err_msg=k)
            assert curves[f"{TAGS[ref]}/{k}"][0][1] == pytest.approx(
                float(np.mean(a)))




def test_main_test_only_matches_jax_main(data_root, tmp_path, monkeypatch):
    """UnlgFormer; GSA through main: tests/test_torch_port_classical.py."""
    check_main_against_jax("UnlgFormer", data_root, tmp_path, monkeypatch)


def test_main_without_device_asks_for_cuda(data_root, tmp_path,
                                           monkeypatch):
    """The card is the default: with none, main raises (and logs the
    traceback) before it reads a split; it never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = _config(tmp_path / "cfg.py", data_root, "GSA", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.cli(["-c", cfg_path, "--test-only"])
    log = (tmp_path / "logs" / "GSA_main.log").read_text()
    assert "Traceback" in log and "RuntimeError" in log
    assert not (tmp_path / "work").exists()


def test_cli_hands_the_package_logger_back(data_root, tmp_path, caplog):
    """After `cli` the "lgteun_torch" logger has no handlers (no later
    Runner writes into this run's log file) and propagates again, so the
    fuse CLI's warning on its child logger still reaches the root."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_port_scene import _cli, _write_scene

    package = logging.getLogger("lgteun_torch")
    before = (package.level, package.propagate, package.handlers[:])
    cfg_path = _config(tmp_path / "cfg.py", data_root, "GSA", tmp_path)
    port_main.cli(["-c", cfg_path, "--test-only", "--device", "cpu"])
    assert (package.level, package.propagate, package.handlers) == before
    assert "full-res (no-ref) qnr:" in (
        tmp_path / "logs" / "GSA_main.log").read_text()
    _write_scene(tmp_path, np.random.default_rng(35), 32, 32, BANDS)
    with caplog.at_level(logging.WARNING):
        _cli(tmp_path, "--geo", "none")
    assert any("without --checkpoint" in r.message for r in caplog.records)


def test_runner_test_of_a_split_without_targets_takes_its_tag(data_root):
    """`test(ds)` (ref=True) on a split without targets scores the
    no-reference suite and files it under the full-resolution tag."""
    full = PSDataset([str(data_root / "GF-2" / "test_full_res")])
    cfg = Config(model_type="GSA", ms_chans=BANDS, eval_batch_size=BATCH)
    runner = Runner(cfg, build_model("GSA", cfg, device="cpu"), "cpu")
    assert sorted(runner.init().test(full)) == sorted(NO_REF_ATOL)
    assert list(runner.image_scores) == [TAGS[False]]
    assert sorted(runner.eval_results) == sorted(
        f"{TAGS[False]}/{k}" for k in NO_REF_ATOL)


def _unlgformer_runner(**kw):
    cfg = Config(ms_chans=BANDS, eval_batch_size=BATCH,
                 model_cfg={"core_module": {"stage": 1}}, **kw)
    method = build_model("UnlgFormer", cfg, device="cpu")
    return cfg, method


def test_runner_test_dataset_form_equals_the_split_form(data_root):
    """`runner.test(ds)` (the form `chip_smoke.py` and the earlier tests
    use) scores as `test(ref=True)` on the runner's reduced split, and
    `test(ds, ref=False)` as `test(ref=False)` on its full split."""
    reduced = PSDataset([str(data_root / "GF-2" / "test_reduce_res")])
    full = PSDataset([str(data_root / "GF-2" / "test_full_res")])
    cfg, method = _unlgformer_runner()
    split = Runner(cfg, method, "cpu", test_ds_reduced=reduced,
                   test_ds_full=full).init(5)
    given = Runner(cfg, method, "cpu").init(5)
    assert given.test() == {}
    for ref, ds in ((True, reduced), (False, full)):
        a = split.test(ref=ref)
        b = given.test(ds, ref=ref)
        assert a == b and sorted(a) == sorted(
            REF_RTOL if ref else NO_REF_ATOL)
        assert split.image_scores == {**given.image_scores}
        assert len(split.image_scores[TAGS[ref]]["psnr" if ref else "qnr"]
                   ) == N_IMAGES


def test_train_scores_both_splits_at_their_frequencies(data_root, tmp_path):
    reduced = PSDataset([str(data_root / "GF-2" / "test_reduce_res")])
    full = PSDataset([str(data_root / "GF-2" / "test_full_res")])
    cfg, method = _unlgformer_runner(
        max_iter=2, eval_freq=1, test_freq=2, save_freq=0, log_freq=1,
        work_dir=str(tmp_path), train_set_cfg=LoaderCfg(batch_size=1),
        loss_cfg={"rec_loss": LossCfg("l1")})
    runner = Runner(cfg, method, "cpu", train_ds=reduced,
                    test_ds_reduced=reduced, test_ds_full=full).init(5)
    runner.set_optim().train()
    curves = runner.eval_results
    assert [it for it, _, _ in curves[f"{TAGS[True]}/psnr"]] == [1, 2]
    assert [it for it, _, _ in curves[f"{TAGS[False]}/qnr"]] == [2]
    path = runner.log_eval_curves()
    assert json.load(open(path)) == json.loads(json.dumps(curves))
