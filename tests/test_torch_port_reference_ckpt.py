"""The reference's released-weights workflow in the port: a reference
checkpoint (a pickle of whole modules, reference base_model.py:354-369)
-> `lgteun_tpu_torch.convert.from_reference` -> `main --test-only
--checkpoint`, against the JAX package's converter and forward.

- For each of the seven DL methods: seeded port weights (`*_from_flax`
  of a numpy-seeded flax tree; MutInf with its `mi` module) written by
  `write_reference_checkpoint` as whole modules of the reference's
  classes (`models.unlg_former.Pansharpening`, ...), with a `cfg` object
  and a logger, the classes declared only while saving. The loader reads
  the state_dict bit for bit without them, and JAX's strict
  `convert_state_dict` (and `AUX_CONVERTERS` for `mi`) gives the seeded
  flax tree back bit for bit (mi's Dense rows in the reference's
  (c, h, w) order, ROADMAP C.34).
- Torch's legacy format, a checkpoint of state_dicts and a bare state_dict
  load too; the converter refuses a module the method does not have and,
  with a config, a key the method does not load.
- A hostile pickle (REDUCE on os.system, builtins.eval, subprocess.Popen;
  zip, legacy and a raw pickle) is refused and its callable never runs.
- `--checkpoint` given a whole-module pickle names the converter.
- End to end on the CPU (tests/test_e2e_cli.py:85-175's flow): a
  reference-layout GF-2 root (4 bands, 2 + 2 scenes), the pickle
  converted by the CLI in a subprocess, `main.cli --test-only --device
  cpu --checkpoint`: last_iter 259000, finite reduced-resolution
  metrics, 2 TIFFs a split, the prediction within 5e-4 of JAX's
  UnlgFormer forward on `convert_state_dict` of the same weights.

Inputs are made with numpy from a seed, float32 (conftest turns on
jax_enable_x64).
"""

import os
import pickle
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.convert import AUX_CONVERTERS, convert_state_dict
from lgteun_tpu.models.lgteun import LGTEUN as JaxLGTEUN
from lgteun_tpu_torch import main as port_main
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert import from_jax
from lgteun_tpu_torch.convert.from_reference import (
    REFERENCE_CLASSES, convert_reference_checkpoint,
    load_reference_checkpoint, write_reference_checkpoint)
from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner, read_checkpoint

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_innt import _fill  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = 4
ITER = 259000
DR = 2.0 ** 11 - 0.5
FORWARD_ATOL = 5e-4
FROM_FLAX = {"UnlgFormer": from_jax.lgteun_from_flax,
             "lightnet": from_jax.lightnet_from_flax,
             "PanFormer": from_jax.panformer_from_flax,
             "SFIIN": from_jax.sfiin_from_flax,
             "MutInf": from_jax.mutinf_from_flax,
             "INNT": from_jax.innt_from_flax,
             "MDCUN": from_jax.mdcun_from_flax}
MI_SIDE, MI_CHANNELS = 8, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(name: str, seed: int):
    """(the port's method of `name` holding seeded weights, {module name:
    the flax tree they were carried from})."""
    method = build_model(name, Config(model_type=name, ms_chans=BANDS),
                         device="cpu")
    method.init_params(torch.Generator().manual_seed(0))
    shapes = convert_state_dict(name, {k: v.numpy() for k, v in
                                       method.state_dict().items()})
    trees = {"core_module": _fill(shapes, seed)}
    method.load_state_dict(FROM_FLAX[name](trees["core_module"]))
    if name == "MutInf":
        rng = np.random.default_rng(seed + 1)
        width = MI_CHANNELS * MI_SIDE * MI_SIDE
        conv = lambda cin: {"kernel": rng.uniform(-0.1, 0.1, (
            4, 4, cin, MI_CHANNELS)), "bias": rng.uniform(-0.1, 0.1, 4)}
        dense = lambda: {"kernel": rng.uniform(-0.1, 0.1, (width, 4)),
                         "bias": rng.uniform(-0.1, 0.1, 4)}
        tree = {"layer1": conv(4), "layer2": conv(4),
                "layer3": conv(MI_CHANNELS), "layer4": conv(MI_CHANNELS),
                **{k: dense() for k in ("fc1_rgb3", "fc2_rgb3",
                                        "fc1_depth3", "fc2_depth3")}}
        trees["mi"] = jax.tree.map(lambda v: np.asarray(v, np.float32), tree)
        method.load_module_state_dict("mi", from_jax.mi_from_flax(
            trees["mi"]))
    return method, trees


def _assert_same_tree(got: dict, want: dict) -> None:
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


def _reference_rows(tree: dict) -> dict:
    """A flax MutualInfoReg tree with each Dense kernel's rows in the
    reference's (c, h, w) flatten order (`mi_from_flax`)."""
    out = dict(tree)
    for k in ("fc1_rgb3", "fc2_rgb3", "fc1_depth3", "fc2_depth3"):
        kern = tree[k]["kernel"]
        out[k] = {"kernel": kern.reshape(MI_SIDE, MI_SIDE, MI_CHANNELS, -1)
                  .transpose(2, 0, 1, 3).reshape(kern.shape),
                  "bias": tree[k]["bias"]}
    return out


@pytest.mark.parametrize("name", sorted(REFERENCE_CLASSES))
def test_whole_module_pickle_loads_without_the_reference(name, tmp_path):
    method, trees = _seeded(name, seed=11)
    modules = {k: v for k, v in method.modules().items() if k in trees}
    path = str(tmp_path / "model.pth")
    write_reference_checkpoint(path, modules, ITER, name,
                               cfg={"model_type": name, "ms_chans": BANDS})
    top = REFERENCE_CLASSES[name].split(".")[0]
    assert top not in sys.modules and "mmcv" not in sys.modules
    with open(path, "rb") as f:
        head = f.read()
    assert REFERENCE_CLASSES[name].rpartition(".")[2].encode() in head

    sds, iter_num = load_reference_checkpoint(path)
    assert iter_num == ITER and set(sds) == set(trees)
    assert top not in sys.modules
    for module_name, sd in sds.items():
        want = modules[module_name].state_dict()
        assert list(sd) == list(want)
        for k, v in want.items():
            assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    numpy = {k: {n: t.numpy() for n, t in sd.items()}
             for k, sd in sds.items()}
    _assert_same_tree(convert_state_dict(name, numpy["core_module"]),
                      trees["core_module"])
    if name == "MutInf":
        _assert_same_tree(AUX_CONVERTERS[(name, "mi")](numpy["mi"]),
                          _reference_rows(trees["mi"]))


def test_legacy_format_and_state_dict_checkpoints(tmp_path):
    method, _ = _seeded("lightnet", seed=12)
    want = method.state_dict()
    legacy = str(tmp_path / "legacy.pth")
    write_reference_checkpoint(legacy, {"core_module": method.module}, 7,
                               "lightnet", legacy=True)
    sds, it = load_reference_checkpoint(legacy)
    assert it == 7 and all(torch.equal(sds["core_module"][k], v)
                           for k, v in want.items())
    torch.save({"core_module": want, "iter_num": np.int64(9)},
               tmp_path / "sds.pth")
    sds, it = load_reference_checkpoint(str(tmp_path / "sds.pth"))
    assert it == 9 and list(sds["core_module"]) == list(want)
    torch.save(want, tmp_path / "bare.pth")
    sds, it = load_reference_checkpoint(str(tmp_path / "bare.pth"))
    assert it == 0 and list(sds) == ["core_module"]


def test_converter_refuses_what_the_method_lacks(tmp_path):
    method, _ = _seeded("lightnet", seed=13)
    sd = method.state_dict()
    torch.save({"core_module": sd, "extra": sd}, tmp_path / "two.pth")
    with pytest.raises(ValueError, match="extra"):
        convert_reference_checkpoint(str(tmp_path / "two.pth"), "lightnet",
                                     str(tmp_path / "out.pt"))
    bad = dict(sd)
    bad["stray.weight"] = torch.zeros(1)
    torch.save({"core_module": bad}, tmp_path / "stray.pth")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f'model_type = "lightnet"\nms_chans = {BANDS}\n')
    convert_reference_checkpoint(str(tmp_path / "stray.pth"), "lightnet",
                                 str(tmp_path / "out.pt"))
    with pytest.raises(RuntimeError, match="stray.weight"):
        convert_reference_checkpoint(str(tmp_path / "stray.pth"),
                                     "lightnet", str(tmp_path / "out.pt"),
                                     config=str(cfg))


class _System:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


class _Eval:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return eval, (f"open({self.marker!r}, 'w')",)


class _Popen:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return subprocess.Popen, (["touch", self.marker],)


@pytest.mark.parametrize("form", ["zip", "legacy", "raw"])
@pytest.mark.parametrize("evil", [_System, _Eval, _Popen])
def test_hostile_pickle_is_refused_before_the_call(evil, form, tmp_path):
    marker = str(tmp_path / "ran")
    path = str(tmp_path / "evil.pth")
    payload = {"core_module": evil(marker), "iter_num": 1}
    if form == "raw":
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=2)
    else:
        torch.save(payload, path,
                   _use_new_zipfile_serialization=form == "zip")
    with pytest.raises(pickle.UnpicklingError, match="refusing to call"):
        load_reference_checkpoint(path)
    assert not os.path.exists(marker)


def test_checkpoint_flag_names_the_converter(tmp_path):
    method, _ = _seeded("lightnet", seed=14)
    path = str(tmp_path / "model.pth")
    write_reference_checkpoint(path, {"core_module": method.module}, 1,
                               "lightnet")
    with pytest.raises(ValueError, match="lgteun_tpu_torch.convert."
                       "from_reference") as err:
        read_checkpoint(path, "cpu")
    assert "models.lightnet.LightNet" in str(err.value)


def _config(path, root, out):
    path.write_text(f'''
name = "UnlgFormer_reference"
model_type = "UnlgFormer"
datas = "GF-2"
ms_chans = {BANDS}
only_test = True
max_iter = 0
work_dir = {str(out / "work")!r}
log_dir = {str(out / "logs")!r}
eval_batch_size = 2
test_set0_cfg = dict(dataset=dict(type="PSDataset",
    image_dirs=[{str(root / "GF-2" / "test_full_res")!r}], bit_depth=11),
    batch_size=1, shuffle=False)
test_set1_cfg = dict(dataset=dict(type="PSDataset",
    image_dirs=[{str(root / "GF-2" / "test_reduce_res")!r}], bit_depth=11),
    batch_size=1, shuffle=False)
model_cfg = {{"core_module": dict(stage=1)}}
''')
    return str(path)


def test_reference_checkpoint_end_to_end(tmp_path):
    # 1. the reference-layout data root (GF-2: 4 bands; the full-resolution
    # split ships no ground truth)
    root = tmp_path / "Dataset"
    made = make_synthetic_dataset(str(tmp_path / "synth"), n_train=2,
                                  n_test=2, bands=BANDS, size=128, seed=15)
    gf2 = root / "GF-2"
    shutil.copytree(made["train"], gf2 / "train_reduce_res")
    shutil.copytree(made["test"], gf2 / "test_reduce_res")
    shutil.copytree(made["test"], gf2 / "test_full_res")
    for f in (gf2 / "test_full_res").glob("*_mul.tif"):
        f.unlink()
    cfg_path = _config(tmp_path / "cfg.py", root, tmp_path)

    # 2. the reference-format checkpoint of seeded weights
    tree = flax_params(BANDS, stage=1, seed=16)
    port = build_model("UnlgFormer", Config(
        ms_chans=BANDS, model_cfg={"core_module": {"stage": 1}}),
        device="cpu")
    port.load_state_dict(from_jax.lgteun_from_flax(tree))
    pth = str(tmp_path / f"model_iter_{ITER}.pth")
    write_reference_checkpoint(pth, {"core_module": port.module}, ITER,
                               "UnlgFormer")

    # 3. converted by the CLI in a fresh interpreter, strictly loaded
    converted = str(tmp_path / "converted.pt")
    res = subprocess.run(
        [sys.executable, "-m", "lgteun_tpu_torch.convert.from_reference",
         "--model-type", "UnlgFormer", "--torch-ckpt", pth, "--out",
         converted, "-c", cfg_path],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert f"iter {ITER}" in res.stdout

    # 4. main --test-only on the converted checkpoint
    saved = {}
    keep = Runner._save_outputs

    def record(self, outputs, iter_id, ref):
        saved[ref] = outputs
        return keep(self, outputs, iter_id, ref)

    with mock.patch.object(Runner, "_save_outputs", record):
        runner = port_main.cli(["-c", cfg_path, "--test-only", "--device",
                                "cpu", "--checkpoint", converted])
    # the iteration restored; the optimiser (main sets one for a
    # trainable method) fresh, with no state from the checkpoint
    assert runner.last_iter == ITER and not runner.optimizer.state
    scores = runner.image_scores["reduced-res (ref)"]
    for k in ("psnr", "ssim", "qindex", "sam", "ergas"):
        assert np.isfinite(scores[k]).all(), k
    for split in ("reduced", "full"):
        out = tmp_path / "work" / "GF-2" / "test_out" / "iter_0" / split
        assert len(list(out.glob("*_mul_hat.tif"))) == 2

    # 5. the served prediction against JAX's forward of the same weights
    params = convert_state_dict("UnlgFormer", {
        k: v.numpy() for k, v in read_checkpoint(converted, "cpu")[0].items()})
    ds = runner.test_ds_reduced
    ms = np.stack([ds[i]["input_lr"] for i in range(2)]) / np.float32(DR)
    pan = np.stack([ds[i]["input_pan"] for i in range(2)]) / np.float32(DR)
    want = np.asarray(jax.jit(JaxLGTEUN(ms_chans=BANDS, stage=1).apply)(
        {"params": jax.tree.map(jnp.asarray, params)},
        jnp.asarray(ms, jnp.float32), jnp.asarray(pan, jnp.float32)))
    got = np.concatenate([p for _, p in saved[True]])
    gap = float(np.abs(got - want).max())
    print(f"port vs JAX forward on the converted weights: max|diff| {gap:.3e}")
    assert got.shape == want.shape and gap <= FORWARD_ATOL
