"""The last modules of the JAX package in the port, against their JAX
counterparts on the CPU:

- `data/synthetic.py::downgrade_images`, whole (both PAN branches and
  `pan_mtf`, 4 and 8 bands, sides that are not multiples of 4): MS within
  1e-12 relative, PAN within 2e-6 of max|pan| (JAX's sensor branch resizes
  with Pillow, the port with `pil_resize_bicubic`, which is also held to
  Pillow directly); its refusals;
- `ops/filters.py`: `gaussian_kernel_1d`, `pyr_down`, `box_filter`,
  `get_lp` / `get_hp`, `channel_pooling`, `calc_img_grad` within 1e-6;
- `models/common/refine.py` `Refine2` and `DenseModule`, and
  `models/common/discriminators.py` `ResBlock`, `ResChAttnBlock`,
  `SFTLayer`, `mean_shift` and `VGGFeat` against the flax modules on
  weights carried across (`convert/from_jax.py`), within 5e-4 of the
  largest output; `VGGFeat`'s keys are torchvision's, which JAX's
  `convert_vgg_feat` maps back bit for bit; "BN" is refused;
- `native/`: bit-equal to JAX's native codec and to the Python codec in
  both directions, the batch decoder, each bad file of
  tests/test_native.py refused, and the Python codec (one logged line)
  where the library does not build;
- `utils/`: .mat round trips; the PNG preview pixel-equal (read back with
  PIL) to JAX's `save_preview_png`;
- `parallel`: `make_mesh()` and `ranks.spawn()` default to the card and
  raise without one.

Inputs are made with numpy from a seed, float32 where a model runs
(conftest turns on jax_enable_x64).
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from lgteun_tpu.convert.torch_import import convert_vgg_feat
from lgteun_tpu.data import synthetic as jax_synthetic
from lgteun_tpu.data.tiff import read_tiff as jax_read_tiff
from lgteun_tpu.models.common import discriminators as jax_disc
from lgteun_tpu.models.common import refine as jax_refine
from lgteun_tpu.native import read_tiff_native as jax_read_native
from lgteun_tpu.ops import filters as jax_filters
from lgteun_tpu.utils import io as jax_io
from lgteun_tpu.utils import viz as jax_viz
from lgteun_tpu_torch import native
from lgteun_tpu_torch.convert import from_jax
from lgteun_tpu_torch.data import dataset
from lgteun_tpu_torch.data import synthetic
from lgteun_tpu_torch.data.synthetic import make_synthetic_dataset
from lgteun_tpu_torch.data.tiff import read_tiff, write_tiff
from lgteun_tpu_torch.models.common import discriminators as disc
from lgteun_tpu_torch.models.common import refine
from lgteun_tpu_torch.ops import filters
from lgteun_tpu_torch.parallel import ranks
from lgteun_tpu_torch.parallel.mesh import make_mesh
from lgteun_tpu_torch.utils import io, viz

MS_RTOL = 1e-12
PAN_TOL = 2e-6          # of max|pan|
FILTER_TOL = 1e-6
MODULE_TOL = 5e-4       # of the largest output


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- downgrade


@pytest.mark.parametrize("sensor,pan_mtf,bands,shape", [
    (None, False, 4, (70, 62)), (None, False, 8, (64, 64)),
    ("QB", False, 4, (70, 62)), ("QB", True, 4, (53, 61)),
    ("WV3", False, 8, (53, 61)), ("WV3", True, 8, (70, 62)),
    ("WV2", False, 8, (128, 128)), ("IKONOS", False, 4, (66, 71))])
def test_downgrade_images_matches_jax(sensor, pan_mtf, bands, shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1] + bands)
    ms = rng.uniform(100, 1900, shape + (bands,))
    pan = rng.uniform(100, 1900, shape + (1,))
    got = synthetic.downgrade_images(ms, pan, sensor=sensor,
                                     pan_mtf=pan_mtf)
    want = jax_synthetic.downgrade_images(ms, pan, sensor=sensor,
                                          pan_mtf=pan_mtf)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    ms_gap = float(np.abs(got[0] - want[0]).max() / np.abs(want[0]).max())
    pan_gap = float(np.abs(got[1] - want[1]).max() / np.abs(want[1]).max())
    print(f"{sensor} pan_mtf={pan_mtf} {bands} bands {shape}: MS "
          f"{ms_gap:.3e} relative, PAN {pan_gap:.3e} of max|pan|")
    assert ms_gap <= MS_RTOL and pan_gap <= PAN_TOL


def test_downgrade_images_refusals():
    ms, pan = np.ones((16, 16, 8)), np.ones((16, 16))
    for fn in (synthetic.downgrade_images, jax_synthetic.downgrade_images):
        with pytest.raises(KeyError, match="unknown sensor 'X'"):
            fn(ms, pan, sensor="X")
        with pytest.raises(ValueError, match="QB has 4 bands; MS has 8"):
            fn(ms, pan, sensor="QB")


@pytest.mark.parametrize("shape,scale", [((136, 136), 0.25), ((53, 61), 0.25),
                                         ((30, 17), 0.5), ((20, 22), 2.0),
                                         ((13, 9), 1.0)])
def test_pil_resize_bicubic_matches_pillow(shape, scale):
    img = np.random.default_rng(7).uniform(0, 2047, shape)
    got = synthetic.pil_resize_bicubic(img, scale)
    h, w = shape
    want = np.asarray(Image.fromarray(img.astype(np.float32), mode="F")
                      .resize((int(w * scale), int(h * scale)),
                              Image.BICUBIC), np.float64)
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{shape} x{scale}: {gap:.3e} of max")
    assert got.shape == want.shape and gap <= PAN_TOL


# ------------------------------------------------------------- filters


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _filter_cases():
    return {
        "pyr_down": (filters.pyr_down, jax_filters.pyr_down),
        "box_filter": (lambda x: filters.box_filter(x, 8),
                       lambda x: jax_filters.box_filter(x, 8)),
        "get_lp": (filters.get_lp, jax_filters.get_lp),
        "get_hp": (lambda x: filters.get_hp(x, 3),
                   lambda x: jax_filters.get_hp(x, 3)),
        "channel_pooling_avg": (filters.channel_pooling,
                                jax_filters.channel_pooling),
        "channel_pooling_max": (
            lambda x: filters.channel_pooling(x, "max"),
            lambda x: jax_filters.channel_pooling(x, "max")),
        "calc_img_grad": (filters.calc_img_grad, jax_filters.calc_img_grad),
    }


@pytest.mark.parametrize("name", sorted(_filter_cases()))
def test_filters_match_jax(name):
    port, jax_fn = _filter_cases()[name]
    x = np.random.default_rng(3).uniform(0, 1, (2, 3, 17, 22)).astype(
        np.float32)
    got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fn(_nhwc(x))).transpose(0, 3, 1, 2)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float(np.abs(got - want).max()) <= FILTER_TOL


def test_filter_helpers_match_jax():
    for ksize, sigma in ((11, 1.5), (5, 0.0), (7, -1.0)):
        np.testing.assert_array_equal(
            filters.gaussian_kernel_1d(ksize, sigma),
            jax_filters.gaussian_kernel_1d(ksize, sigma))
    with pytest.raises(ValueError, match="no such pooling mode"):
        filters.channel_pooling(torch.zeros(1, 2, 3, 3), "min")


# ------------------------------------------------------ flax modules


def _flax_case(name):
    """(flax module, its inputs (NHWC), the port's module, the carry of
    its params)."""
    rng = np.random.default_rng(len(name))
    x = lambda c, s=12: rng.uniform(-1, 1, (2, s, s, c)).astype(np.float32)
    if name == "Refine2":
        return (jax_refine.Refine2(out_channels=4), (x(8),),
                refine.Refine2(8, 4), lambda p: from_jax.refine_from_flax(
                    p, n_ca=2))
    if name == "DenseModule":
        return (jax_refine.DenseModule(), (x(8),), refine.DenseModule(8),
                from_jax.blocks_from_flax)
    if name.startswith("ResBlock"):
        norm = None if name.endswith("none") else "IN"
        return (jax_disc.ResBlock(16, norm_type=norm), (x(16),),
                disc.ResBlock(16, norm), from_jax.blocks_from_flax)
    if name.startswith("ResChAttnBlock"):
        norm = None if name.endswith("none") else "IN"
        return (jax_disc.ResChAttnBlock(16, norm_type=norm), (x(16),),
                disc.ResChAttnBlock(16, norm), from_jax.blocks_from_flax)
    if name == "SFTLayer":
        return (jax_disc.SFTLayer(16), (x(16), x(6)), disc.SFTLayer(16, 6),
                from_jax.blocks_from_flax)
    return (jax_disc.VGGFeat(rgb_range=2.0), (x(3, 16),),
            disc.VGGFeat(rgb_range=2.0), from_jax.vgg_feat_from_flax)


FLAX_MODULES = ("Refine2", "DenseModule", "ResBlock", "ResBlock_none",
                "ResChAttnBlock", "ResChAttnBlock_none", "SFTLayer",
                "VGGFeat")


@pytest.mark.parametrize("name", FLAX_MODULES)
def test_blocks_match_flax(name):
    flax_mod, inputs, port, carry = _flax_case(name)
    params = jax.jit(flax_mod.init)(jax.random.PRNGKey(1),
                                    *map(jnp.asarray, inputs))
    params = jax.tree.map(lambda v: np.asarray(v, np.float32),
                          params["params"])
    port.load_state_dict(carry(params), strict=True)
    want = jax.jit(flax_mod.apply)({"params": params},
                                   *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a.transpose(0, 3, 1, 2))
                     for a in inputs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        gap = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        assert gap <= MODULE_TOL, gap


def test_vgg_feat_takes_torchvision_keys():
    """VGGFeat's state_dict is torchvision's features[0:12]: JAX's
    convert_vgg_feat maps it to the flax tree bit for bit, and
    vgg_feat_from_flax back."""
    port = disc.VGGFeat()
    gen = torch.Generator().manual_seed(2)
    for m in port.modules():
        if hasattr(m, "reset_from"):
            m.reset_from(gen)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert sorted(sd) == sorted(f"{i}.{p}" for i in (0, 2, 5, 7, 10)
                                for p in ("weight", "bias"))
    back = from_jax.vgg_feat_from_flax(convert_vgg_feat(sd))
    assert all(np.array_equal(back[k].numpy(), v) for k, v in sd.items())


def test_mean_shift_and_bn_refusal():
    x = np.random.default_rng(4).uniform(0, 1, (1, 3, 5, 5)).astype(
        np.float32)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    got = disc.mean_shift(torch.from_numpy(x), 2.0, mean, std, sign=1)
    want = jax_disc.mean_shift(_nhwc(x), 2.0, mean, std, sign=1)
    assert float(np.abs(got.numpy() - np.asarray(want).transpose(
        0, 3, 1, 2)).max()) <= FILTER_TOL
    for block in (disc.ResBlock, disc.ResChAttnBlock):
        with pytest.raises(ValueError, match="norm_type='BN'"):
            block(8, "BN")


# -------------------------------------------------------- native codec


def _tiff(tmp_path, rng, shape, name="x.tif"):
    arr = rng.integers(0, 2047, size=shape).astype(np.uint16)
    path = str(tmp_path / name)
    write_tiff(path, arr)
    return arr, path


@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 4), (12, 10, 8)])
def test_native_codec_is_bit_equal_both_ways(tmp_path, shape):
    rng = np.random.default_rng(5)
    arr, path = _tiff(tmp_path, rng, shape)
    got = native.read_tiff_native(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, jax_read_native(path))
    np.testing.assert_array_equal(got, read_tiff(path))
    out = str(tmp_path / "native.tif")
    assert native.write_tiff_native(out, arr)
    np.testing.assert_array_equal(read_tiff(out), arr)
    np.testing.assert_array_equal(jax_read_tiff(out), arr)
    np.testing.assert_array_equal(jax_read_native(out), arr)


def test_native_batch_decode(tmp_path):
    rng = np.random.default_rng(6)
    items = [_tiff(tmp_path, rng, (8, 8, 4), f"t{i}.tif") for i in range(5)]
    scale = 1.0 / 2047.5
    out = native.read_batch_native([p for _, p in items], (8, 8, 4),
                                   scale=scale, threads=3)
    want = np.stack([a.astype(np.float32) * np.float32(scale)
                     for a, _ in items])
    np.testing.assert_array_equal(out, want)


def _tag_offset(blob: bytes, tag: int) -> int:
    ifd = int.from_bytes(blob[4:8], "little")
    for i in range(int.from_bytes(blob[ifd:ifd + 2], "little")):
        e = ifd + 2 + 12 * i
        if int.from_bytes(blob[e:e + 2], "little") == tag:
            return e
    raise AssertionError(f"tag {tag} not found")


@pytest.mark.parametrize("case", ["oversized_strip_count", "offset_past_eof",
                                  "truncated", "batch_shape_mismatch"])
def test_native_codec_refuses_bad_files(tmp_path, case):
    rng = np.random.default_rng(8)
    if case == "batch_shape_mismatch":
        _, small = _tiff(tmp_path, rng, (8, 8, 4), "a.tif")
        _, big = _tiff(tmp_path, rng, (32, 32, 4), "b.tif")
        assert native.read_batch_native([small, big], (8, 8, 4),
                                        threads=2) is None
        return
    shape = {"oversized_strip_count": (4, 4, 1), "offset_past_eof":
             (8, 8, 8), "truncated": (16, 16, 4)}[case]
    _, path = _tiff(tmp_path, rng, shape)
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    if case == "oversized_strip_count":
        e = _tag_offset(bytes(blob), 279)
        blob[e + 8:e + 12] = (2 ** 20).to_bytes(4, "little")
    elif case == "offset_past_eof":
        e = _tag_offset(bytes(blob), 258)
        blob[e + 8:e + 12] = (len(blob) + 4096).to_bytes(4, "little")
    else:
        blob = blob[:len(blob) // 3]
    with open(path, "wb") as f:
        f.write(bytes(blob))
    out = native.read_tiff_native(path)
    if case == "oversized_strip_count":   # refused, or the clamped image
        assert out is None or out.shape == (4, 4)
    else:
        assert out is None


def test_dataset_reads_natively_else_python(tmp_path, monkeypatch, caplog):
    made = make_synthetic_dataset(str(tmp_path), 0, 2, bands=4, size=32)
    before = dataset.CODEC_READS["native"]
    native_ds = dataset.PSDataset([made["test"]])
    assert dataset.CODEC_READS["native"] - before == 6
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)

    def fails():
        raise OSError("g++: not found")

    monkeypatch.setattr(native, "_build", fails)
    before = dataset.CODEC_READS["python"]
    with caplog.at_level(logging.WARNING, logger="lgteun_torch.native"):
        python_ds = dataset.PSDataset([made["test"]])
        dataset.PSDataset([made["test"]])
    assert dataset.CODEC_READS["python"] - before == 12
    lines = [r.getMessage() for r in caplog.records
             if r.name == "lgteun_torch.native"]
    assert len(lines) == 1 and "Python codec" in lines[0]
    for a, b in zip(native_ds, python_ds):
        for k in ("input_lr", "input_pan", "input_pan_l", "target"):
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------- utils


def test_mat_round_trips(tmp_path):
    data = np.random.default_rng(9).uniform(0, 1, (6, 5, 4))
    io.save_mat(str(tmp_path / "a.mat"), "I_MS", data)
    np.testing.assert_array_equal(io.load_mat(str(tmp_path / "a.mat"),
                                              "I_MS"), data)
    np.testing.assert_array_equal(jax_io.load_mat(str(tmp_path / "a.mat"),
                                                  "I_MS"), data)
    jax_io.save_mat(str(tmp_path / "b.mat"), "x", data)
    np.testing.assert_array_equal(io.load_mat(str(tmp_path / "b.mat"), "x"),
                                  data)


@pytest.mark.parametrize("bands,stretch", [(1, False), (3, False), (4, False),
                                           (8, True), (4, True), (1, True)])
def test_preview_png_matches_jax(tmp_path, bands, stretch):
    rng = np.random.default_rng(bands)
    if stretch:
        img = rng.integers(0, 2047, (bands, 20, 13)).astype(np.uint16)
    else:
        img = rng.uniform(0, 255, (bands, 20, 13))
    if bands == 1:
        img = img[0]
    got = viz.save_preview_png(img, str(tmp_path / "port" / "p.png"),
                               stretch=stretch)
    want = jax_viz.save_preview_png(img, str(tmp_path / "jax" / "p.png"),
                                    stretch=stretch)
    with Image.open(got) as a, Image.open(want) as b:
        assert a.mode == b.mode and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(viz.linear_stretch(img[None] if bands == 1
                                                     else img),
                                  jax_viz.linear_stretch(
                                      img[None] if bands == 1 else img))


def test_png_refuses_other_pixels():
    with pytest.raises(ValueError, match="uint8"):
        viz.encode_png(np.zeros((4, 4, 2), np.uint8))


# ---------------------------------------------------------- parallel


def test_mesh_and_spawn_default_to_the_card(tmp_path, monkeypatch):
    assert make_mesh(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.spawn([], 2, str(tmp_path / "spawn"))
    assert not os.path.exists(tmp_path / "spawn")
