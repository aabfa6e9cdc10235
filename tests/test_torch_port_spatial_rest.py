"""Height-sharded eval forwards of the rest of the port's zoo on the CPU
(`lgteun_tpu_torch/parallel/spatial.py`): GSA, MutInf, SFIIN and
PanFormer in float32, MDCUN, INNT (both routes), PanFormer, SFIIN and
MutInf under the blanket bf16 cast (LGTEUN_EVAL_DTYPE=bf16), and
LightNet's bf16 tap path.

One spawn of four gloo ranks (`ranks.spawn`, a file:// rendezvous under
tmp_path) runs one `ranks.spatial_job` on {"space": 4}, batch 1, 4
bands, at sizes where every halo fits a strip: ms 16² / pan 64² (16 PAN
rows a rank: PanFormer's two x1/2 merges and 4-row windows), MutInf at
ms 24 x 8 / pan 96 x 32 (24 PAN rows a rank: its 1/4 scale holds the
dense block's one halo a scale). Narrow widths: PanFormer n_feats 16,
2 heads of 8, one cross block; MDCUN T 2, mid 16; the others as
shipped. Weights: flax trees filled from numpy, converted with
`convert/from_jax.py`.

Bounds, float32: the gathered output against JAX's
`run_spatially_sharded` of the same flax module (on four of conftest's
virtual devices) at the port's parity bounds (5e-4 for PanFormer, also
before its clamp, SFIIN and MutInf; 1e-5 for GSA,
tests/test_spatial.py's classical atol), and against the port's
unsharded forward within 1e-5 of max|out| (one intra-op thread here as
in each rank; oneDNN's convs and MKL's products sum in another order
at another height, so not bit for bit). The cast forms and the tap
path against the port's whole cast forward: bit-equal (MDCUN, LightNet's
taps), or mean|sharded - whole| within 1.5x the whole cast forward's
own spread at a one-bf16-step input change (`bf16_step`, PERF.md §2's
"rest of the zoo under bf16" row) and the drift from float32 inside
that row's envelope (mean 5e-3, max 5e-2 of max|out|); no JAX
comparison for bf16 (JAX's CPU bf16 is chaotic at its own drift, ROADMAP
C.37; tests/test_torch_port_zoo_bf16.py holds the whole cast forward to
JAX). MutInf under "bf16" gives its float32 sharded bits (it never
casts). The collectives a forward are pinned for each case.

Without spawning, with the ranks as threads (`_Ranks`): PanFormer's
shifted windows on strips (the wrap halo, the upper/lower mask only on
the image's last band) and its PixelShuffle tail's halo, MutInf's 1/4
grid strips (one halo a scale, or one a stage on 8 PAN rows a rank),
SFIIN's gathered frequency branch and two-pass contrast, GSA's gathered
regression (the same alpha bits on every rank), and `space_mean` and
the instance norms under the cast (float32 partial sums, one rounding).
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from lgteun_tpu.models.classical import gsa_fuse as jax_gsa
from lgteun_tpu.models.mutinf import GPPNNMutInf as JaxMutInf
from lgteun_tpu.models.panformer import CrossSwinTransformer as JaxCST
from lgteun_tpu.models.sfiin import SFIINNet as JaxSFIIN
from lgteun_tpu.parallel.spatial import (
    run_spatially_sharded as jax_run_spatially_sharded)
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import (innt_from_flax,
                                               lightnet_from_flax,
                                               mdcun_from_flax,
                                               mutinf_from_flax,
                                               panformer_from_flax,
                                               sfiin_from_flax)
from lgteun_tpu_torch.models.classical import gsa_fuse
from lgteun_tpu_torch.models.common.layers import init_parameters
from lgteun_tpu_torch.models.common.swin import WindowAttention, _window_mask
from lgteun_tpu_torch.models.mutinf import _DenseBlockMscale, _HINConvBlock
from lgteun_tpu_torch.models.sfiin import SpaFre
from lgteun_tpu_torch.parallel import ranks, spatial
from lgteun_tpu_torch.parallel.mesh import Mesh
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_innt import _fill, _innt_shapes  # noqa: E402
from test_torch_port_lightnet import (  # noqa: E402
    flax_params as lightnet_flax_params)
from test_torch_port_mdcun import MID, T  # noqa: E402
from test_torch_port_mdcun import flax_params as mdcun_flax_params  # noqa
from test_torch_port_mutinf import _shapes as mutinf_shapes  # noqa: E402
from test_torch_port_panformer import SMALL  # noqa: E402
from test_torch_port_panformer import _case as panformer_case  # noqa: E402
from test_torch_port_panformer import _fill as panformer_fill  # noqa: E402
from test_torch_port_panformer import _shapes as panformer_shapes  # noqa
from test_torch_port_sfiin import _shapes as sfiin_shapes  # noqa: E402
from test_torch_port_spatial_zoo import (  # noqa: E402
    _rand, _Ranks, _rows, bf16_step)

BANDS = 4
JAX_ATOL = {"GSA": 1e-5, "MutInf": 5e-4, "SFIIN": 5e-4, "PanFormer": 5e-4}
PORT_REL = 1e-5
BF16_SPREAD, DRIFT_MEAN, DRIFT_MAX = 1.5, 5e-3, 5e-2
BF16 = {"LGTEUN_EVAL_DTYPE": "bf16"}
FLOAT32 = ["GSA", "MutInf", "SFIIN", "PanFormer"]
CAST = ["MDCUN bf16", "INNT bf16", "INNT bf16 FUSED_TM=0", "PanFormer bf16",
        "SFIIN bf16", "LightNet taps"]
CASES = FLOAT32 + CAST + ["MutInf bf16"]
MODEL_CFG = {"PanFormer": {"core_module": SMALL},
             "MDCUN": {"core_module": {"mid_channels": MID, "T": T}}}
# the collectives of one forward on every rank: MutInf a gather of the
# LrMS, a halo of the PAN, 6 halos and 10 sums an InvBlock (F, then H and
# G: one halo a scale, two passes of instance-norm sums for each HIN
# block, the pooled sum), Refine's halo and two CALayer means; SFIIN a
# gather of the LrMS, then a gather of msf and panf, a halo and 2 sums a
# block, conv_p1's and Refine's halos and 1 mean; PanFormer 2 halos a
# shifted block (6) and the tail's; GSA the LrMS and the x1/4 PAN
# gathered, its halo, 7 sums; the others as their float32 forwards
COLLECTIVES = {
    "GSA": {"gather": 2, "halo": 1, "sum": 7},
    "MutInf": {"gather": 1, "halo": 26, "sum": 42},
    "SFIIN": {"gather": 6, "halo": 7, "sum": 11},
    "PanFormer": {"halo": 13},
    "MDCUN": {"halo": 2 + 3 * T},
    "INNT": {"gather": 3, "halo": 5, "sum": 25},
    "LightNet": {"halo": 3}}
# the kernels one forward launches on a card (none on the CPU): MDCUN's
# four B12, INNT's one B10 / B11; every other case none
ROUTE = {"MDCUN bf16": {"neighborhood_attention": 4},
         "INNT bf16": {"texture_match": 1},
         "INNT bf16 FUSED_TM=0": {"patch_match": 1}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process, as each spawned rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _method(name):
    return {"LightNet": "lightnet"}.get(name.split()[0], name.split()[0])


def _env(name):
    if name == "LightNet taps":
        return {"LGTEUN_LIGHTNET_DTYPE": "bf16"}
    env = dict(BF16) if "bf16" in name else {}
    if name.startswith("INNT"):
        env["LGTEUN_FUSED_TM"] = "0" if "FUSED_TM=0" in name else "1"
    return env


def _batch(name, seed):
    rng = np.random.default_rng(seed)
    h, w = (24, 8) if name.startswith("MutInf") else (16, 16)
    return {"input_lr": rng.uniform(0.1, 0.9, (1, h, w, BANDS)).astype(
        np.float32), "input_pan": rng.uniform(0.1, 0.9, (1, 4 * h, 4 * w, 1)
                                             ).astype(np.float32)}


@pytest.fixture(scope="module")
def trees():
    return {"MutInf": _fill(mutinf_shapes(BANDS), seed=22),
            "SFIIN": _fill(sfiin_shapes(BANDS), seed=22),
            "PanFormer": panformer_fill(panformer_shapes(
                BANDS, tuple(SMALL.items()), (16, 16)), seed=22),
            "MDCUN": mdcun_flax_params(BANDS, seed=22),
            "INNT": _fill(_innt_shapes(BANDS), seed=22),
            "lightnet": lightnet_flax_params(BANDS, seed=22)}


_CONVERT = {"MutInf": mutinf_from_flax, "SFIIN": sfiin_from_flax,
            "PanFormer": panformer_from_flax, "MDCUN": mdcun_from_flax,
            "INNT": innt_from_flax, "lightnet": lightnet_from_flax}


def _case(name, trees):
    method = _method(name)
    convert = _CONVERT.get(method)
    return dict(name=name, method=method, env=_env(name),
                cfg=Config(model_type=method, ms_chans=BANDS,
                           model_cfg=MODEL_CFG.get(method, {})),
                weights=None if convert is None else {
                    k: v.numpy() for k, v in convert(trees[method]).items()},
                batch=_batch(name, seed=23))


@pytest.fixture(scope="module")
def spawned(trees, tmp_path_factory):
    """The four-rank spawn: [rank] results, and the cases by name."""
    cases = {name: _case(name, trees) for name in CASES}
    out = ranks.spawn([(ranks.spatial_job, dict(
        mesh_shape={"space": 4}, cases=list(cases.values())))], 4,
        str(tmp_path_factory.mktemp("spatial_rest")), device="cpu")
    return [r[0] for r in out], cases


def _port(case, monkeypatch, env=None):
    """The port's method of `case`, built under `env` (the case's own by
    default), with the case's weights."""
    for k, v in (case["env"] if env is None else env).items():
        monkeypatch.setenv(k, v)
    port = build_model(case["method"], case["cfg"], device="cpu")
    if case["weights"] is not None:
        port.load_state_dict({k: torch.from_numpy(v)
                              for k, v in case["weights"].items()})
    for k in case["env"]:
        monkeypatch.delenv(k, raising=False)
    return port.eval()


def test_spawned_ranks_import_no_jax(spawned):
    out, _ = spawned
    assert all(not r["jax_imported"] for r in out)


def _jax_sharded(name, trees, batch):
    """JAX's `run_spatially_sharded` of the flax function on {"space":
    4}."""
    if name == "GSA":
        fn = lambda b: jax_gsa(b["input_lr"], b["input_pan"])
    else:
        module = {"MutInf": JaxMutInf(ms_chans=BANDS),
                  "SFIIN": JaxSFIIN(ms_chans=BANDS),
                  "PanFormer": JaxCST(ms_chans=BANDS, **SMALL)}[name]
        params = {"params": jax.tree.map(jnp.asarray, trees[name])}
        first = (lambda o: o[0]) if name == "MutInf" else (lambda o: o)
        fn = lambda b: first(module.apply(params, b["input_lr"],
                                          b["input_pan"]))
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("space",))
    return np.asarray(jax_run_spatially_sharded(
        fn, {k: jnp.asarray(v) for k, v in batch.items()}, mesh))


@pytest.mark.parametrize("name", FLOAT32)
def test_sharded_matches_jax(spawned, trees, name):
    """The gathered output against JAX's `run_spatially_sharded` of the
    same weights on a mesh of the same shape, at the method's port-vs-JAX
    bound."""
    out, cases = spawned
    got = out[0][name]["whole"]
    want = _jax_sharded(name, trees, cases[name]["batch"])
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL[name])


@pytest.mark.parametrize("name", FLOAT32)
def test_sharded_matches_unsharded_port(spawned, name, monkeypatch):
    """The gathered output against the port's unsharded forward of the
    same weights within 1e-5 of max|out|; `gather_h` on rank 0 is every
    rank's rows in order."""
    out, cases = spawned
    case = cases[name]
    want = _port(case, monkeypatch).apply(case["batch"]).numpy()
    results = [r[name] for r in out]
    got = results[0]["whole"]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=PORT_REL * scale)
    assert np.array_equal(np.concatenate([r["rows"] for r in results],
                                         axis=1), got)
    assert all(r["whole"] is None for r in results[1:])


def _cast_gap(port, batch, got, ref):
    """(mean|got - whole cast forward|, the whole cast forward's spread
    at a one-bf16-step input change, got's mean and max drift from the
    float32 output `ref`, max|ref|)."""
    want = port.apply(batch).numpy()
    moved = port.apply({k: bf16_step(v) for k, v in batch.items()}).numpy()
    drift = np.abs(got - ref)
    return (float(np.abs(got - want).mean()),
            float(np.abs(moved - want).mean()), float(drift.mean()),
            float(drift.max()), float(np.abs(ref).max()),
            np.array_equal(got, want))


@pytest.mark.parametrize("name", CAST)
def test_cast_matches_the_whole_cast_forward(spawned, name, monkeypatch):
    """Each cast form (and the tap path) gathered against the port's
    whole forward in the same mode: MDCUN and the tap path bit-equal (the
    same ops on the same rows; B12's plain version and the depthwise taps
    are per pixel, the bf16 1x1 convs sum alike), the others within
    BF16_SPREAD of the whole forward's own spread at a one-bf16-step
    input change and inside the float32 drift envelope."""
    out, cases = spawned
    case = cases[name]
    got = out[0][name]["whole"]
    port = _port(case, monkeypatch)
    env = {k: v for k, v in case["env"].items()
           if k not in ("LGTEUN_EVAL_DTYPE", "LGTEUN_LIGHTNET_DTYPE")}
    ref = _port(case, monkeypatch, env).apply(case["batch"]).numpy()
    gap, spread, d_mean, d_max, scale, bits = _cast_gap(
        port, case["batch"], got, ref)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if name in ("MDCUN bf16", "LightNet taps"):
        assert bits
    assert gap <= BF16_SPREAD * spread
    assert d_mean <= DRIFT_MEAN * scale and d_max <= DRIFT_MAX * scale


def test_mutinf_under_bf16_is_its_float32_sharded_bits(spawned):
    """MutInf never casts (JAX's MutInf overrides `apply`): its sharded
    forward under LGTEUN_EVAL_DTYPE=bf16 is the float32 one, bit for bit,
    on every rank."""
    out, _ = spawned
    for r in out:
        assert np.array_equal(r["MutInf bf16"]["rows"], r["MutInf"]["rows"])


@pytest.mark.parametrize("name", CASES)
def test_collectives_a_forward(spawned, name):
    """Each rank runs the collectives its forward's halos, gathers and
    sums need, no more, and launches no kernel on the CPU (the card's
    launches, ROUTE, are chip_smoke.py's space phase's)."""
    out, _ = spawned
    want = COLLECTIVES[name.split()[0]]
    assert set(ROUTE.get(name, {})) <= set(ranks.SPATIAL_WRAPPERS)
    for r in out:
        assert r[name]["exchanges"] == want
        assert not any(r[name]["launches"].values())


# ------------------------------------------------ primitives, on threads

def _nhwc_rows(x, j, s):
    per = x.shape[1] // s
    return x[:, j * per:(j + 1) * per]


@pytest.mark.parametrize("cross", [False, True])
def test_shifted_windows_on_strips(monkeypatch, cross):
    """A shifted window attention on the ranks' rows: the plane rolled up
    by d through a "wrap" halo from the rank below, the upper/lower mask
    on the image's last band only, rolled back through a "wrap" halo from
    the rank above: the whole forward's rows (within 1e-6: the products
    run on fewer rows). The strip masks are the whole mask's bands; every
    rank taking the last band's mask, or no halo, is wrong."""
    torch.manual_seed(24)
    attn = WindowAttention(8, 2, 4, True, 4, cross).eval()
    init_parameters(attn, torch.Generator().manual_seed(25))
    x, y = _rand(1, 32, 12, 8, seed=26), _rand(1, 32, 12, 8, seed=27)
    full = _window_mask(4, 8, 3, torch.device("cpu"))
    assert torch.equal(_window_mask(4, 2, 3, torch.device("cpu")),
                       full[-6:])
    assert torch.equal(_window_mask(4, 2, 3, torch.device("cpu"), False),
                       full[:6])
    with torch.no_grad():
        want = attn(x, y if cross else None)

        def run(j, mesh):
            return spatial._window_attention_rows(
                attn, _nhwc_rows(x, j, 4),
                _nhwc_rows(y, j, 4) if cross else None, mesh)

        got = _Ranks(4, monkeypatch).run(run)
        torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=0,
                                   atol=1e-6)
        # every rank given the whole plane's last-band mask
        monkeypatch.setattr(spatial, "_window_mask",
                            lambda w, h, n, dev, last: _window_mask(
                                w, h, n, dev))
        wrong = _Ranks(4, monkeypatch).run(run)
    assert (torch.cat(wrong, dim=1) - want)[:, :24].abs().max() > 1e-3


def test_pixel_shuffle_tail_halo(monkeypatch):
    """PanFormer's HR_tail on strips of 4 rows: one halo of 2 rows at
    the input's grid serves its four 3x3 convs across two PixelShuffles
    (1 + 1/2 + 1/4 + 1/4 rows): the whole tail's rows."""
    from lgteun_tpu_torch.models.common.layers import Conv
    c = 4
    tail = torch.nn.Sequential(
        Conv(2 * c, 4 * c, 3), torch.nn.PixelShuffle(2), torch.nn.ReLU(),
        Conv(c, 4 * c, 3), torch.nn.PixelShuffle(2), torch.nn.ReLU(),
        Conv(c, c, 3), torch.nn.ReLU(), Conv(c, 3, 3)).eval()
    init_parameters(tail, torch.Generator().manual_seed(28))
    x = _rand(1, 2 * c, 16, 6, seed=29)
    halos = []
    real = _Ranks.halo
    monkeypatch.setattr(_Ranks, "halo", lambda self, t, a, b, mesh, edge: (
        halos.append((a, b)), real(self, t, a, b, mesh, edge))[1])
    with torch.no_grad():
        want = tail(x)
        got = _Ranks(4, monkeypatch).run(
            lambda j, mesh: spatial._tail_rows(tail, _rows(x, j, 4), mesh))
    torch.testing.assert_close(torch.cat(got, dim=-2), want, rtol=0,
                               atol=1e-6)
    assert halos == [(2, 2)] * 4


@pytest.mark.parametrize("per,n_halos", [(24, 3), (8, 6)])
def test_mutinf_quarter_grid_strips(monkeypatch, per, n_halos):
    """`_DenseBlockMscale` on the ranks' rows: the 1/2 and 1/4 bilinear
    downsamples of the rank's own rows (a strip on the 4-row grid), the
    dense block at each scale, back up, the pooled gate from all-reduced
    sums: the whole block's rows within 1e-6. At 24 rows a rank one halo
    a scale (6 rows at 1/4); at 8 (2 rows at 1/4) a halo before each
    stage where one deep halo does not fit."""
    blk = _DenseBlockMscale(4, 4).eval()
    init_parameters(blk, torch.Generator().manual_seed(30))
    for hin in (blk.ops.conv1, blk.ops.conv2):
        hin.norm.weight.data.uniform_(0.5, 1.5)
        hin.norm.bias.data.uniform_(-0.2, 0.2)
    x = _rand(1, 4, 4 * per, 12, seed=31)
    halos = []
    real = _Ranks.halo
    monkeypatch.setattr(_Ranks, "halo", lambda self, t, a, b, mesh, edge: (
        halos.append(a), real(self, t, a, b, mesh, edge))[1])
    with torch.no_grad():
        want = blk(x)
        got = _Ranks(4, monkeypatch).run(lambda j, mesh: spatial._mscale_rows(
            [blk], _rows(x, j, 4), mesh)[0])
    torch.testing.assert_close(torch.cat(got, dim=-2), want, rtol=0,
                               atol=1e-6)
    assert len(halos) == 4 * n_halos


def test_sfiin_gathered_frequency_branch_and_contrast(monkeypatch):
    """`SpaFre` on the ranks' rows: FreProcess on the gathered msf and
    panf (exact, redundant), the spatial branch on a strip of the
    gathered planes, the channel mean and population contrast from
    all-reduced sums in two passes: the whole block's rows and its PAN
    features within 1e-6 of max|out|."""
    blk = SpaFre(8).eval()
    init_parameters(blk, torch.Generator().manual_seed(32))
    msf, pan = _rand(1, 8, 32, 16, seed=33), _rand(1, 8, 32, 16, seed=34)
    with torch.no_grad():
        want, want_pan = blk(msf, pan)
        got = _Ranks(4, monkeypatch).run(lambda j, mesh: spatial._spafre_rows(
            blk, _rows(msf, j, 4), _rows(pan, j, 4), mesh))
    scale = float(want.abs().max())
    torch.testing.assert_close(torch.cat([g[0] for g in got], dim=-2), want,
                               rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(torch.cat([g[1] for g in got], dim=-2),
                               want_pan, rtol=0, atol=1e-6)


def test_gsa_gathered_regression(monkeypatch):
    """GSA on the ranks' rows: the design gathered, alpha solved on every
    rank from the same bits (the same alpha on each), every mean and the
    gains from all-reduced sums: the whole fusion's rows within 1e-6."""
    rng = np.random.default_rng(35)
    lr = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 8, 8, 4)).astype(
        np.float32))
    pan = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 32, 32, 1)).astype(
        np.float32))
    alphas = []
    solve = spatial.lstsq_min_norm

    def recorded(a, b):
        alpha = solve(a, b)
        alphas.append(alpha)
        return alpha

    monkeypatch.setattr(spatial, "lstsq_min_norm", recorded)
    want = gsa_fuse(lr, pan)
    got = _Ranks(4, monkeypatch).run(lambda j, mesh: spatial.gsa_rows(
        _nhwc_rows(lr, j, 4), _nhwc_rows(pan, j, 4), mesh))
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=0,
                               atol=1e-6)
    assert len(alphas) == 4 and all(torch.equal(a, alphas[0])
                                    for a in alphas)


def test_space_mean_and_instance_norm_under_the_cast(monkeypatch):
    """Under the cast a statistic over H x W all-reduces float32 partial
    sums and rounds once, as torch's bfloat16 mean and instance norm
    accumulate in float32: `space_mean` is the whole bfloat16 mean bit
    for bit, and the HIN block's norm is float32's rounded once (within
    half a bfloat16 step of float64, nearer than torch's own bfloat16
    norm on the CPU, which rounds on its way); bfloat16 partial sums,
    all-reduced, are not the whole mean."""
    t = (_rand(2, 3, 32, 16, seed=36) * 3 + 0.4).to(torch.bfloat16)
    want = t.mean(dim=(2, 3), keepdim=True)
    n = 32 * 16
    got = _Ranks(4, monkeypatch).run(
        lambda j, mesh: spatial.space_mean(_rows(t, j, 4), mesh, n))
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, want)
               for g in got)
    partial = _Ranks(4, monkeypatch).run(lambda j, mesh: spatial.space_sum(
        _rows(t, j, 4).sum(dim=(2, 3), keepdim=True), mesh) / n)
    assert not torch.equal(partial[0], want)
    norm = _HINConvBlock(4, 8).norm.eval()
    norm.weight.data.uniform_(0.5, 1.5, generator=torch.Generator(
        ).manual_seed(37))
    norm.bias.data.uniform_(-0.2, 0.2)
    norm = norm.to(torch.bfloat16)
    y = (_rand(1, 4, 32, 12, seed=38) * 2 - 0.5).to(torch.bfloat16)
    with torch.no_grad():
        whole = norm(y)

        def run(j, mesh):
            a = j * 8
            normed, = spatial.instance_norm_rows(
                [(norm, spatial.Strip(_rows(y, j, 4), a, a + 8, 32))], mesh)
            return normed.own(mesh)

        got = torch.cat(_Ranks(4, monkeypatch).run(run), dim=-2)
    assert got.dtype == torch.bfloat16
    exact = F.instance_norm(y.double(), weight=norm.weight.double(),
                            bias=norm.bias.double())
    step = 2.0 ** (torch.floor(torch.log2(exact.abs())) - 8)
    assert ((got.double() - exact).abs() <= step).all()
    assert ((whole.double() - exact).abs().max()
            > (got.double() - exact).abs().max())


def test_panformer_unclamped_matches_jax(monkeypatch):
    """PanFormer's tail before the clamp on the ranks' rows (2 images,
    ms 16², 16 PAN rows a rank) against JAX's whole forward's
    (`tail_conv3`, which random weights leave mostly outside [0, 1]) at
    5e-4, and against the port's unclamped forward within 1e-5 of its
    max."""
    tree, batch, _, pre = panformer_case(BANDS, SMALL, (16, 16), seed=39)
    port = build_model("PanFormer", Config(model_type="PanFormer",
                                           ms_chans=BANDS,
                                           model_cfg=MODEL_CFG["PanFormer"]),
                       device="cpu")
    port.load_state_dict(panformer_from_flax(tree), strict=True)
    module = port.module.eval()
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    ms, pan = nchw(batch["input_lr"]), nchw(batch["input_pan"])
    with torch.no_grad():
        want = module.unclamped(ms, pan)
        got = _Ranks(4, monkeypatch).run(lambda j, mesh: spatial.panformer_rows(
            module, _rows(ms, j, 4), _rows(pan, j, 4), mesh, clamp=False))
    got = torch.cat(got, dim=-2).detach()   # the threads record grads
    torch.testing.assert_close(got, want, rtol=0,
                               atol=PORT_REL * float(want.abs().max()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), pre, rtol=0,
                               atol=5e-4)
    assert 0.05 < float(np.mean((pre < 0) | (pre > 1))) < 0.95


def test_refuses_panformer_strips_off_its_window_grid():
    """PanFormer's strips must be whole windows after two x1/2 merges: 8
    PAN rows a rank are refused, not gathered."""
    port = build_model("PanFormer", Config(
        model_type="PanFormer", ms_chans=BANDS,
        model_cfg=MODEL_CFG["PanFormer"]), device="cpu")
    port.init_params(torch.Generator().manual_seed(0))
    batch = {"input_lr": np.zeros((1, 8, 8, BANDS), np.float32),
             "input_pan": np.zeros((1, 32, 32, 1), np.float32)}
    with pytest.raises(ValueError, match=r"multiple of 16.*A\.9\.3"):
        spatial.run_spatially_sharded(port.eval(), batch,
                                      Mesh(rank=0, world=4, space_world=4))
