"""Height-sharded eval forwards of the port on the CPU
(`lgteun_tpu_torch/parallel/spatial.py`, the `space` axis of
`parallel/mesh.py`) against JAX's `run_spatially_sharded` and the port's
own unsharded forward.

One spawn of four gloo ranks (`ranks.spawn`, a file:// rendezvous under
tmp_path) runs two `ranks.spatial_job`s, each laying a mesh of its own
shape over the four ranks: {"space": 4} with the cases of
tests/test_spatial.py (UnlgFormer's `LGTEUN(ms_chans=4, stage=1)` at ms
16² / pan 64², SFIM and Wavelet at batch 2, and LightNet at pan 64²) and
{"data": 2, "space": 2} with UnlgFormer at batch 2 (the batch over
`data`; tests/test_spatial.py's 2 x 4 mesh needs eight processes, so JAX
runs the same 2 x 2 mesh on four of conftest's virtual devices). Weights:
`flax_params` trees converted with `convert/from_jax.py`.

Bounds: the gathered output against JAX's sharded run at the port's
existing JAX parity bound of each method (UnlgFormer 5e-4, ROADMAP "A
slice is done"; LightNet 1e-4, tests/test_torch_port_lightnet.py; SFIM
and Wavelet 1e-5 in float32, tests/test_torch_port_classical.py), and
against the port's unsharded forward within 1e-5 (tests/test_spatial.py's
bound; one intra-op thread here as in each rank, where every case but
SFIM, whose sums run in another order, is bit-equal).

Without spawning: the strip geometry of each operation, with the
collectives emulated from the whole tensor (`_emulated`), and the
refusals of `run_spatially_sharded` (MDCUN, INNT and UnlgFormer's other
fuse levels, v2 and bf16 storage modes are sharded since: their tests are
tests/test_torch_port_spatial_zoo.py; the rest of the zoo, the blanket
bf16 cast and LightNet's tap path since: tests/test_torch_port_spatial_
rest.py, and here each of them on two ranks run as threads).
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from lgteun_tpu.models.classical import (sfim_fuse as jax_sfim,
                                         wavelet_fuse as jax_wavelet)
from lgteun_tpu.models.lgteun import LGTEUN as JaxLGTEUN
from lgteun_tpu.models.lightnet import LightNetModule as JaxLightNet
from lgteun_tpu.parallel.spatial import (
    run_spatially_sharded as jax_run_spatially_sharded)
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import (lgteun_from_flax,
                                               lightnet_from_flax)
from lgteun_tpu_torch.models import classical
from lgteun_tpu_torch.ops.interp23 import interp23_upsample
from lgteun_tpu_torch.ops.lightnet_kernel import lightnet_stack_ref
from lgteun_tpu_torch.ops.resize import sample_scale
from lgteun_tpu_torch.parallel import ranks, spatial
from lgteun_tpu_torch.parallel.mesh import Mesh
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_lightnet import (  # noqa: E402
    flax_params as lightnet_flax_params)
from test_torch_port_spatial_zoo import _Ranks  # noqa: E402

BANDS = 4
JAX_ATOL = {"UnlgFormer": 5e-4, "lightnet": 1e-4, "SFIM": 1e-5,
            "Wavelet": 1e-5}
PORT_ATOL = 1e-5
SPACE4 = ("UnlgFormer", "SFIM", "Wavelet", "lightnet")
CASES = (*(("space4", m) for m in SPACE4), ("hybrid", "UnlgFormer"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process, as each spawned rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"input_lr": rng.uniform(0.1, 0.9, (b, 16, 16, BANDS)).astype(
        np.float32), "input_pan": rng.uniform(0.1, 0.9, (b, 64, 64, 1)
                                             ).astype(np.float32)}


def _cfg(method):
    model_cfg = {"core_module": {"stage": 1}} if method == "UnlgFormer" \
        else {}
    return Config(model_type=method, ms_chans=BANDS, model_cfg=model_cfg)


@pytest.fixture(scope="module")
def trees():
    return {"UnlgFormer": flax_params(BANDS, stage=1, seed=19),
            "lightnet": lightnet_flax_params(BANDS, seed=19)}


def _weights(method, trees):
    convert = {"UnlgFormer": lgteun_from_flax,
               "lightnet": lightnet_from_flax}.get(method)
    if convert is None:
        return None
    return {k: v.numpy() for k, v in convert(trees[method]).items()}


def _case(tag, method, trees):
    batch = _batch(1 if (tag, method) == ("space4", "UnlgFormer") else 2,
                   seed=len(method) + (tag == "hybrid"))
    return dict(name=f"{tag} {method}", method=method, cfg=_cfg(method),
                weights=_weights(method, trees), batch=batch,
                batch_axis="data" if tag == "hybrid" else None)


@pytest.fixture(scope="module")
def spawned(trees, tmp_path_factory):
    """The four-rank spawn: [rank][job] results, and the cases by name."""
    cases = {(tag, m): _case(tag, m, trees) for tag, m in CASES}
    jobs = [(ranks.spatial_job, dict(
        mesh_shape={"space": 4},
        cases=[cases["space4", m] for m in SPACE4])),
        (ranks.spatial_job, dict(mesh_shape={"data": 2, "space": 2},
                                 cases=[cases["hybrid", "UnlgFormer"]]))]
    out = ranks.spawn(jobs, 4, str(tmp_path_factory.mktemp("spatial")))
    return out, cases


def _results(spawned, tag):
    out, _ = spawned
    return [r[0 if tag == "space4" else 1] for r in out]


def _jax_fn(method, trees):
    if method == "SFIM":
        return lambda b: jax_sfim(b["input_lr"], b["input_pan"])
    if method == "Wavelet":
        return lambda b: jax_wavelet(b["input_lr"], b["input_pan"])
    module = (JaxLGTEUN(ms_chans=BANDS, stage=1) if method == "UnlgFormer"
              else JaxLightNet(ms_chans=BANDS))
    params = {"params": jax.tree.map(jnp.asarray, trees[method])}
    return lambda b: module.apply(params, b["input_lr"], b["input_pan"])


def _jax_mesh(tag):
    devs = np.asarray(jax.devices()[:4])
    if tag == "space4":
        return JaxMesh(devs, ("space",))
    return JaxMesh(devs.reshape(2, 2), ("data", "space"))


def test_spawned_ranks_import_no_jax(spawned):
    out, _ = spawned
    assert all(not r["jax_imported"] for rank in out for r in rank)


@pytest.mark.parametrize("tag,method", CASES)
def test_sharded_matches_jax(spawned, trees, tag, method):
    """The gathered output against JAX's `run_spatially_sharded` of the
    same function on a mesh of the same shape, at the method's port-vs-
    JAX bound."""
    _, cases = spawned
    case = cases[tag, method]
    got = _results(spawned, tag)[0][case["name"]]["whole"]
    jbatch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    want = np.asarray(jax_run_spatially_sharded(
        _jax_fn(method, trees), jbatch, _jax_mesh(tag),
        batch_axis="data" if tag == "hybrid" else None))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL[method])


@pytest.mark.parametrize("tag,method", CASES)
def test_sharded_matches_unsharded_port(spawned, tag, method):
    """The gathered output against the port's unsharded forward of the
    same weights (`apply`) within 1e-5; `gather_h` on rank 0 is every
    rank's rows in order (H within a data rank, then the data ranks)."""
    _, cases = spawned
    case = cases[tag, method]
    results = [r[case["name"]] for r in _results(spawned, tag)]
    port = build_model(method, case["cfg"], device="cpu")
    if case["weights"] is not None:
        port.load_state_dict({k: torch.from_numpy(v)
                              for k, v in case["weights"].items()})
    want = port.apply(case["batch"]).numpy()
    got = results[0]["whole"]
    np.testing.assert_allclose(got, want, rtol=0, atol=PORT_ATOL)
    space = 4 if tag == "space4" else 2
    rows = [r["rows"] for r in results]
    by_data = [np.concatenate(rows[i:i + space], axis=1)
               for i in range(0, len(rows), space)]
    assert np.array_equal(np.concatenate(by_data), got)
    assert all(r["whole"] is None for r in results[1:])


# the collectives of one forward on every rank of each case (stage-1
# UnlgFormer: the x4 resample, D's and DT's two resamples and two 3x3
# convs, the prior's down and up resamples; one gather a LGB block)
COLLECTIVES = {"UnlgFormer": {"halo": 11, "gather": 5},
               "SFIM": {"gather": 1, "sum": 4, "halo": 1},
               "Wavelet": {"gather": 1}, "lightnet": {"halo": 3}}


@pytest.mark.parametrize("tag,method", CASES)
def test_collectives_a_forward(spawned, tag, method):
    """Each rank runs the collectives its forward's halos and gathers
    need, no more (every rank of a strip has a neighbour to exchange
    with), and launches no kernel on the CPU."""
    _, cases = spawned
    for r in _results(spawned, tag):
        got = r[cases[tag, method]["name"]]
        assert got["exchanges"] == COLLECTIVES[method]
        assert not any(got["launches"].values())


# ------------------------------------------------- geometry, no spawning

def _emulated(whole, j, s, above, below, edge):
    """What `halo_rows` gives rank j of s from `whole` [..., H, W]."""
    h = whole.shape[-2] // s
    a, b = j * h, (j + 1) * h
    zeros = lambda n: whole.new_zeros((*whole.shape[:-2], n,
                                       whole.shape[-1]))
    if j > 0:
        top = whole[..., a - above:a, :]
    else:
        top = {"zero": zeros(above), "none": zeros(0),
               "wrap": whole[..., whole.shape[-2] - above:, :]}[edge]
    if j < s - 1:
        bottom = whole[..., b:b + below, :]
    else:
        bottom = {"zero": zeros(below), "none": zeros(0),
                  "wrap": whole[..., :below, :]}[edge]
    return torch.cat([top, whole[..., a:b, :], bottom], dim=-2)


@pytest.fixture
def emulate(monkeypatch):
    """Patch `spatial.halo_rows` and `spatial.all_gather_h` to read the
    neighbours' rows from the whole tensors registered with the returned
    function (matched by their strips' shapes)."""
    wholes = []

    def halo(x, above, below, mesh, edge):
        s, j = mesh.space_world, mesh.space_rank
        whole, = [w for w in wholes if w.shape[:-2] == x.shape[:-2]
                  and w.shape[-2] == x.shape[-2] * s
                  and w.shape[-1] == x.shape[-1]]
        assert torch.equal(x, whole[..., j * x.shape[-2]:
                                    (j + 1) * x.shape[-2], :])
        assert max(above, below) <= x.shape[-2]
        return _emulated(whole, j, s, above, below, edge)

    def gather(x, mesh, dim=-2):
        whole, = [w for w in wholes if w.dim() == x.dim()
                  and w.shape[dim] == x.shape[dim] * mesh.space_world
                  and all(w.shape[d] == x.shape[d] for d in range(x.dim())
                          if d != dim % x.dim())]
        return whole

    monkeypatch.setattr(spatial, "halo_rows", halo)
    monkeypatch.setattr(spatial, "all_gather_h", gather)
    return wholes.append


def _mesh(j, s, d=1, i=0):
    return Mesh(rank=i * s + j, world=d * s, space_world=s)


@pytest.mark.parametrize("edge", spatial.EDGES)
@pytest.mark.parametrize("s", [1, 2, 4])
def test_edge_rows_and_single_rank_halo(edge, s):
    """The rows `halo_rows` adds at each rank; one rank is its own
    neighbour (no collective)."""
    for j in range(s):
        top, bottom = spatial.edge_rows(_mesh(j, s), 2, 3, edge)
        assert top == (0 if edge == "none" and j == 0 else 2)
        assert bottom == (0 if edge == "none" and j == s - 1 else 3)
    x = torch.arange(2 * 8 * 5, dtype=torch.float32).reshape(2, 8, 5)
    got = spatial.halo_rows(x, 2, 3, _mesh(0, 1), edge)
    assert torch.equal(got, _emulated(x, 0, 1, 2, 3, edge))


@pytest.mark.parametrize("h,s,win", [(64, 4, 8), (240, 2, 8), (120, 2, 8),
                                     (32, 4, 8), (64, 1, 8)])
def test_window_strip(h, s, win):
    """[lo, hi) holds the rank's rows with one window band and a row
    beyond each side (B3's 3x3 depthwise conv), on the window grid, in
    the image."""
    per = h // s
    for j in range(s):
        a, b = j * per, (j + 1) * per
        lo, hi = spatial.window_strip(a, b, h, win)
        assert lo % win == 0 and hi % win == 0 and 0 <= lo and hi <= h
        assert lo == 0 or lo <= a - win
        assert hi == h or hi >= b + win
        assert (hi - lo) % 8 == 0


@pytest.mark.parametrize("factor", [4, 2, 0.5, 0.25])
@pytest.mark.parametrize("s", [2, 4])
def test_resample_rows_is_the_whole_resample(emulate, factor, s):
    """`resample_rows` on each rank's strip is the rank's rows of the
    whole plane's bicubic resample, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 3, 32, 24)).astype(np.float32))
    emulate(x)
    want = sample_scale(x, factor)
    n = want.shape[-2] // s
    for j in range(s):
        got = spatial.resample_rows(x[..., j * 32 // s:(j + 1) * 32 // s, :],
                                    factor, _mesh(j, s))
        assert torch.equal(got, want[..., j * n:(j + 1) * n, :])


@pytest.mark.parametrize("s", [2, 4])
def test_conv_rows_is_the_whole_conv(emulate, s):
    """A 3x3 depthwise 'same' conv (`DepConv`) on a "zero" halo."""
    conv = torch.nn.Conv2d(3, 3, 3, padding=1, groups=3)
    x = torch.rand(2, 3, 32, 24, generator=torch.Generator().manual_seed(4))
    emulate(x)
    with torch.no_grad():
        want = conv(x)
        for j in range(s):
            rows = slice(j * 32 // s, (j + 1) * 32 // s)
            got = spatial.conv_rows(conv, x[..., rows, :], _mesh(j, s))
            torch.testing.assert_close(got, want[..., rows, :], rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("s", [2, 4])
def test_lightnet_rows_is_the_whole_forward(emulate, trees, s):
    """`lightnet_rows` on each rank (its two resamples on 2-row halos, B9's
    plain version on a 10-row "none" halo, cropped) is the whole
    LightNet forward's rows, bit for bit; B9 on a 9-row halo is not."""
    port = build_model("lightnet", _cfg("lightnet"), device="cpu")
    port.load_state_dict(lightnet_from_flax(trees["lightnet"]))
    module = port.module.eval()
    g = torch.Generator().manual_seed(5)
    ms, pan = torch.rand(1, BANDS, 16, 10, generator=g), torch.rand(
        1, 1, 64, 40, generator=g)
    lms2 = sample_scale(ms, 2)
    x = torch.cat([pan, sample_scale(lms2, 2)], dim=1)
    for whole in (ms, lms2, x):
        emulate(whole)
    per = 64 // s
    layers = [sp.weights() for sp in module.spans()]
    with torch.no_grad():
        want = module(ms, pan)
        short = 0.0
        for j in range(s):
            rows = slice(j * per, (j + 1) * per)
            got = spatial.lightnet_rows(module, ms[..., j * 16 // s:
                                                   (j + 1) * 16 // s, :],
                                        pan[..., rows, :], _mesh(j, s))
            assert torch.equal(got, want[..., rows, :])
            top, _ = spatial.edge_rows(_mesh(j, s), 9, 9, "none")
            xh = _emulated(x, j, s, 9, 9, "none")
            nine = lightnet_stack_ref(xh, xh[:, 1:], layers)
            short = max(short, float((nine[..., top:top + per, :]
                                      - want[..., rows, :]).abs().max()))
    assert short > 1e-5


def test_lgb_strips_are_the_whole_block(monkeypatch):
    """`spatial._lgb` (B1 on the gathered plane, B2 / B3 on the window
    strip, cropped) on each rank of 2 and 4 is the whole LGB's rows, bit
    for bit (plain versions; C 16, 64², two blocks)."""
    from torch import nn

    from lgteun_tpu_torch.models.common.layers import init_parameters
    from lgteun_tpu_torch.models.common.lgt import LGB

    lgb = LGB(16, 2, win=8, heads=2, level=2).eval()
    init_parameters(lgb, torch.Generator().manual_seed(6))
    x = torch.rand(2, 16, 64, 64, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = lgb(x)
        # each block's whole input (what its all-gather returns)
        inputs = [x]
        for block in lgb.blocks:
            one = LGB(16, 1, win=8, heads=2, level=2).eval()
            one.blocks = nn.ModuleList([block])
            inputs.append(one(inputs[-1]))
        for s in (2, 4):
            per = 64 // s
            for j in range(s):
                it = iter(inputs)
                monkeypatch.setattr(spatial, "all_gather_h",
                                    lambda t, mesh, dim=-2: next(it))
                got = spatial._lgb(lgb, x[..., j * per:(j + 1) * per, :],
                                   _mesh(j, s))
                assert torch.equal(got, want[..., j * per:(j + 1) * per, :])


def test_interp23_rows_and_wavelet_strips():
    """interp23's rows of the H matrix are the whole upsample's rows; the
    Haar injection on strips of a multiple of 4 rows is the whole's."""
    rng = np.random.default_rng(9)
    lr = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 16, 16, 4)).astype(
        np.float32))
    pan = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 64, 64, 1)).astype(
        np.float32))
    u = interp23_upsample(lr, 4)
    whole = classical.wavelet_inject(u, pan)
    for j in range(4):
        rows = slice(16 * j, 16 * (j + 1))
        part = interp23_upsample(lr, 4, rows=rows)
        torch.testing.assert_close(part, u[:, rows], rtol=0, atol=1e-6)
        assert torch.equal(classical.wavelet_inject(u[:, rows], pan[:, rows]),
                           whole[:, rows])


def test_sfim_wrap_halo_is_the_circular_box():
    """SFIM's box filter on a "wrap" halo of k // 2 rows and a circular
    pad along W is the whole plane's circular box filter."""
    from lgteun_tpu_torch.ops.filters import depthwise_conv2d

    x = torch.rand(1, 2, 32, 24, generator=torch.Generator().manual_seed(10))
    box = np.full((5, 5), 1 / 25)
    want = depthwise_conv2d(F.pad(x, (2, 2, 2, 2), mode="circular"), box)
    for j in range(4):
        xh = F.pad(_emulated(x, j, 4, 2, 2, "wrap"), (2, 2, 0, 0),
                   mode="circular")
        torch.testing.assert_close(depthwise_conv2d(xh, box),
                                   want[..., 8 * j:8 * (j + 1), :],
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,d,s", [(4, 2, 2), (2, 2, 2), (2, 1, 4),
                                   (8, 2, 4)])
def test_spatial_sharding_matches_jax_named_sharding(n, d, s):
    """Rank i * s + j keeps the block that JAX's NamedSharding(mesh,
    P("data", "space")) puts on device (i, j) of a d x s mesh (devices
    in row-major order, as JAX's make_mesh reshapes them)."""
    a = np.arange(n * 8 * 3 * 2, dtype=np.float32).reshape(n, 8, 3, 2)
    devs = np.asarray(jax.devices()[:d * s]).reshape(d, s)
    put = jax.device_put(a, NamedSharding(JaxMesh(devs, ("data", "space")),
                                          P("data", "space")))
    for i in range(d):
        for j in range(s):
            sharding = spatial.spatial_sharding(_mesh(j, s, d, i), "data")
            want, = [np.asarray(sh.data) for sh in put.addressable_shards
                     if sh.device == devs[i, j]]
            assert np.array_equal(sharding.place(a), want)
    assert np.array_equal(spatial.spatial_sharding(_mesh(0, s, d, 1))
                          .place(a), a[:, :8 // s])


# ---------------------------------------------------------------- refusals

def _method(model_type, env=None, monkeypatch=None, **model_cfg):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    cfg = Config(model_type=model_type, ms_chans=BANDS,
                 model_cfg={"core_module": model_cfg} if model_cfg else {})
    method = build_model(model_type, cfg, device="cpu")
    method.init_params(torch.Generator().manual_seed(0))
    return method.eval()


def _on_two_ranks(method, batch, monkeypatch):
    """`run_spatially_sharded` of `method` on two ranks run as threads
    (`_Ranks`), the rows gathered."""
    rows = _Ranks(2, monkeypatch).run(
        lambda j, mesh: spatial.run_spatially_sharded(method, batch, mesh))
    return torch.cat(rows, dim=1)


@pytest.mark.parametrize("model_type", ["GSA", "PanFormer", "SFIIN",
                                        "MutInf"])
def test_runs_the_rest_of_the_zoo_sharded(model_type, monkeypatch):
    """GSA, PanFormer, SFIIN and MutInf (seeded, shipped widths) on two
    ranks: the unsharded forward's output within 1e-5 of max|out|
    (their forwards: tests/test_torch_port_spatial_rest.py)."""
    method, batch = _method(model_type), _batch(1, 0)
    want = method.apply(batch)
    got = _on_two_ranks(method, batch, monkeypatch)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=PORT_ATOL * float(want.abs().max()))


def test_runs_lightnet_bf16_tap_path_sharded(monkeypatch):
    """LightNet's bf16 tap path on two ranks (the stack on the same
    10-row halo as B9's): the unsharded tap path bit for bit."""
    method = _method("lightnet", {"LGTEUN_LIGHTNET_DTYPE": "bf16"},
                     monkeypatch)
    batch = _batch(1, 0)
    assert torch.equal(_on_two_ranks(method, batch, monkeypatch),
                       method.apply(batch))


def test_refuses_an_h_the_space_size_does_not_divide():
    method = _method("SFIM")
    with pytest.raises(ValueError, match=r"H 16 does not divide.*A\.9\.3"):
        spatial.run_spatially_sharded(method, _batch(1, 0), _mesh(0, 3))


def test_refuses_wavelet_strips_off_the_haar_grid():
    lr = torch.rand(1, 4, 8, 4)
    pan = torch.rand(1, 16, 32, 1)
    with pytest.raises(ValueError, match=r"multiple of 4.*A\.9\.3"):
        spatial.wavelet_rows(lr[:, :2], pan[:, :6], _mesh(0, 2))


def test_refuses_a_call_with_gradients_on():
    method = _method("UnlgFormer", stage=1)
    batch = {k: torch.from_numpy(v).requires_grad_()
             for k, v in _batch(1, 0).items()}
    with pytest.raises(ValueError, match=r"gradients.*A\.9\.3"):
        spatial.run_spatially_sharded(method, batch, _mesh(0, 2))
    method.train()
    with pytest.raises(ValueError, match=r"training mode.*A\.9\.3"):
        spatial.run_spatially_sharded(method, _batch(1, 0), _mesh(0, 2))


def test_refuses_a_halo_deeper_than_the_neighbour():
    x = torch.rand(1, 1, 4, 8)
    with pytest.raises(ValueError, match=r"halo of 5 rows.*A\.9\.3"):
        spatial.halo_rows(x, 5, 5, _mesh(0, 2), "zero")


def test_refuses_other_axes():
    with pytest.raises(ValueError, match="'data' and 'space'"):
        spatial.spatial_sharding(_mesh(0, 2), batch_axis="model")
    with pytest.raises(ValueError, match="'data' and 'space'"):
        spatial.spatial_sharding(_mesh(0, 2), space_axis="height")
