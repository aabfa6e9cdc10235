"""Height-sharded eval forwards of the port's MDCUN, INNT and
UnlgFormer's other forms on the CPU (`lgteun_tpu_torch/parallel/
spatial.py`) against JAX's `run_spatially_sharded` and the port's own
unsharded forward.

One spawn of four gloo ranks (`ranks.spawn`, a file:// rendezvous under
tmp_path) runs one `ranks.spatial_job` on {"space": 4} at ms 16² / pan
64², 4 bands, batch 1: MDCUN (T 2, mid 16), INNT on both routes
(`texture_match`, and `patch_match` with LGTEUN_FUSED_TM=0) and
UnlgFormer's `LGTEUN(ms_chans=4, stage=1)` in its eleven forms besides
level 2 float32 (levels 1, 2, 3 and `v2` at levels 1 and 2, each in
float32, `bf16res` and `bf16`; each form's switches set while the
method is built). Weights: flax trees filled from numpy, converted with
`convert/from_jax.py`.

Bounds: the gathered output against JAX's sharded run of the same flax
module (on four of conftest's virtual devices, where JAX's MDCUN and
INNT take their XLA expressions, which GSPMD partitions) at the port's
existing parity bounds (MDCUN 1e-3, INNT 5e-4, UnlgFormer float32 5e-4;
JAX's CPU bf16 is chaotic at its own drift, ROADMAP C.37, so it holds no
bf16 form); against the port's unsharded forward within 1e-5, and every
UnlgFormer form bit-equal (one intra-op thread here as in each rank).
MDCUN's strips run oneDNN's 3x3 convs of 64 channels on other shapes,
and INNT's instance norms and CALayer mean sum in another order, so
those two are held to the bound, not to the bits.

Without spawning, the strip geometry of each new primitive, with the
collectives emulated by threads, one a rank (`_Ranks`), the blanket
bf16 cast of MDCUN and INNT on two such ranks, and the refusals that
remain.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from lgteun_tpu.models.innt import GPPNNINNT as JaxINNT
from lgteun_tpu.models.lgteun import LGTEUN as JaxLGTEUN
from lgteun_tpu.models.mdcun import PanUnfolding as JaxMDCUN
from lgteun_tpu.parallel.spatial import (
    run_spatially_sharded as jax_run_spatially_sharded)
from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.convert.from_jax import (innt_from_flax,
                                               lgteun_from_flax,
                                               mdcun_from_flax)
from lgteun_tpu_torch.models.common.refine import Refine
from lgteun_tpu_torch.models.innt import TransformerFusion
from lgteun_tpu_torch.models.mutinf import _HINConvBlock
from lgteun_tpu_torch.ops.nonlocal_kernel import neighborhood_attention_ref
from lgteun_tpu_torch.ops.patches import extract_patches, fold_patches
from lgteun_tpu_torch.ops.resize import resize_bicubic, sample_scale
from lgteun_tpu_torch.parallel import ranks, spatial
from lgteun_tpu_torch.parallel.mesh import Mesh
from lgteun_tpu_torch.registry import build_model

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_convert import flax_params  # noqa: E402
from test_torch_port_innt import _fill, _innt_shapes  # noqa: E402
from test_torch_port_mdcun import MID, T  # noqa: E402
from test_torch_port_mdcun import flax_params as mdcun_flax_params  # noqa

BANDS = 4
JAX_ATOL = {"MDCUN": 1e-3, "INNT": 5e-4, "UnlgFormer": 5e-4}
PORT_ATOL = 1e-5
# UnlgFormer's forms: (LGTEUN_FUSE_LEVEL, LGTEUN_FUSED_ATTENTION,
# LGTEUN_EVAL_DTYPE); level 2 float32 is tests/test_torch_port_spatial.py's
FORMS = [(lvl, att, st) for lvl, att in (("1", ""), ("2", ""), ("3", ""),
                                         ("1", "v2"), ("2", "v2"))
         for st in ("", "bf16res", "bf16") if (lvl, att, st) != ("2", "", "")]


def _form_name(lvl, att, st):
    return f"UnlgFormer L{lvl}{' ' + att if att else ''} {st or 'float32'}"


def _form_env(lvl, att, st):
    return {"LGTEUN_FUSE_LEVEL": lvl, "LGTEUN_FUSED_ATTENTION": att or "1",
            "LGTEUN_EVAL_DTYPE": st}


CASES = ["MDCUN", "INNT texture_match", "INNT patch_match",
         *(_form_name(*f) for f in FORMS)]
FLOAT32 = ["MDCUN", "INNT texture_match", "INNT patch_match",
           *(_form_name(*f) for f in FORMS if not f[2])]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process, as each spawned rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_lr": rng.uniform(0.1, 0.9, (1, 16, 16, BANDS)).astype(
        np.float32), "input_pan": rng.uniform(0.1, 0.9, (1, 64, 64, 1)
                                             ).astype(np.float32)}


@pytest.fixture(scope="module")
def trees():
    return {"UnlgFormer": flax_params(BANDS, stage=1, seed=20),
            "MDCUN": mdcun_flax_params(BANDS, seed=20),
            "INNT": _fill(_innt_shapes(BANDS), seed=20)}


def _case(name, trees):
    method = name.split()[0]
    model_cfg = {"UnlgFormer": {"core_module": {"stage": 1}},
                 "MDCUN": {"core_module": {"mid_channels": MID, "T": T}}
                 }.get(method, {})
    convert = {"UnlgFormer": lgteun_from_flax, "MDCUN": mdcun_from_flax,
               "INNT": innt_from_flax}[method]
    env = {"INNT": {"LGTEUN_FUSED_TM": "0" if "patch" in name else "1"}}.get(
        method, {})
    if method == "UnlgFormer":
        env = _form_env(*FORMS[CASES.index(name) - 3])
    return dict(name=name, method=method, env=env,
                cfg=Config(model_type=method, ms_chans=BANDS,
                           model_cfg=model_cfg),
                weights={k: v.numpy() for k, v in
                         convert(trees[method]).items()},
                batch=_batch(seed=21 + (method == "INNT")))


@pytest.fixture(scope="module")
def spawned(trees, tmp_path_factory):
    """The four-rank spawn: [rank] results, and the cases by name."""
    cases = {name: _case(name, trees) for name in CASES}
    out = ranks.spawn([(ranks.spatial_job, dict(
        mesh_shape={"space": 4}, cases=list(cases.values())))], 4,
        str(tmp_path_factory.mktemp("spatial_zoo")))
    return [r[0] for r in out], cases


def test_spawned_ranks_import_no_jax(spawned):
    out, _ = spawned
    assert all(not r["jax_imported"] for r in out)


_JAX = {}


def _jax_sharded(method, trees, batch):
    """JAX's `run_spatially_sharded` of the flax module on {"space": 4},
    once a method (INNT's two routes are one JAX function off the TPU)."""
    if method not in _JAX:
        module = {"UnlgFormer": JaxLGTEUN(ms_chans=BANDS, stage=1),
                  "MDCUN": JaxMDCUN(ms_chans=BANDS, mid_channels=MID,
                                    stages=T),
                  "INNT": JaxINNT(ms_chans=BANDS)}[method]
        params = {"params": jax.tree.map(jnp.asarray, trees[method])}
        fn = lambda b: module.apply(params, b["input_lr"], b["input_pan"])
        mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("space",))
        _JAX[method] = np.asarray(jax_run_spatially_sharded(
            fn, {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return _JAX[method]


@pytest.mark.parametrize("name", FLOAT32)
def test_sharded_matches_jax(spawned, trees, name):
    """The gathered output against JAX's `run_spatially_sharded` of the
    same weights on a mesh of the same shape, at the method's port-vs-JAX
    bound."""
    out, cases = spawned
    case = cases[name]
    got = out[0][name]["whole"]
    want = _jax_sharded(case["method"], trees, case["batch"])
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=JAX_ATOL[case["method"]])


@pytest.mark.parametrize("name", CASES)
def test_sharded_matches_unsharded_port(spawned, name, monkeypatch):
    """The gathered output against the port's unsharded forward of the
    same weights (`apply`, the same switches): UnlgFormer bit-equal,
    MDCUN and INNT within 1e-5; `gather_h` on rank 0 is every rank's
    rows in order."""
    out, cases = spawned
    case = cases[name]
    for k, v in case["env"].items():
        monkeypatch.setenv(k, v)
    port = build_model(case["method"], case["cfg"], device="cpu")
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in case["weights"].items()})
    want = port.apply(case["batch"]).numpy()
    results = [r[name] for r in out]
    got = results[0]["whole"]
    if case["method"] == "UnlgFormer":
        assert np.array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=PORT_ATOL)
    assert np.array_equal(np.concatenate([r["rows"] for r in results],
                                         axis=1), got)
    assert all(r["whole"] is None for r in results[1:])


# the collectives of one forward on every rank: UnlgFormer as level 2
# (11 halos of the unfolding and the prior's resamples; a gather a block)
# but at level 3 a gather an LGB; MDCUN: the PAN's and x's halos, then 3
# a stage (T = 2); INNT: gathers of the LrMS, the features and the fused
# patch-images, halos of the PAN, each InvBlock and Refine, 4 sums an
# InvBlock's F and 4 its H and G share, 1 for the CALayer's mean
def _collectives(name):
    if name == "MDCUN":
        return {"halo": 2 + 3 * T}
    if name.startswith("INNT"):
        return {"gather": 3, "halo": 5, "sum": 25}
    return {"halo": 11, "gather": 3 if name.startswith("UnlgFormer L3")
            else 5}


@pytest.mark.parametrize("name", CASES)
def test_collectives_a_forward(spawned, name):
    """Each rank runs the collectives its forward's halos, gathers and
    sums need, no more, and launches no kernel on the CPU."""
    out, _ = spawned
    for r in out:
        assert r[name]["exchanges"] == _collectives(name)
        assert not any(r[name]["launches"].values())


# ------------------------------------- geometry, collectives emulated

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


class _Ranks:
    """s threads as the ranks of one space group: `spatial.halo_rows`,
    `all_gather_h` and `space_sum` patched to exchange through shared
    slots (every rank runs the same collectives in the same order); sums
    in rank order."""

    def __init__(self, s, monkeypatch):
        self.s, self.slots = s, [None] * s
        self.barrier, self.local = threading.Barrier(s), threading.local()
        monkeypatch.setattr(spatial, "halo_rows", self.halo)
        monkeypatch.setattr(spatial, "all_gather_h", self.gather)
        monkeypatch.setattr(spatial, "space_sum", self.sum)

    def _share(self, t):
        self.barrier.wait()
        self.slots[self.local.j] = t
        self.barrier.wait()
        return list(self.slots)

    def halo(self, x, above, below, mesh, edge):
        if max(above, below) > x.shape[-2]:
            raise ValueError(f"a halo of {max(above, below)} rows "
                             f"(ROADMAP A.9.3)")
        whole = torch.cat(self._share(x), dim=-2)
        return _emulated(whole, mesh.space_rank, self.s, above, below, edge)

    def gather(self, x, mesh, dim=-2):
        return torch.cat(self._share(x), dim=dim)

    def sum(self, t, mesh):
        parts = self._share(t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def run(self, fn):
        """[fn(j, mesh of rank j) for every rank], run together, each
        thread with the caller's intra-op threads (a new thread starts
        with the library's default)."""
        results, errors = [None] * self.s, []
        threads_now = torch.get_num_threads()

        def body(j):
            torch.set_num_threads(threads_now)
            self.local.j = j
            try:
                results[j] = fn(j, Mesh(rank=j, world=self.s,
                                        space_world=self.s))
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(j,))
                   for j in range(self.s)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


def _rows(x, j, s):
    per = x.shape[-2] // s
    return x[..., j * per:(j + 1) * per, :]


def _rand(*shape, seed):
    return torch.rand(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("factor", [4, 2])
@pytest.mark.parametrize("s", [2, 4])
def test_bilinear_rows_are_the_whole_resample(monkeypatch, factor, s):
    """`resample_rows(mode="bilinear")` on a 1-row halo is the rank's
    rows of the whole plane's bilinear resample (MDCUN's x), bit for
    bit; on no halo it is not."""
    x = _rand(2, 3, 16, 12, seed=1)
    want = sample_scale(x, factor, "bilinear")
    got = _Ranks(s, monkeypatch).run(lambda j, mesh: spatial.resample_rows(
        _rows(x, j, s), factor, mesh, mode="bilinear"))
    assert torch.equal(torch.cat(got, dim=-2), want)
    short = sample_scale(_rows(x, 1, s), factor, "bilinear")
    assert not torch.equal(short, _rows(want, 1, s))


@pytest.mark.parametrize("h,big", [(16, 64), (18, 72), (32, 128)])
@pytest.mark.parametrize("s", [2, 4])
def test_align_corners_rows(h, big, s):
    """`bicubic_rows` (INNT's m_hr) from the whole LrMS: each rank's rows
    of `resize_bicubic(align_corners=True)` within ROADMAP C.20's 2e-5,
    also rows reaching 2 beyond the rank's."""
    x = _rand(1, 4, h, h, seed=2)
    want = resize_bicubic(x, (big, big), align_corners=True)
    per = big // s
    for j in range(s):
        lo, hi = max(0, j * per - 2), min(big, (j + 1) * per + 2)
        got = spatial.bicubic_rows(x, (big, big), lo, hi)
        torch.testing.assert_close(got, want[..., lo:hi, :], rtol=0,
                                   atol=2e-5)


def test_quarter_grid_pool_and_nearest_strips(monkeypatch):
    """MDCUN's resamplers on strips: a 3x3 conv, then MaxPool2d(4) cut to
    the 4-row grid, then two convs at 1/4 (one 12-row halo); and 1/4
    rows on a 2-row halo through a conv, nearest x4 and two convs: the
    whole's rows, bit for bit (the same pixels' arithmetic)."""
    torch.manual_seed(3)
    conv = torch.nn.Conv2d(3, 3, 3, padding=1)
    tail = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 3, padding=1),
                               torch.nn.Conv2d(3, 3, 3, padding=1))
    pool, up = torch.nn.MaxPool2d(4), torch.nn.Upsample(scale_factor=4)
    x = _rand(1, 3, 64, 20, seed=4)
    q = _rand(1, 3, 16, 5, seed=5)
    with torch.no_grad():
        want_down = tail(pool(conv(x)))
        want_up = tail(up(conv(q)))

        def run(j, mesh):
            down = spatial.strip_of(_rows(x, j, 4), 12, mesh).chain(conv, 1)
            down = down.rescale(pool).chain(tail, 2).own(mesh)
            upped = spatial.strip_of(_rows(q, j, 4), 2, mesh).chain(conv, 1)
            return down, upped.rescale(up).chain(tail, 2).own(mesh)

        got = _Ranks(4, monkeypatch).run(run)
    assert torch.equal(torch.cat([g[0] for g in got], dim=-2), want_down)
    assert torch.equal(torch.cat([g[1] for g in got], dim=-2), want_up)


@pytest.mark.parametrize("depth,exact", [(4, True), (3, False)])
def test_deep_halo_chain(monkeypatch, depth, exact):
    """One halo of k rows in front of a chain of k 'same' 3x3 convs (each
    zero-padding along H on the strip, as the whole forward does at the
    image's edges): the rank's rows are the whole chain's, bit for bit,
    at k = 4; a halo of 3 is too shallow (the strip refuses rows it does
    not hold, and a chain run anyway is wrong)."""
    torch.manual_seed(6)
    chain = torch.nn.Sequential(*(torch.nn.Conv2d(2, 2, 3, padding=1)
                                  for _ in range(4)))
    x = _rand(1, 2, 32, 16, seed=7)
    with torch.no_grad():
        want = chain(x)
        if exact:
            got = _Ranks(4, monkeypatch).run(
                lambda j, mesh: spatial.strip_of(
                    _rows(x, j, 4), depth, mesh).chain(chain, 4).own(mesh))
            assert torch.equal(torch.cat(got, dim=-2), want)
            return
        with pytest.raises(ValueError, match=r"A\.9\.3"):
            _Ranks(4, monkeypatch).run(
                lambda j, mesh: spatial.strip_of(
                    _rows(x, j, 4), depth, mesh).chain(chain, 4).own(mesh))
        short = chain(_emulated(x, 1, 4, depth, depth, "none"))
        assert not torch.equal(short[..., depth:depth + 8, :],
                               _rows(want, 1, 4))


@pytest.mark.parametrize("depth", [7, 6])
def test_neighborhood_attention_halo(depth):
    """B12's plain version (15x15 window) on a 7-row "none" halo gives
    the whole plane's rows: it zero-pads phi and g outside its input
    (ROADMAP C.12), which the dropped rows alone see (within 1e-6: its
    einsums sum in another order at another H; the kernel is per pixel);
    on 6 rows every rank's border rows miss a neighbour."""
    g = torch.Generator().manual_seed(8)
    x = torch.rand(1, 4, 48, 40, generator=g)
    mats = [torch.rand(4, 4, generator=g) * 0.4 - 0.2 for _ in range(4)]
    want = neighborhood_attention_ref(x, *mats, 15)
    for j in range(4):
        top, _ = spatial.edge_rows(Mesh(rank=j, world=4, space_world=4),
                                   depth, depth, "none")
        out = neighborhood_attention_ref(
            _emulated(x, j, 4, depth, depth, "none"), *mats, 15)
        err = (out[..., top:top + 12, :] - _rows(want, j, 4)).abs().max()
        assert err <= 1e-6 if depth == 7 else err > 1e-3


def test_instance_norm_and_calayer_mean(monkeypatch):
    """The HIN blocks' instance norm from all-reduced sums (two passes)
    and Refine's CALayer mean on the rank's rows: within 1e-6 of the
    whole forward's (the sums run in another order)."""
    torch.manual_seed(9)
    hin = _HINConvBlock(4, 8).eval()
    hin.norm.weight.data.uniform_(0.5, 1.5)
    hin.norm.bias.data.uniform_(-0.2, 0.2)
    refine = Refine(8, 4).eval()
    x = _rand(2, 4, 32, 24, seed=10)
    with torch.no_grad():
        want_hin, want_ref = hin(x), refine(hin(x))

        def run(j, mesh):
            s = spatial.strip_of(_rows(x, j, 4), 2, mesh)
            y, = spatial._hin_rows([(hin, s)], mesh)
            return y.own(mesh), spatial._refine_rows(refine, y.own(mesh),
                                                     mesh)

        got = _Ranks(4, monkeypatch).run(run)
    torch.testing.assert_close(torch.cat([g[0] for g in got], dim=-2),
                               want_hin, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat([g[1] for g in got], dim=-2),
                               want_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,s", [((48, 72), 4), ((64, 64), 4),
                                  ((48, 40), 3)])
def test_innt_shares_and_fold_rows(hw, s, monkeypatch):
    """PatchFusion's scramble: `scrambled_patches` over each rank's share
    of the N = B L patch-images (ragged at 48 x 72: N 54 over 4 ranks)
    is the whole unfold's view, `TransformerFusion` (both routes) on a
    share gives the patch-images' own bits, and `fold_rows` is the whole
    fold's rows bit for bit; `_patch_fusion_rows` over the ranks is the
    whole PatchFusion's rows."""
    from lgteun_tpu_torch.models.innt import PatchFusion

    h, w = hw
    c = 4
    msf, panf = _rand(1, c, h, w, seed=11), _rand(1, c, h, w, seed=12)
    unf = extract_patches(msf, 24, 8, 8)
    length = unf.shape[-1]
    whole = unf.view(length, c, 24, 24)
    per = -(-length // s)
    for j in range(s):
        n0, n1 = min(length, j * per), min(length, (j + 1) * per)
        assert torch.equal(spatial.scrambled_patches(msf, n0, n1),
                           whole[n0:n1])
    fold = fold_patches(unf, (h, w), 24, 8, 8)
    for j in range(s):
        a, b = j * h // s, (j + 1) * h // s
        assert torch.equal(spatial.fold_rows(unf, (h, w), a, b),
                           fold[..., a:b, :])
    for whole_chain in (True, False):
        torch.manual_seed(13)
        pf = PatchFusion(c, whole_chain).eval()
        ref = extract_patches(panf, 24, 8, 8).view(length, c, 24, 24)
        with torch.no_grad():
            fused = pf.fuse(whole, ref)
            for j in range(s):
                n0, n1 = min(length, j * per), min(length, (j + 1) * per)
                assert torch.equal(pf.fuse(whole[n0:n1], ref[n0:n1]),
                                   fused[n0:n1])
            want = pf(msf, panf)
            got = _Ranks(s, monkeypatch).run(
                lambda j, mesh: spatial._patch_fusion_rows(pf, msf, panf,
                                                           mesh))
        assert torch.equal(torch.cat(got, dim=-2), want)


def test_a_share_searched_alone_keeps_its_bits():
    """`TransformerFusion` is a batch of independent patch-images: a
    share searched alone is bit-equal to the same patch-images searched
    with all the others, on both routes (no first-max near tie can flip
    between the sharded and the whole search, ROADMAP C.15)."""
    torch.manual_seed(14)
    lr, ref = _rand(9, 4, 24, 24, seed=15), _rand(9, 4, 24, 24, seed=16)
    for whole_chain in (True, False):
        tf = TransformerFusion(4, whole_chain).eval()
        with torch.no_grad():
            want = tf(lr, ref)
            for n0, n1 in ((0, 3), (3, 7), (7, 9)):
                assert torch.equal(tf(lr[n0:n1], ref[n0:n1]), want[n0:n1])


# ---------------------------------------------------------------- refusals

def _method(model_type, monkeypatch, env=None, **model_cfg):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    cfg = Config(model_type=model_type, ms_chans=BANDS,
                 model_cfg={"core_module": model_cfg} if model_cfg else {})
    method = build_model(model_type, cfg, device="cpu")
    method.init_params(torch.Generator().manual_seed(0))
    return method.eval()


def bf16_step(a):
    """Each value of a non-negative float32 array moved to the next
    bfloat16 value above its own rounding (the cast's input rounding)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return (t.view(torch.int16) + 1).view(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("model_type", ["MDCUN", "INNT"])
def test_runs_the_blanket_bf16_cast_sharded(model_type, monkeypatch):
    """MDCUN and INNT under LGTEUN_EVAL_DTYPE=bf16 (the zoo's blanket
    cast) on two ranks run as threads, inside the cast's context: within
    1.5x of the whole cast forward's own spread at a one-bf16-step input
    change (INNT's instance norms and CALayer mean come from float32
    partial sums, rounded once; MDCUN's bf16 convs on strips may sum in
    another order; the spawned ranks of tests/test_torch_port_spatial_
    rest.py hold MDCUN to the bits)."""
    small = {"mid_channels": MID, "T": T} if model_type == "MDCUN" else {}
    method = _method(model_type, monkeypatch, {"LGTEUN_EVAL_DTYPE": "bf16"},
                     **small)
    batch = _batch(0)
    rows = _Ranks(2, monkeypatch).run(
        lambda j, mesh: spatial.run_spatially_sharded(method, batch, mesh))
    got, want = torch.cat(rows, dim=1), method.apply(batch)
    assert got.dtype == torch.float32
    moved = method.apply({k: bf16_step(v) for k, v in batch.items()})
    assert (got - want).abs().mean() <= 1.5 * (moved - want).abs().mean()


def test_refuses_mdcun_strips_shallower_than_its_halo(monkeypatch):
    """MDCUN's PAN halo is 16 rows: strips of 8 PAN rows a rank (pan 32
    on 4 ranks) are refused, not gathered."""
    method = _method("MDCUN", monkeypatch, mid_channels=MID, T=T)
    batch = {"input_lr": np.zeros((1, 8, 8, BANDS), np.float32),
             "input_pan": np.zeros((1, 32, 32, 1), np.float32)}
    with pytest.raises(ValueError, match=r"halo of 16 rows.*A\.9\.3"):
        spatial.run_spatially_sharded(method, batch,
                                      Mesh(rank=0, world=4, space_world=4))
