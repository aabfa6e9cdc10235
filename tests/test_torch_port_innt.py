"""The port's INNT slice (plain PyTorch path, CPU) vs the JAX package.

The texture-match and patch-match searches, patch extraction and fold,
the align_corners bicubic, the shared building blocks and the whole
GPPNNINNT on both routes, and the weight converter, on float32 inputs
made with numpy from a seed. The CUDA kernels themselves are held
against `texture_match_ref` / `patch_match_ref` on the card by
`chip_smoke.py`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgteun_tpu.convert import convert_state_dict
from lgteun_tpu.models.common.inv_blocks import InvertibleConv1x1 as JaxInv
from lgteun_tpu.models.common.refine import Refine as JaxRefine
from lgteun_tpu.models.innt import GPPNNINNT as JaxINNT
from lgteun_tpu.models.mutinf import _HINConvBlock as JaxHIN
from lgteun_tpu.ops import patches as jax_patches
from lgteun_tpu.ops import resize as jax_resize
from lgteun_tpu.ops.patch_match_kernel import _fused_pm_impl, patch_match_xla
from lgteun_tpu.ops.texture_match_kernel import (_fused_tm_impl,
                                                 texture_match_xla)
from lgteun_tpu_torch.config import Config as PortConfig
from lgteun_tpu_torch.convert.from_jax import innt_from_flax
from lgteun_tpu_torch.models.common.inv_blocks import InvertibleConv1x1
from lgteun_tpu_torch.models.common.refine import Refine
from lgteun_tpu_torch.models.mutinf import _HINConvBlock
from lgteun_tpu_torch.ops.patch_match_kernel import patch_match_ref
from lgteun_tpu_torch.ops.patches import extract_patches, fold_patches
from lgteun_tpu_torch.ops.resize import resize_bicubic
from lgteun_tpu_torch.ops.texture_match_kernel import texture_match_ref
from lgteun_tpu_torch.registry import build_model


def f32(rng, *shape, scale=1.0):
    """float32 explicitly: conftest turns on jax_enable_x64."""
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def _tm_check(lr, ref, side):
    """texture_match_ref vs texture_match_xla and the Pallas kernel in
    interpret mode: s within 1e-5, t within 2e-4 (the kernel's hilo
    transfer), as tests/test_texture_match.py holds them."""
    t_got, s_got = (v.numpy() for v in texture_match_ref(
        torch.from_numpy(lr), torch.from_numpy(ref)))
    assert t_got.shape == lr.shape and s_got.shape == (lr.shape[0],
                                                        side * side)
    jlr, jref = jnp.asarray(lr), jnp.asarray(ref)
    for t_want, s_want in (texture_match_xla(jlr, jref, side),
                           _fused_tm_impl(jlr, jref, interpret=True)):
        np.testing.assert_allclose(s_got, np.asarray(s_want), atol=1e-5)
        np.testing.assert_allclose(t_got, np.asarray(t_want), atol=2e-4,
                                   rtol=2e-4)
    return t_got


@pytest.mark.parametrize("side,c,n", [(8, 4, 8), (24, 4, 2), (8, 6, 4)])
def test_texture_match_matches_jax(side, c, n):
    rng = np.random.default_rng(side * 10 + c)
    _tm_check(f32(rng, n, c, side * side), f32(rng, n, c, side * side), side)


def test_texture_match_exact_ties():
    """A constant ref makes every interior ref sub-patch identical, so R
    has exact ties; the first maximum is taken and no tied sub-patches
    are summed: each output value is k * 0.37 / 9 for k <= 9 of its
    nine transferred taps inside the image."""
    side, c, n = 8, 4, 3
    lr = f32(np.random.default_rng(3), n, c, side * side)
    ref = np.full((n, c, side * side), 0.37, np.float32)
    taps = _tm_check(lr, ref, side) * 9 / 0.37
    np.testing.assert_allclose(taps, np.round(taps), atol=1e-4)
    assert taps.max() <= 9 + 1e-4


def _pm_inputs(rng, n=4, ll=64, kk=36):
    """As tests/test_patch_match.py makes them."""
    lr, ref = f32(rng, n, ll, kk), f32(rng, n, ll, kk)
    lr_n = lr / np.linalg.norm(lr, axis=2, keepdims=True)
    ref_n = ref / np.linalg.norm(ref, axis=2, keepdims=True)
    return lr_n.astype(np.float32), ref_n.astype(np.float32), \
        f32(rng, n, kk, ll)


@pytest.mark.parametrize("case", ["random", "duplicate_rows",
                                  "all_rows_identical", "large_magnitude"])
def test_patch_match_matches_jax(case):
    """patch_match_ref vs patch_match_xla and the Pallas kernel in
    interpret mode, with the tie cases of tests/test_patch_match.py:
    rows 3 and 5 equal; all ref rows equal (T = ref_u[:, :, 0]
    everywhere); all ref rows equal to query 0 (ties at R = 1)."""
    rng = np.random.default_rng(33)
    lr_n, ref_n, ref_u = _pm_inputs(rng, n=4 if case == "random" else 2)
    if case == "duplicate_rows":
        ref_n[:, 5] = ref_n[:, 3]
    elif case == "all_rows_identical":
        ref_n = np.ascontiguousarray(np.broadcast_to(ref_n[:, :1],
                                                     ref_n.shape))
    elif case == "large_magnitude":
        ref_n = np.ascontiguousarray(np.broadcast_to(lr_n[:, :1],
                                                     ref_n.shape))
    t_got, s_got = (v.numpy() for v in patch_match_ref(
        *map(torch.from_numpy, (lr_n, ref_n, ref_u))))
    args = [jnp.asarray(a) for a in (lr_n, ref_n, ref_u)]
    for t_want, s_want in (patch_match_xla(*args),
                           _fused_pm_impl(*args, interpret=True)):
        np.testing.assert_allclose(s_got, np.asarray(s_want), atol=1e-5)
        np.testing.assert_allclose(t_got, np.asarray(t_want), atol=1e-6)
    if case != "random":
        first = np.argmax(np.einsum("nik,njk->nij", ref_n, lr_n), axis=1)
        np.testing.assert_array_equal(
            t_got, np.take_along_axis(ref_u, first[:, None, :], axis=2))
    if case == "all_rows_identical":
        np.testing.assert_array_equal(
            t_got, np.broadcast_to(ref_u[:, :, :1], t_got.shape))


@pytest.mark.parametrize("hw,c,k,s,p", [(64, 4, 24, 8, 8), (24, 4, 3, 1, 1)])
def test_patches_match_jax(hw, c, k, s, p):
    """F.unfold / F.fold vs the JAX package's extract_patches and its
    blocked fold (same layout up to the [L, CKK] transpose)."""
    rng = np.random.default_rng(k)
    x = f32(rng, 2, c, hw, hw)
    got = extract_patches(torch.from_numpy(x), k, s, p).numpy()
    want = jax_patches.extract_patches(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       k, s, p)
    assert max_err(got, np.asarray(want).transpose(0, 2, 1)) <= 1e-6
    cols = f32(rng, *got.shape)
    got = fold_patches(torch.from_numpy(cols), (hw, hw), k, s, p).numpy()
    want = jax_patches.fold_patches(jnp.asarray(cols.transpose(0, 2, 1)),
                                    (hw, hw), c, k, s, p)
    assert max_err(got, np.asarray(want).transpose(0, 3, 1, 2)) <= 1e-6


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-6),
                                         (torch.float32, 2e-5)])
def test_resize_bicubic_align_corners_matches_jax(dtype, bound):
    """INNT's MS upsample, 32 -> 128 with align_corners=True, vs the
    JAX resize matrices (tap weights in float64) at unit-scale inputs.
    In float64, F.interpolate gives the same taps: <= 1e-6 (the JAX
    result's own float32 rounding). In float32 it computes the tap
    weights of the fractions j * 31/127 in float32, which moves the
    output by up to about 1e-5 (9.2e-6 here): bound 2e-5."""
    x = f32(np.random.default_rng(32), 2, 3, 32, 32)
    got = resize_bicubic(torch.from_numpy(x).to(dtype), (128, 128),
                         align_corners=True).numpy()
    want = jax_resize.resize_bicubic(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                     (128, 128), align_corners=True)
    assert max_err(got, np.asarray(want).transpose(0, 3, 1, 2)) <= bound


def _fill(tree, seed):
    """A flax tree of shapes filled from numpy: conv kernels
    U(+-1/sqrt(fan_in)), instance-norm scales 1 + U(+-0.1), the LU
    factors of a random orthogonal matrix (the permutation is a real
    one), other leaves U(+-0.1)."""
    import scipy.linalg

    rng = np.random.default_rng(seed)
    lus = {}

    def fill(path, leaf):
        keys = tuple(p.key for p in path)
        name, shape = keys[-1], leaf.shape
        if keys[-2:-1] == ("lu",):
            if keys[:-1] not in lus:
                q = np.linalg.qr(rng.standard_normal(shape[:1] * 2))[0]
                lus[keys[:-1]] = scipy.linalg.lu(q)
            p, l, u = lus[keys[:-1]]
            s = np.diag(u)
            v = {"frozen_p": p, "frozen_sign_s": np.sign(s), "l": l,
                 "log_s": np.log(np.abs(s)) + rng.uniform(-0.1, 0.1, s.shape),
                 "u": np.triu(u, 1)}[name]
        elif len(shape) == 4:
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "in_gamma":
            v = 1 + rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _hwio(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def _conv_sd(prefix, node):
    return {f"{prefix}.weight": _hwio(node["kernel"]),
            f"{prefix}.bias": torch.from_numpy(np.asarray(node["bias"]))}


def _invconv_case(c):
    lu = lambda tree: {k.replace("frozen_", ""): torch.from_numpy(v)
                       for k, v in tree["lu"].items()}
    return JaxInv(c), InvertibleConv1x1(c), lu


def _hin_case(c):
    def sd(tree):
        out = {"norm.weight": torch.from_numpy(tree["in_gamma"]),
               "norm.bias": torch.from_numpy(tree["in_beta"])}
        for leaf in ("identity", "conv_1", "conv_2"):
            out.update(_conv_sd(leaf, tree[leaf]["Conv_0"]))
        return out
    return JaxHIN(16), _HINConvBlock(c, 16), sd


def _refine_case(c):
    def sd(tree):
        out = {}
        for t_leaf, f_leaf in (("conv_in", "conv_in"),
                               ("conv_last", "conv_last"),
                               ("process.0.process.0", "ca_0/process0"),
                               ("process.0.process.2", "ca_0/process1"),
                               ("process.0.conv_du.0", "ca_0/du0"),
                               ("process.0.conv_du.2", "ca_0/du1")):
            node = tree
            for part in f_leaf.split("/"):
                node = node[part]
            out.update(_conv_sd(t_leaf, node["Conv_0"]))
        return out
    return JaxRefine(4), Refine(c, 4), sd


@pytest.mark.parametrize("case", [_invconv_case, _hin_case, _refine_case],
                         ids=["invconv", "hin_block", "refine"])
def test_block_matches_flax(case):
    """InvertibleConv1x1, _HINConvBlock and Refine vs flax with the
    weights carried across: <= 1e-5."""
    c = 8
    flax_mod, port_mod, to_sd = case(c)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 16, 16, c)).astype(np.float32)
    tree = _fill(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"], seed=9)
    want = flax_mod.apply({"params": jax.tree.map(jnp.asarray, tree)},
                          jnp.asarray(x))
    port_mod.load_state_dict(to_sd(tree), strict=True)
    with torch.no_grad():
        got = port_mod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert max_err(got.numpy().transpose(0, 2, 3, 1), want) <= 1e-5


@functools.lru_cache(maxsize=None)
def _innt_shapes(c):
    return jax.eval_shape(JaxINNT(ms_chans=c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, c)),
                          jnp.zeros((1, 64, 64, 1)))["params"]


def _cfg(c):
    return PortConfig(model_type="INNT", ms_chans=c)


def _port(c, tree, whole_chain, monkeypatch):
    monkeypatch.setenv("LGTEUN_FUSED_TM", "1" if whole_chain else "0")
    port = build_model("INNT", _cfg(c), device="cpu")
    assert port.module.transform_fusion.fuse.whole_chain is whole_chain
    port.load_state_dict(innt_from_flax(tree), strict=True)
    return port


@functools.lru_cache(maxsize=None)
def _innt_case(c):
    """(flax tree, batch, the JAX module's output) at MS 16 / PAN 64."""
    tree = _fill(_innt_shapes(c), seed=c)
    rng = np.random.default_rng(40 + c)
    batch = {"input_lr": rng.uniform(0, 1, (1, 16, 16, c)).astype(np.float32),
             "input_pan": rng.uniform(0, 1, (1, 64, 64, 1)).astype(
                 np.float32)}
    want = JaxINNT(ms_chans=c).apply(
        {"params": jax.tree.map(jnp.asarray, tree)},
        jnp.asarray(batch["input_lr"]), jnp.asarray(batch["input_pan"]))
    return tree, batch, np.asarray(want)


@pytest.mark.parametrize("whole_chain", [True, False],
                         ids=["texture_match", "patch_match"])
@pytest.mark.parametrize("c", [4, 8])
def test_innt_matches_flax(c, whole_chain, monkeypatch):
    """TorchMethod.apply vs flax GPPNNINNT.apply (its XLA chain on the
    CPU) on both routes of the texture transformer: <= 5e-4 max-abs,
    the bound tests/test_torch_parity.py holds JAX to against the
    reference."""
    tree, batch, want = _innt_case(c)
    got = _port(c, tree, whole_chain, monkeypatch).apply(batch).numpy()
    assert got.shape == (1, 64, 64, c) and np.isfinite(got).all()
    assert max_err(got, want) <= 5e-4


@pytest.mark.parametrize("c", [4, 8])
def test_innt_roundtrip_is_exact_and_loads_strict(c, monkeypatch):
    """innt_from_flax -> convert_state_dict gives the tree back bit for
    bit, and the state_dict is the port's whole key set (buffers p and
    sign_s included)."""
    tree = _fill(_innt_shapes(c), seed=c + 1)
    sd = innt_from_flax(tree)
    port = _port(c, tree, True, monkeypatch)
    assert set(port.module.state_dict()) == set(sd)
    assert "extract.operations.2.invconv.p" in sd
    assert "transform_fusion.fuse.conv_trans.2.bias" in sd
    back = convert_state_dict("INNT", {k: v.numpy() for k, v in sd.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def test_innt_param_count_matches_flax():
    """At 8 bands the port's parameters (buffers excluded) are the flax
    tree's leaves less the frozen permutation and signs."""
    leaves = jax.tree_util.tree_leaves_with_path(_innt_shapes(8))
    want = sum(int(np.prod(leaf.shape)) for path, leaf in leaves
               if not path[-1].key.startswith("frozen_"))
    port = build_model("INNT", _cfg(8), device="cpu")
    assert port.param_count() == want
    assert sum(b.numel() for b in port.module.buffers()) == 3 * (8 * 8 + 8)


def test_innt_seeded_init_is_orthogonal_and_finite():
    """init_params fills the invconv buffers too: w = P L U is the
    orthogonal draw, and a forward is finite."""
    port = build_model("INNT", _cfg(4), device="cpu")
    port.init_params(torch.Generator().manual_seed(0))
    for op in port.module.extract.operations:
        w = op.invconv.weight().detach()
        assert torch.allclose(w @ w.T, torch.eye(8), atol=1e-5)
        assert set(op.invconv.sign_s.abs().tolist()) == {1.0}
    rng = np.random.default_rng(1)
    out = port.apply({"input_lr": rng.uniform(0, 1, (1, 8, 8, 4)),
                      "input_pan": rng.uniform(0, 1, (1, 32, 32, 1))})
    assert out.shape == (1, 32, 32, 4) and torch.isfinite(out).all()


def test_unknown_innt_flax_key_is_refused():
    tree = _fill(_innt_shapes(4), seed=0)
    tree = {**tree, "extra": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        innt_from_flax(tree)
