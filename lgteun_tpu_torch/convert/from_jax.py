"""JAX (flax) params -> the port's reference-keyed state_dicts.

Each converter is the exact inverse of its counterpart in
`lgteun_tpu/convert/torch_import.py` (which maps reference torch keys
onto the flax tree): `lgteun_from_flax` of `convert_lgteun`,
`lightnet_from_flax` of `convert_lightnet`, `mdcun_from_flax` of
`convert_mdcun` and `innt_from_flax` of `convert_innt`, so e.g. `convert_state_dict("UnlgFormer",
lgteun_from_flax(tree))` gives `tree` back bit for bit. Layouts:

- conv kernels: flax HWIO [kh, kw, in/g, out] -> torch OIHW
- pos_emb: flax [heads, S, S] -> torch [1, heads, S, S]
- amp_scale / pha_scale: flax [1, 1, 1, C] -> torch [C, 1, 1, 1]
  (the reference's 1x1 depthwise convs; the generic kernel rule)
- the fused-FFN raw params (w1 [C, 4C], dw [3, 3, 1, 4C], ...) and
  MDCUN's non-local projections ([1, 1, C, C]) are HWIO kernels too
- MDCUN's scalars and PReLU slopes: flax [] -> torch [1]
- INNT's invertible 1x1 convs: the flax `lu` leaves, with the buffers
  under `frozen_*`, -> `invconv.{p, sign_s, l, log_s, u}` as they are

Takes the flax `core_module` tree as nested dicts of numpy arrays (no jax
import); returns {key: float32 torch.Tensor}.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lgteun_from_flax", "lightnet_from_flax", "mdcun_from_flax",
           "innt_from_flax"]


def _hwio(k) -> np.ndarray:
    """flax [kh, kw, in/g, out] -> torch [out, in/g, kh, kw]."""
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _ident(v) -> np.ndarray:
    return np.asarray(v)


def _one(v) -> np.ndarray:
    """A flax scalar [] -> torch's one-value [1]."""
    return np.asarray(v).reshape(1)


def _flat(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/leaf": array}."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = node
    return out


def _from_table(tree: dict, table: dict, name: str) -> dict:
    """Map every flax leaf through `table` {flax path: (torch keys,
    transform)}; a leaf the table lacks is refused."""
    out = {}
    for path, val in _flat(tree).items():
        if path not in table:
            raise KeyError(f"unmapped {name} key: {path}")
        keys, tf = table[path]
        for key in keys:
            out[key] = tf(val)
    return out


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def _conv(out: dict, t_prefix: str, node: dict) -> None:
    """A flax Conv leaf pair {kernel, bias} -> weight/bias."""
    out[f"{t_prefix}.weight"] = _hwio(node["kernel"])
    out[f"{t_prefix}.bias"] = _ident(node["bias"])


def _lgb(out: dict, t_prefix: str, tree: dict) -> None:
    """flax LGB (norm_mix_j, mixer_j, ffn_j) -> reference LGB keys."""
    n = sum(1 for k in tree if k.startswith("norm_mix_"))
    if set(tree) != {f"{p}_{j}" for j in range(n)
                     for p in ("norm_mix", "mixer", "ffn")}:
        raise KeyError(f"unexpected LGB keys under {t_prefix}: {sorted(tree)}")
    for j in range(n):
        mix = f"{t_prefix}.blocks.{j}.0.fn"
        norm = tree[f"norm_mix_{j}"]
        out[f"{mix}.norm.weight"] = _ident(norm["scale"])
        out[f"{mix}.norm.bias"] = _ident(norm["bias"])
        loc = tree[f"mixer_{j}"]["local"]
        out[f"{mix}.fn.local_mixer.pos_emb"] = np.asarray(loc["pos_emb"])[None]
        out[f"{mix}.fn.local_mixer.to_qkv.weight"] = _hwio(loc["to_qkv_kernel"])
        out[f"{mix}.fn.local_mixer.to_qkv.bias"] = _ident(loc["to_qkv_bias"])
        glo = tree[f"mixer_{j}"]["global"]
        for t_name, f_name in (("conv_amp", "amp"), ("conv_pha", "pha")):
            out[f"{mix}.fn.global_mixer.{t_name}.0.weight"] = _hwio(
                glo[f"{f_name}_scale"])
            out[f"{mix}.fn.global_mixer.{t_name}.0.bias"] = _ident(
                glo[f"{f_name}_bias"])
        _conv(out, f"{mix}.fn.proj", tree[f"mixer_{j}"]["proj"]["Conv_0"]["Conv_0"])
        ffn = f"{t_prefix}.blocks.{j}.1.fn"
        f = tree[f"ffn_{j}"]
        table = {"norm.weight": ("ln_gamma", _ident),
                 "norm.bias": ("ln_beta", _ident),
                 "fn.net.0.weight": ("w1", _hwio),
                 "fn.net.0.bias": ("b1", _ident),
                 "fn.net.2.point_conv.weight": ("w2", _hwio),
                 "fn.net.2.point_conv.bias": ("b2", _ident),
                 "fn.net.2.depth_conv.weight": ("dw", _hwio),
                 "fn.net.2.depth_conv.bias": ("bdw", _ident),
                 "fn.net.4.weight": ("w3", _hwio),
                 "fn.net.4.bias": ("b3", _ident)}
        for t_key, (f_key, tf) in table.items():
            out[f"{ffn}.{t_key}"] = tf(f[f_key])


def _lgt(out: dict, t_prefix: str, tree: dict) -> None:
    """flax LGT -> reference LGT keys (reference LGT.py:251-344)."""
    seen = set()

    def take(name):
        seen.add(name)
        return tree[name]

    _conv(out, f"{t_prefix}.patch_embed.proj.0", take("patch_dw")["Conv_0"])
    _conv(out, f"{t_prefix}.patch_embed.proj.1",
          take("patch_pw")["Conv_0"]["Conv_0"])
    ln = take("patch_norm_ln")
    out[f"{t_prefix}.patch_embed.norm.weight"] = _ident(ln["scale"])
    out[f"{t_prefix}.patch_embed.norm.bias"] = _ident(ln["bias"])
    _conv(out, f"{t_prefix}.tail.1", take("tail")["Conv_0"]["Conv_0"])
    _lgb(out, f"{t_prefix}.bottleneck", take("bottleneck"))
    n_scale = sum(1 for k in tree if k.startswith("enc_lgb_"))
    for i in range(n_scale):
        enc = f"{t_prefix}.encoder_layers.{i}"
        _lgb(out, f"{enc}.0", take(f"enc_lgb_{i}"))
        _conv(out, f"{enc}.1.1", take(f"enc_down_{i}")["Conv_0"]["Conv_0"])
        dec = f"{t_prefix}.decoder_layers.{i}"
        _conv(out, f"{dec}.0.1", take(f"dec_up_{i}")["Conv_0"]["Conv_0"])
        _conv(out, f"{dec}.1", take(f"dec_fuse_{i}")["Conv_0"]["Conv_0"])
        _lgb(out, f"{dec}.2", take(f"dec_lgb_{i}"))
    if seen != set(tree):
        raise KeyError(f"unmapped LGT keys under {t_prefix}: "
                       f"{sorted(set(tree) - seen)}")


def lgteun_from_flax(params: dict) -> dict:
    """flax LGTEUN `core_module` tree -> reference-keyed state_dict of
    float32 tensors (the inverse of `convert_lgteun`)."""
    out: dict = {}
    for key, node in params.items():
        if key in ("D", "DT"):
            _conv(out, f"{key}.1", node["dw0"]["Conv_0"]["Conv_0"])
            _conv(out, f"{key}.3", node["dw1"]["Conv_0"]["Conv_0"])
        elif key in ("R", "RT"):
            _conv(out, key, node["Conv_0"]["Conv_0"])
        elif key.startswith("eta_"):
            out[f"eta.{key[4:]}"] = _ident(node)
        elif key.startswith("prior_"):
            _lgt(out, f"prior_module.{key[6:]}", node)
        else:
            raise KeyError(f"unmapped LGTEUN key: {key}")
    return _tensors(out)


def _conv_rows(t_prefix: str, f_prefix: str, *aliases: str) -> dict:
    """Table rows of a flax Conv leaf pair under `f_prefix` (kernel,
    optional bias) -> `t_prefix` and any aliases of it."""
    keys = (t_prefix, *aliases)
    return {f"{f_prefix}/kernel": ([f"{k}.weight" for k in keys], _hwio),
            f"{f_prefix}/bias": ([f"{k}.bias" for k in keys], _ident)}


def lightnet_from_flax(params: dict) -> dict:
    """flax LightNetModule tree -> reference-keyed state_dict of float32
    tensors (the inverse of `convert_lightnet`)."""
    seq = {"head0": "head_conv.0", "head1": "head_conv.1",
           "head2": "head_conv.2", "belly0/conv1": "belly_conv.0.conv1",
           "belly0/conv2": "belly_conv.0.conv2",
           "belly1/conv1": "belly_conv.1.conv1",
           "belly1/conv2": "belly_conv.1.conv2", "tail0": "tail_conv.0",
           "tail1": "tail_conv.1", "tail2": "tail_conv.2"}
    branch = {"pw1": "point_wise_1", "dw1": "depth_wise_1",
              "pw2": "point_wise_2", "dw2": "depth_wise_2"}
    table = {}
    for f_span, t_span in seq.items():
        for f_leaf, t_leaf in branch.items():
            table.update(_conv_rows(f"{t_span}.{t_leaf}",
                                    f"{f_span}/{f_leaf}"))
    return _tensors(_from_table(params, table, "lightnet"))


def mdcun_from_flax(params: dict, seed: int = 0) -> dict:
    """flax PanUnfolding tree -> reference-keyed state_dict of float32
    tensors (the inverse of `convert_mdcun`).

    Fills the reference keys that have no flax leaf: each ResnetBlock's
    aliases (`layers.0`/`layers.2` = conv1/conv2, `layers.1`/`layers.3`
    = act) get the same arrays, and a 4-band model's `conv1x1`, which
    the reference creates but never runs, gets values drawn from
    `seed` (torch-default bounds); `convert_mdcun` drops them again."""
    stages = sum(1 for k in params if k.startswith("u_"))
    ms_chans = np.asarray(params["nl"]["t"]).shape[-1]
    table = {}
    for t_leaf, f_leaf in (("conv_up.body.0", "conv_up/body"),
                           ("conv_up.tail.1", "conv_up/tail0"),
                           ("conv_up.tail.2", "conv_up/tail1"),
                           ("conv_down.body.0", "conv_down/body"),
                           ("conv_down.tail.1", "conv_down/tail0"),
                           ("conv_down.tail.2", "conv_down/tail1"),
                           ("hf_pan", "hf_pan"), ("conv1x1", "conv1x1")):
        table.update(_conv_rows(t_leaf, f"{f_leaf}/Conv_0"))
    for i in range(stages):
        for j in range(2):
            table.update(_conv_rows(f"conv_u.{i}.{j}",
                                    f"conv_u_{i}_{j}/Conv_0"))
        for nm in ("u", "eta", "gama", "delta"):
            table[f"{nm}_{i}"] = ([f"{nm}.{i}"], _one)
    table.update(_conv_rows("rm1.block.0.conv", "rm1/head/Conv_0"))
    table["rm1/head_act/alpha"] = (["rm1.block.0.act.weight"], _one)
    for i in range(3):
        t_res, f_res = f"rm1.block.{i + 1}", f"rm1/res_{i}"
        table.update(_conv_rows(f"{t_res}.conv1", f"{f_res}/conv1/Conv_0",
                                f"{t_res}.layers.0"))
        table.update(_conv_rows(f"{t_res}.conv2", f"{f_res}/conv2/Conv_0",
                                f"{t_res}.layers.2"))
        table[f"{f_res}/act/alpha"] = ([f"{t_res}.act.weight",
                                        f"{t_res}.layers.1.weight",
                                        f"{t_res}.layers.3.weight"], _one)
    table.update(_conv_rows("rm1.spatial.conv", "rm1/spatial/Conv_0"))
    table["rm1/spatial_act/alpha"] = (["rm1.spatial.act.weight"], _one)
    for nm in ("t", "p", "g", "w"):
        table[f"nl/{nm}"] = ([f"NLBlock.{nm}.weight"], _hwio)
    out = _from_table(params, table, "MDCUN")
    if "conv1x1" not in params:
        rng = np.random.default_rng(seed)
        out["conv1x1.weight"] = rng.uniform(-0.5, 0.5, (ms_chans, 4, 1, 1))
        out["conv1x1.bias"] = rng.uniform(-0.5, 0.5, (ms_chans,))
    return _tensors(out)


def innt_from_flax(params: dict) -> dict:
    """flax GPPNNINNT tree -> reference-keyed state_dict of float32
    tensors (the inverse of `convert_innt`)."""
    table = {}
    for t_leaf, f_leaf in (("conv_process.convms", "convms"),
                           ("conv_process.convpan", "convpan"),
                           ("conv_fusion.conv", "conv_fusion"),
                           ("transform_fusion.fuse.conv_trans.0",
                            "transform_fusion/fuse/trans0"),
                           ("transform_fusion.fuse.conv_trans.2",
                            "transform_fusion/fuse/trans1"),
                           ("extract.fuse", "extract_fuse"),
                           ("refine.conv_in", "refine/conv_in"),
                           ("refine.conv_last", "refine/conv_last"),
                           ("refine.process.0.process.0",
                            "refine/ca_0/process0"),
                           ("refine.process.0.process.2",
                            "refine/ca_0/process1"),
                           ("refine.process.0.conv_du.0", "refine/ca_0/du0"),
                           ("refine.process.0.conv_du.2", "refine/ca_0/du1")):
        table.update(_conv_rows(t_leaf, f"{f_leaf}/Conv_0"))
    blocks = sum(1 for k in params if k.startswith("inv_"))
    for i in range(blocks):
        t_op, f_op = f"extract.operations.{i}", f"inv_{i}"
        for f_leaf, t_leaf in (("frozen_p", "p"), ("frozen_sign_s", "sign_s"),
                               ("l", "l"), ("log_s", "log_s"), ("u", "u")):
            table[f"{f_op}/invconv/lu/{f_leaf}"] = (
                [f"{t_op}.invconv.{t_leaf}"], _ident)
        for sub in ("F", "G", "H"):
            for blk in ("conv1", "conv2"):
                t_hin, f_hin = f"{t_op}.{sub}.{blk}", f"{f_op}/{sub}/{blk}"
                for leaf in ("identity", "conv_1", "conv_2"):
                    table.update(_conv_rows(f"{t_hin}.{leaf}",
                                            f"{f_hin}/{leaf}/Conv_0"))
                table[f"{f_hin}/in_gamma"] = ([f"{t_hin}.norm.weight"], _ident)
                table[f"{f_hin}/in_beta"] = ([f"{t_hin}.norm.bias"], _ident)
    return _tensors(_from_table(params, table, "INNT"))
