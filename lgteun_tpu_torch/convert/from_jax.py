"""JAX (flax) params -> the port's reference-keyed state_dicts.

Each converter is the exact inverse of its counterpart in
`lgteun_tpu/convert/torch_import.py` (which maps reference torch keys
onto the flax tree): `lgteun_from_flax` of `convert_lgteun`,
`lightnet_from_flax` of `convert_lightnet`, `mdcun_from_flax` of
`convert_mdcun`, `innt_from_flax` of `convert_innt`, `panformer_from_flax`
of `convert_panformer`, `sfiin_from_flax` of `convert_sfiin` and
`mutinf_from_flax` of `convert_mutinf`, so e.g.
`convert_state_dict("UnlgFormer", lgteun_from_flax(tree))` gives `tree`
back bit for bit. Layouts:

- conv kernels: flax HWIO [kh, kw, in/g, out] -> torch OIHW
- pos_emb: flax [heads, S, S] -> torch [1, heads, S, S]
- amp_scale / pha_scale: flax [1, 1, 1, C] -> torch [C, 1, 1, 1]
  (the reference's 1x1 depthwise convs; the generic kernel rule)
- the fused-FFN raw params (w1 [C, 4C], dw [3, 3, 1, 4C], ...) and
  MDCUN's non-local projections ([1, 1, C, C]) are HWIO kernels too
- MDCUN's scalars and PReLU slopes: flax [] -> torch [1]
- the invertible 1x1 convs (INNT, SFIIN, MutInf): the flax `lu` leaves,
  with the buffers under `frozen_*`, -> `invconv.{p, sign_s, l, log_s,
  u}` as they are
- PanFormer's Dense kernels: flax [in, out] -> torch Linear [out, in];
  MutInf's CDC taps: flax [1, 5, in, out] -> torch [out, in, 1, 5] (the
  generic kernel rule)

`mi_from_flax` carries MutInf's second module, the flax `MutualInfoReg`
tree (JAX `params["mi"]`), to the port's `losses.MutualInfoReg`. It is
not the inverse of `convert_mutual_info`: the JAX module flattens its
encoder output in (h, w, c) order where the reference and the port
flatten (c, h, w) (ROADMAP C.34), so the carry permutes the rows of each
Dense kernel to (c, h, w) before the transpose, and the port computes
with the carried weights what JAX computes with the tree.

`discriminator_from_flax` carries the adversarial discriminator (JAX
`params["discriminator"]`: a Pixel-, Patch- or VGGDiscriminator tree) to
`models/common/discriminators.py`: conv kernels HWIO -> OIHW, the
instance norms' `scale` -> `weight`, and a VGG's Dense kernels [in, out]
-> Linear [out, in], fc0's rows permuted from the NHWC flatten (h, w, c)
of the JAX module to the port's (c, h, w) (ROADMAP C.42), as
`mi_from_flax` does.

Takes the flax `core_module` tree (or `mi` / `discriminator` tree) as
nested dicts of numpy arrays (no jax import); returns {key: float32
torch.Tensor}.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["lgteun_from_flax", "lightnet_from_flax", "mdcun_from_flax",
           "innt_from_flax", "panformer_from_flax", "sfiin_from_flax",
           "mutinf_from_flax", "mi_from_flax", "discriminator_from_flax"]


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


def _lu_rows(t_prefix: str, f_prefix: str) -> dict:
    """An InvertibleConv1x1's `lu` leaves -> its buffers and parameters."""
    return {f"{f_prefix}/lu/{f_leaf}": ([f"{t_prefix}.{t_leaf}"], _ident)
            for f_leaf, t_leaf in (("frozen_p", "p"),
                                   ("frozen_sign_s", "sign_s"), ("l", "l"),
                                   ("log_s", "log_s"), ("u", "u"))}


def _hin_rows(t_prefix: str, f_prefix: str) -> dict:
    """A HIN conv block (INNT, MutInf)."""
    table = {}
    for leaf in ("identity", "conv_1", "conv_2"):
        table.update(_conv_rows(f"{t_prefix}.{leaf}",
                                f"{f_prefix}/{leaf}/Conv_0"))
    table[f"{f_prefix}/in_gamma"] = ([f"{t_prefix}.norm.weight"], _ident)
    table[f"{f_prefix}/in_beta"] = ([f"{t_prefix}.norm.bias"], _ident)
    return table


def _refine_rows(t_prefix: str, f_prefix: str, n_ca: int) -> dict:
    table = {}
    for leaf in ("conv_in", "conv_last"):
        table.update(_conv_rows(f"{t_prefix}.{leaf}",
                                f"{f_prefix}/{leaf}/Conv_0"))
    for i in range(n_ca):
        for t_leaf, f_leaf in (("process.0", "process0"),
                               ("process.2", "process1"),
                               ("conv_du.0", "du0"), ("conv_du.2", "du1")):
            table.update(_conv_rows(f"{t_prefix}.process.{i}.{t_leaf}",
                                    f"{f_prefix}/ca_{i}/{f_leaf}/Conv_0"))
    return table


def _indices(params: dict, prefix: str) -> list[int]:
    """i of every top-level key `{prefix}_{i}`."""
    return [int(m[1]) for k in params
            if (m := re.fullmatch(rf"{prefix}_(\d+)", k))]


def innt_from_flax(params: dict) -> dict:
    """flax GPPNNINNT tree -> reference-keyed state_dict of float32
    tensors (the inverse of `convert_innt`)."""
    table = _refine_rows("refine", "refine", 1)
    for t_leaf, f_leaf in (("conv_process.convms", "convms"),
                           ("conv_process.convpan", "convpan"),
                           ("conv_fusion.conv", "conv_fusion"),
                           ("transform_fusion.fuse.conv_trans.0",
                            "transform_fusion/fuse/trans0"),
                           ("transform_fusion.fuse.conv_trans.2",
                            "transform_fusion/fuse/trans1"),
                           ("extract.fuse", "extract_fuse")):
        table.update(_conv_rows(t_leaf, f"{f_leaf}/Conv_0"))
    for i in _indices(params, "inv"):
        t_op, f_op = f"extract.operations.{i}", f"inv_{i}"
        table.update(_lu_rows(f"{t_op}.invconv", f"{f_op}/invconv"))
        for sub in ("F", "G", "H"):
            for blk in ("conv1", "conv2"):
                table.update(_hin_rows(f"{t_op}.{sub}.{blk}",
                                       f"{f_op}/{sub}/{blk}"))
    return _tensors(_from_table(params, table, "INNT"))


def _linear_rows(t_prefix: str, f_prefix: str, bias: bool = True) -> dict:
    """A flax Dense under `f_prefix` -> an nn.Linear."""
    table = {f"{f_prefix}/kernel": ([f"{t_prefix}.weight"],
                                    lambda k: np.asarray(k).T)}
    if bias:
        table[f"{f_prefix}/bias"] = ([f"{t_prefix}.bias"], _ident)
    return table


def _swin_rows(t_mod: str, f_mod: str, node: dict) -> dict:
    """A flax SwinModule -> the reference's SwinModule keys (the masks
    are recomputed, not stored)."""
    table = _linear_rows(f"{t_mod}.patch_partition.linear",
                         f"{f_mod}/patch_partition/linear/Dense_0")
    for key in node:
        m = re.fullmatch(r"(regular|shifted)_(\d+)", key)
        if not m:
            continue
        t_blk = f"{t_mod}.layers.{m[2]}.{int(m[1] == 'shifted')}"
        f_blk = f"{f_mod}/{key}"
        attn, mlp = f"{t_blk}.attention_block.fn", f"{t_blk}.mlp_block.fn"
        for t_norm, f_norm in ((attn, "attn_norm"), (mlp, "mlp_norm")):
            table[f"{f_blk}/{f_norm}/scale"] = ([f"{t_norm}.norm.weight"],
                                                _ident)
            table[f"{f_blk}/{f_norm}/bias"] = ([f"{t_norm}.norm.bias"],
                                               _ident)
        table[f"{f_blk}/attn/pos_embedding"] = (
            [f"{attn}.fn.pos_embedding"], _ident)
        for proj in ("to_qkv", "to_kv", "to_q"):
            table.update(_linear_rows(f"{attn}.fn.{proj}",
                                      f"{f_blk}/attn/{proj}/Dense_0",
                                      bias=False))
        table.update(_linear_rows(f"{attn}.fn.to_out",
                                  f"{f_blk}/attn/to_out/Dense_0"))
        table.update(_linear_rows(f"{mlp}.fn.net.0",
                                  f"{f_blk}/mlp_fc1/Dense_0"))
        table.update(_linear_rows(f"{mlp}.fn.net.2",
                                  f"{f_blk}/mlp_fc2/Dense_0"))
    return table


def panformer_from_flax(params: dict) -> dict:
    """flax CrossSwinTransformer tree -> reference-keyed state_dict of
    float32 tensors (the inverse of `convert_panformer`)."""
    table = {}
    for i, t_idx in enumerate((0, 3, 6, 8)):
        table.update(_conv_rows(f"HR_tail.{t_idx}", f"tail_conv{i}/Conv_0"))
    groups = {"pan_enc": "pan_encoder", "ms_enc": "ms_encoder",
              "pan_cross_ms": "pan_cross_ms", "ms_cross_pan": "ms_cross_pan"}
    for key, node in params.items():
        m = re.fullmatch(r"(\w+?)_(\d+)", key)
        if m and m[1] in groups:
            table.update(_swin_rows(f"{groups[m[1]]}.{m[2]}", key, node))
    return _tensors(_from_table(params, table, "PanFormer"))


def sfiin_from_flax(params: dict) -> dict:
    """flax SFIINNet tree -> reference-keyed state_dict of float32 tensors
    (the inverse of `convert_sfiin`)."""
    table = _refine_rows("refine", "refine", 1)
    for leaf in ("conv_p", "conv_p1", "fuse"):
        table.update(_conv_rows(f"process.{leaf}", f"{leaf}/Conv_0"))
    for i, t_blk in enumerate(("block", "block1", "block2", "block3",
                               "block4")):
        t_pre, f_pre = f"process.{t_blk}", f"block{i}"
        for t_leaf, f_leaf in (
                ("panprocess", "panprocess"), ("panpre", "panpre"),
                ("spa_process.1", "spa_out"), ("spa_att.0", "spa_att0"),
                ("spa_att.2", "spa_att1"), ("cha_att.0", "cha_att0"),
                ("cha_att.2", "cha_att1"), ("post", "post"),
                ("fre_process.pre1", "fre_process/pre1"),
                ("fre_process.pre2", "fre_process/pre2"),
                ("fre_process.amp_fuse.0", "fre_process/amp_fuse0"),
                ("fre_process.amp_fuse.2", "fre_process/amp_fuse1"),
                ("fre_process.pha_fuse.0", "fre_process/pha_fuse0"),
                ("fre_process.pha_fuse.2", "fre_process/pha_fuse1"),
                ("fre_process.post", "fre_process/post")):
            table.update(_conv_rows(f"{t_pre}.{t_leaf}",
                                    f"{f_pre}/{f_leaf}/Conv_0"))
        t_inv, f_inv = f"{t_pre}.spa_process.0", f"{f_pre}/spa_inv"
        table.update(_lu_rows(f"{t_inv}.invconv", f"{f_inv}/invconv"))
        for sub in ("F", "G", "H"):
            for leaf in ("conv1/identity", "conv1/conv_1", "conv1/conv_2",
                         "conv2/identity", "conv2/conv_1", "conv2/conv_2",
                         "conv3"):
                table.update(_conv_rows(
                    f"{t_inv}.{sub}.{leaf.replace('/', '.')}",
                    f"{f_inv}/{sub}/{leaf}/Conv_0"))
    return _tensors(_from_table(params, table, "SFIIN"))


def mutinf_from_flax(params: dict) -> dict:
    """flax GPPNNMutInf `core_module` tree -> reference-keyed state_dict of
    float32 tensors (the inverse of `convert_mutinf`)."""
    table = _refine_rows("refine", "refine", 2)
    table.update(_conv_rows("interact.fuse", "interact_fuse/Conv_0"))
    for grp in ("extract_pan", "extract_ms"):
        table.update(_conv_rows(f"{grp}.conv", f"{grp}/conv/Conv_0"))
        for blk in ("block1", "block2"):
            t_blk, f_blk = f"{grp}.{blk}", f"{grp}/{blk}"
            for t_leaf, f_leaf in (("process", "process"), ("Res.0", "res0"),
                                   ("Res.2", "res1")):
                table.update(_conv_rows(f"{t_blk}.{t_leaf}",
                                        f"{f_blk}/{f_leaf}/Conv_0"))
            for br in ("h_conv", "d_conv"):
                table[f"{f_blk}/cdc/{br}/taps"] = (
                    [f"{t_blk}.CDC.{br}.conv.weight"], _hwio)
            table[f"{f_blk}/cdc/hp_branch"] = ([f"{t_blk}.CDC.HP_branch"],
                                               _ident)
    for i in _indices(params, "inv"):
        t_op, f_op = f"interact.operations.{i}", f"inv_{i}"
        table.update(_lu_rows(f"{t_op}.invconv", f"{f_op}/invconv"))
        for sub in ("F", "G", "H"):
            t_sub, f_sub = f"{t_op}.{sub}", f"{f_op}/{sub}"
            for blk in ("conv1", "conv2"):
                table.update(_hin_rows(f"{t_sub}.ops.{blk}",
                                       f"{f_sub}/ops/{blk}"))
            for t_leaf, f_leaf in (("ops.conv3", "ops/conv3"),
                                   ("fusepool.1", "fusepool"),
                                   ("fc1.0", "fc1"), ("fc2.0", "fc2"),
                                   ("fc3.0", "fc3"), ("fuse", "fuse")):
                table.update(_conv_rows(f"{t_sub}.{t_leaf}",
                                        f"{f_sub}/{f_leaf}/Conv_0"))
    return _tensors(_from_table(params, table, "MutInf"))


def mi_from_flax(params: dict) -> dict:
    """flax MutualInfoReg tree -> the port's `MutualInfoReg` state_dict of
    float32 tensors: conv kernels HWIO -> OIHW; each Dense kernel
    [side * side * channels, latent], rows in (h, w, c) order, -> a
    Linear weight [latent, channels * side * side] with its columns in
    (c, h, w) order (ROADMAP C.34). `channels` is layer3's output width,
    `side` the square side it implies."""
    channels = np.asarray(params["layer3"]["kernel"]).shape[-1]

    def dense(k):
        k = np.asarray(k)
        side = int(np.sqrt(k.shape[0] // channels))
        if side * side * channels != k.shape[0]:
            raise ValueError(f"mi_from_flax: a Dense of {k.shape[0]} inputs "
                             f"is no square of {channels} channels")
        return k.reshape(side, side, channels, -1).transpose(
            2, 0, 1, 3).reshape(k.shape[0], -1).T

    table = {}
    for name in ("layer1", "layer2", "layer3", "layer4"):
        table.update(_conv_rows(name, name))
    for name in ("fc1_rgb3", "fc2_rgb3", "fc1_depth3", "fc2_depth3"):
        table[f"{name}/kernel"] = ([f"{name}.weight"], dense)
        table[f"{name}/bias"] = ([f"{name}.bias"], _ident)
    return _tensors(_from_table(params, table, "MutInf mi"))


def discriminator_from_flax(params: dict) -> dict:
    """flax Pixel/Patch/VGGDiscriminator tree -> the port's discriminator
    state_dict of float32 tensors (module docstring). A VGG's fc0 input
    is the flatten of 512 channels on a square side."""
    table = {}
    for path, val in _flat(params).items():
        layer, *rest = path.split("/")
        if rest == ["Conv_0", "kernel"]:
            table[path] = ([f"{layer}.weight"], _hwio)
        elif rest == ["Conv_0", "bias"] or rest == ["bias"]:
            table[path] = ([f"{layer}.bias"], _ident)
        elif rest == ["scale"]:
            table[path] = ([f"{layer}.weight"], _ident)
        elif rest == ["kernel"] and layer == "fc0":
            table[path] = (["fc0.weight"], _nhwc_rows_t)
        elif rest == ["kernel"]:
            table[path] = ([f"{layer}.weight"], lambda k: np.asarray(k).T)
    return _tensors(_from_table(params, table, "discriminator"))


def _nhwc_rows_t(k, channels: int = 512) -> np.ndarray:
    """A Dense kernel [side * side * channels, out] on an NHWC flatten ->
    a Linear weight [out, channels * side * side] on the NCHW flatten."""
    k = np.asarray(k)
    side = int(np.sqrt(k.shape[0] // channels))
    if side * side * channels != k.shape[0]:
        raise ValueError(f"discriminator_from_flax: fc0 of {k.shape[0]} "
                         f"inputs is no square of {channels} channels")
    return k.reshape(side, side, channels, -1).transpose(2, 0, 1, 3).reshape(
        k.shape[0], -1).T
