"""JAX (flax) LGTEUN params -> the port's reference-keyed state_dict.

The exact inverse of `lgteun_tpu/convert/torch_import.py::convert_lgteun`
(which maps reference torch keys onto the flax tree), so
`convert_state_dict("UnlgFormer", lgteun_from_flax(tree))` gives `tree`
back bit for bit. Layouts:

- conv kernels: flax HWIO [kh, kw, in/g, out] -> torch OIHW
- pos_emb: flax [heads, S, S] -> torch [1, heads, S, S]
- amp_scale / pha_scale: flax [1, 1, 1, C] -> torch [C, 1, 1, 1]
  (the reference's 1x1 depthwise convs; the generic kernel rule)
- the fused-FFN raw params (w1 [C, 4C], dw [3, 3, 1, 4C], ...) are
  HWIO kernels too.

Takes the flax `core_module` tree as nested dicts of numpy arrays (no jax
import); returns {key: float32 torch.Tensor}.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lgteun_from_flax"]


def _hwio(k) -> np.ndarray:
    """flax [kh, kw, in/g, out] -> torch [out, in/g, kh, kw]."""
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _ident(v) -> np.ndarray:
    return np.asarray(v)


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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
