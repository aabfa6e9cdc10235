"""INNT's height-sharded forward against its whole forward, on the CPU:
how far the gathered output lies from the whole one, how far the
search's inputs lie apart, and how many transferred values moved (picks
flipped at first-max near ties, ROADMAP C.15).

    python3 scripts/torch_spatial_ties.py [--side 256] [--rows float64]

Builds INNT from the shipped WV-3 config (8 bands, seeded weights, as
`chip_smoke.py`'s `space` phase does) on a crop of `chip_smoke.py`'s
seeded WV-3 scene with pan side `--side`, and runs it whole in this
process and height-sharded on two spawned gloo ranks
(`parallel/ranks.py::spawn`). `--rows` picks how the ranks make m_hr's
rows: "float64" (`spatial.bicubic_rows` as shipped), "float32" (the same
taps summed in float32) or "whole" (the whole plane's `F.interpolate`,
its rows cut out: the whole forward's bits). Prints one line a
measurement; runs on the CPU with one intra-op thread a process.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the seeded scene and configs)
from lgteun_tpu_torch.parallel import ranks, spatial  # noqa: E402


def _method():
    cfg = chip_smoke.mode_cfg("INNT.py")
    method = chip_smoke.zoo_method(cfg, {}, "cpu")
    method.init_params(torch.Generator().manual_seed(chip_smoke.SEED))
    return method.eval()


def _batch(side: int) -> dict:
    lr, pan = chip_smoke.synthetic_scene(chip_smoke.SCENE, 8,
                                         chip_smoke.SEED + 19)
    scale = chip_smoke.DN_RANGE
    return {"input_lr": lr[None, :side // 4, :side // 4] / scale,
            "input_pan": pan[None, :side, :side, None] / scale}


def _recorded(fn):
    """`innt.texture_match` recording each call's query, ref and
    transferred values."""
    import lgteun_tpu_torch.models.innt as innt
    calls, search = [], innt.texture_match

    def record(lr, ref):
        t, s = search(lr, ref)
        calls.append([v.detach().numpy().copy() for v in (lr, ref, t)])
        return t, s
    innt.texture_match = record
    try:
        return fn(), calls
    finally:
        innt.texture_match = search


def _float32_rows(x, out_hw, lo, hi):
    """`bicubic_rows` with its taps summed in float32."""
    h = x.shape[-2]
    scale = torch.tensor((h - 1) / (out_hw[0] - 1), dtype=torch.float32)
    src = scale * torch.arange(lo, hi, dtype=torch.float32)
    base = torch.floor(src)
    out = None
    for k, wk in enumerate(spatial._cubic_weights(src - base)):
        term = x[..., (base.long() - 1 + k).clamp(0, h - 1), :] * wk[:, None]
        out = term if out is None else out + term
    return torch.nn.functional.interpolate(
        out, size=(hi - lo, out_hw[1]), mode="bicubic", align_corners=True)


def _whole_rows(x, out_hw, lo, hi):
    """The rows of the whole plane's `F.interpolate`."""
    return torch.nn.functional.interpolate(
        x, size=tuple(out_hw), mode="bicubic", align_corners=True)[
            ..., lo:hi, :]


def rank_job(mesh, side: int, rows: str) -> dict:
    """The sharded forward on the rank of a {"space": 2} mesh: its rows
    and its search's call."""
    mesh = ranks.make_mesh({"space": 2}, device=mesh.device)
    spatial.bicubic_rows = {"float64": spatial.bicubic_rows,
                            "float32": _float32_rows,
                            "whole": _whole_rows}[rows]
    method = _method()
    out, calls = _recorded(lambda: spatial.run_spatially_sharded(
        method, _batch(side), mesh))
    return {"rows": out.numpy(), "call": calls[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--rows", default="float64",
                    choices=("float64", "float32", "whole"))
    opts = ap.parse_args()
    torch.set_num_threads(1)
    with torch.no_grad():
        want, calls = _recorded(lambda: _method().apply(_batch(opts.side)))
    want = want.numpy()
    out = ranks.spawn([(rank_job, dict(side=opts.side, rows=opts.rows))], 2,
                      os.path.join(REPO, "build", "spatial_ties"))
    got = np.concatenate([r[0]["rows"] for r in out], axis=1)
    share = [np.concatenate([r[0]["call"][i] for r in out])
             for i in range(3)]
    moved = np.abs(share[2] - calls[0][2])
    print(f"INNT pan {opts.side}^2 on 2 ranks, m_hr rows {opts.rows}: "
          f"max|sharded - whole| {np.abs(got - want).max():.3e} = "
          f"{np.abs(got - want).max() / np.abs(want).max():.3e} of max|out|")
    print(f"search queries max|diff| {np.abs(share[0] - calls[0][0]).max():.3e}"
          f", refs {np.abs(share[1] - calls[0][1]).max():.3e}; transferred "
          f"values moved by more than 1e-3: {int((moved > 1e-3).sum())} of "
          f"{moved.size} (largest {moved.max():.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
