"""A/B of two versions of the port's kernels on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py A B [--batch 4] [--sizes 128,64,144,72]

A and B are two versions either of `lgteun_tpu_torch/csrc/
texture_match.cu` (the INNT searches `lgteun_texture_match` and
`lgteun_patch_match`, at INNT's shapes: N = 256 patch-images an image,
C = 4, side 24, a quarter of the images with PatchFusion's zero rims),
or of the whole `lgteun_tpu_torch/csrc` directory (then also the LGB
kernels at the UnlgFormer block shapes and the scene engine's 144^2 /
72^2: every case whose C entry both versions have; `--sizes` picks the
planes, e.g. 128,64 for a version whose mixer takes only powers of
two). Each is built with
the port's nvcc flags into a shared library of its own; both run on the
same inputs. The script checks that B's outputs equal A's bit for bit,
times both in turns A, B, B, A with CUDA events (mean of 20 calls after
3 warm-up calls each), and prints one line per case with the card's
name and power limit. It exits non-zero without a CUDA device or when
the outputs differ.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(src: str, out_dir: str, tag: str) -> ctypes.CDLL:
    """A source file, or a csrc directory (built as the port builds
    it), into a library with the C signatures it has declared."""
    from lgteun_tpu_torch.ops import _cuda
    if os.path.isdir(src):
        csrc, _cuda.CSRC = _cuda.CSRC, Path(src)
        try:
            lib = str(_cuda.build_library(Path(out_dir) / tag))
        finally:
            _cuda.CSRC = csrc
    else:
        lib = os.path.join(out_dir, f"lib_{tag}.so")
        subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                        "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    for name, argtypes in _cuda.SIGNATURES.items():
        if hasattr(dll, name):
            getattr(dll, name).argtypes = argtypes
            getattr(dll, name).restype = ctypes.c_int
    return dll


def caller(dll: ctypes.CDLL, name: str, *args):
    """A no-argument function that launches C entry `name` of `dll` on
    the current stream and raises on its error."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = getattr(dll, name)

    def call():
        err = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def lgb_cases(batch: int, sizes, gen: torch.Generator) -> dict:
    """label -> (C entry, inputs, output allocator, trailing arguments)
    of the LGB kernels at the UnlgFormer block shapes (C 32 at 128^2,
    C 64 at 64^2) and the scene engine's (C 32 at 144^2, C 64 at 72^2),
    weights in the kernels' layouts."""
    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    cases = {}
    channels = {128: 32, 64: 64, 144: 32, 72: 64}
    for hw in sizes:
        c = channels[hw]
        b, c2, c4 = batch, c // 2, 4 * c
        tag = f"{b}x{c}x{hw}x{hw}"
        x = n(b, c, hw, hw)
        half = lambda s=(b, c2, hw, hw): torch.empty(s, device="cuda")
        full = lambda s=(b, c, hw, hw): (torch.empty(s, device="cuda"),)
        mix = (n(c2), 0.1 * n(c2), n(c2), 0.1 * n(c2))
        cases[f"ln_mixer_head {tag}"] = (
            "lgteun_ln_mixer_head", (x, 1 + 0.1 * n(c), 0.1 * n(c)) + mix,
            lambda half=half: (half(), half()), (b, c, hw, hw, 1e-5))
        cases[f"global_mixer {b}x{c2}x{hw}x{hw}"] = (
            "lgteun_global_mixer", (n(b, c2, hw, hw),) + mix,
            lambda half=half: (half(),), (b, c2, hw, hw))
        if hw in (144, 72):
            continue
        cases[f"window_attention {b}x{c2}x{hw}x{hw}"] = (
            "lgteun_window_attention",
            (n(b, c2, hw, hw), n(3 * c2, c2, scale=c2 ** -0.5),
             0.1 * n(3 * c2), n(2, 64, 64)),
            lambda half=half: (half(),),
            (b, c2, hw, hw, 2, 8, (c2 // 2) ** -0.5))
        ffn = (1 + 0.1 * n(c), 0.1 * n(c), n(c, c4, scale=c ** -0.5),
               0.1 * n(c4), n(c4, c4, scale=c4 ** -0.5), 0.1 * n(c4),
               n(c4, 3, 3, scale=1 / 3), 0.1 * n(c4),
               n(c4, c, scale=c4 ** -0.5), 0.1 * n(c))
        cases[f"block_tail {tag}"] = (
            "lgteun_block_tail", (x, n(b, c2, hw, hw), n(b, c2, hw, hw),
                                  n(c, c, scale=c ** -0.5), 0.1 * n(c))
            + ffn, full, (b, c, c4, hw, hw, 1e-5))
        cases[f"ln_ffn {tag}"] = ("lgteun_ln_ffn", (x,) + ffn, full,
                                  (b, c, c4, hw, hw, 1e-5))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sizes", default="128,64,144,72",
                    help="H = W of the LGB cases (C 32 at 128 and 144, "
                         "C 64 at 64 and 72)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import sh, time_ms
    from lgteun_tpu_torch.ops.texture_match_kernel import row_normalize

    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"A": build(opts.a, tmp, "a"), "B": build(opts.b, tmp, "b")}
    gen = torch.Generator().manual_seed(19971118)
    n, c, side = 256 * opts.batch, 4, 24
    q = side * side

    def images():
        x = torch.randn(n, c, side, side, generator=gen)
        x[: n // 4, :, :8] = 0
        x[: n // 4, :, :, :8] = 0
        return x.reshape(n, c, q).cuda()

    lr, ref = images(), images()
    unf = lambda v: F.unfold(v.view(n, c, side, side), 3, padding=1)
    ref_u = unf(ref)
    lr_n = row_normalize(unf(lr), 1).transpose(1, 2).contiguous()
    ref_n = row_normalize(ref_u, 1).transpose(1, 2).contiguous()
    cases = {
        f"texture_match {n}x{c}x{q}": (
            "lgteun_texture_match", (lr, ref),
            lambda: (torch.empty(n, c, q, device="cuda"),
                     torch.empty(n, q, device="cuda")), (n, c, side)),
        f"patch_match {n}x{q}x{9 * c}": (
            "lgteun_patch_match", (lr_n, ref_n, ref_u),
            lambda: (torch.empty(n, 9 * c, q, device="cuda"),
                     torch.empty(n, q, device="cuda")), (n, q, 9 * c)),
    }
    cases.update(lgb_cases(opts.batch, map(int, opts.sizes.split(",")),
                           gen))
    for label, (entry, ins, alloc, dims) in cases.items():
        if not all(hasattr(dll, entry) for dll in libs.values()):
            continue
        outs, calls = {}, {}
        for tag, dll in libs.items():
            outs[tag] = alloc()
            calls[tag] = caller(dll, entry, *ins, *outs[tag], *dims)
            calls[tag]()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(outs["A"], outs["B"]))
        a1, b1, b2, a2 = (time_ms(calls[t]) for t in "ABBA")
        print(f"ab {label}: A {a1:.4f}/{a2:.4f} ms  B "
              f"{b1:.4f}/{b2:.4f} ms  A/B {(a1 + a2) / (b1 + b2):.3f}  "
              f"outputs bit-equal {same}  [{card}]")
        if not same:
            raise AssertionError(f"{label}: B's outputs differ from A's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
