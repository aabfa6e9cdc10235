"""A/B of two versions of the port's INNT search kernels on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py A.cu B.cu [--batch 4]

Each argument is a version of `lgteun_tpu_torch/csrc/texture_match.cu`
(the C entries `lgteun_texture_match` and `lgteun_patch_match`). Each is
built with the port's nvcc flags into a shared library of its own; both
run on the same inputs at INNT's shapes (N = 256 patch-images an image,
C = 4, side 24; a quarter of the images with PatchFusion's zero rims).
The script checks that B's outputs equal A's bit for bit, times both in
turns A, B, B, A with CUDA events (mean of 20 calls after 3 warm-up
calls each), and prints one line per kernel with the card's name and
power limit. It exits non-zero without a CUDA device or when the
outputs differ.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(src: str, out_dir: str, tag: str) -> ctypes.CDLL:
    from lgteun_tpu_torch.ops import _cuda
    lib = os.path.join(out_dir, f"lib_{tag}.so")
    subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                    lib, src], check=True)
    dll = ctypes.CDLL(lib)
    for name in ("lgteun_texture_match", "lgteun_patch_match"):
        getattr(dll, name).argtypes = _cuda.SIGNATURES[name]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--batch", type=int, default=4)
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
        "texture_match": (
            "lgteun_texture_match", (lr, ref),
            lambda: (torch.empty(n, c, q, device="cuda"),
                     torch.empty(n, q, device="cuda")), (n, c, side)),
        "patch_match": (
            "lgteun_patch_match", (lr_n, ref_n, ref_u),
            lambda: (torch.empty(n, 9 * c, q, device="cuda"),
                     torch.empty(n, q, device="cuda")), (n, q, 9 * c)),
    }
    for label, (entry, ins, alloc, dims) in cases.items():
        outs, calls = {}, {}
        for tag, dll in libs.items():
            outs[tag] = alloc()
            calls[tag] = caller(dll, entry, *ins, *outs[tag], *dims)
            calls[tag]()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(outs["A"], outs["B"]))
        a1, b1, b2, a2 = (time_ms(calls[t]) for t in "ABBA")
        print(f"ab {label} {n}x{c}x{q}: A {a1:.4f}/{a2:.4f} ms  B "
              f"{b1:.4f}/{b2:.4f} ms  A/B {(a1 + a2) / (b1 + b2):.3f}  "
              f"outputs bit-equal {same}  [{card}]")
        if not same:
            raise AssertionError(f"{label}: B's outputs differ from A's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
