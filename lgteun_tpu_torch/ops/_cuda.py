"""Build and bind the port's CUDA kernels (`lgteun_tpu_torch/csrc/*.cu`).

At first use, `nvcc` compiles every `csrc/*.cu` for sm_90a with a plain
C interface (no PyTorch headers: seconds, not minutes), one process per
source, all started together, and links the objects into one shared
library. The library is keyed by a hash of the sources and flags and
lives in `build/lgteun_tpu_torch/` at the repository root. It is loaded
with ctypes; every pointer and the stream pass as `c_void_p`.

There is no fallback: without `nvcc`, or when the build fails, the
loader raises, and a kernel wrapper given a CUDA tensor raises with it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "kernels", "launch",
           "plain_on_cpu", "check_cuda_f32", "weight_layout"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lgteun_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; each returns cudaGetLastError() after its launches
SIGNATURES = {
    # x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b, y1, x2, B, C, H, W, eps, stream
    "lgteun_ln_mixer_head": [_P] * 9 + [_I] * 4 + [_F, _P],
    # x, amp_w, amp_b, pha_w, pha_b, out, B, C, H, W, stream
    "lgteun_global_mixer": [_P] * 6 + [_I] * 4 + [_P],
    # x, ln_w, ln_b, w1T, b1, w2T, b2, dw, bdw, w3T, b3, out, B, C, C4, H,
    # W, eps, stream
    "lgteun_ln_ffn": [_P] * 12 + [_I] * 5 + [_F, _P],
    # x, 6 mixer weights, wqkv, bqkv, pos, wpT, bp, 10 FFN weights,
    # scratch, counter, out, B, C, C4, H, W, heads, win, scale, eps, stream
    "lgteun_lgb_block": [_P] * 25 + [_I] * 7 + [_F, _F, _P],
    # x, wqkv, bqkv, pos, out, B, C, H, W, heads, win, scale, stream
    "lgteun_window_attention": [_P] * 5 + [_I] * 6 + [_F, _P],
    # x, wqkv, bqkv, pos, out, N, C, heads, win, scale, stream
    "lgteun_window_attention_windows": [_P] * 5 + [_I] * 4 + [_F, _P],
    "lgteun_window_attention_rows": [_P] * 5 + [_I] * 4 + [_F, _P],
    # x, x1, x2, mask (or null), wpT, bp, ln_w, ln_b, w1T, b1, w2T, b2, dw,
    # bdw, w3T, b3, out, B, C, C4, H, W, eps, stream
    "lgteun_block_tail": [_P] * 17 + [_I] * 5 + [_F, _P],
    # in, in_c, lms, wts, out, table (host), n, B, H, W, stream
    "lgteun_lightnet_group": [_P, _I] + [_P] * 4 + [_I] * 4 + [_P],
    # x, wt, wp, wg, ww, out, B, C, H, W, fs, stream
    "lgteun_neighborhood_attention": [_P] * 6 + [_I] * 5 + [_P],
    # lr, ref, t, s, N, C, side, stream
    "lgteun_texture_match": [_P] * 4 + [_I] * 3 + [_P],
    # lr_n, ref_n, ref_u, t, s, N, L, K, stream
    "lgteun_patch_match": [_P] * 5 + [_I] * 3 + [_P],
}


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, not under $CUDA_HOME/bin): the "
        "lgteun_tpu_torch CUDA kernels cannot be built")


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/*.cu into build_dir (skipped when the hash-keyed
    library exists) and return its path. Raises on any failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = Path(build_dir) / f"liblgteun_kernels_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    try:
        errors = []
        for cmd, proc in zip(compiles, procs):
            log = proc.communicate()[0]
            if proc.returncode != 0:
                errors.append(f"nvcc failed (exit {proc.returncode}): "
                              f"{' '.join(cmd)}\n{log}")
        if errors:
            raise RuntimeError("\n".join(errors))
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lgteun_error_string.argtypes = [ctypes.c_int]
    lib.lgteun_error_string.restype = ctypes.c_char_p
    return lib


def plain_on_cpu(name: str, x: torch.Tensor) -> bool:
    """True when x lies on the CPU (the wrapper runs its plain version);
    False on a CUDA device; raise on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cpu"


def check_cuda_f32(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on
    `device` and none needs a gradient: a kernel has no backward of its
    own, and the wrappers that are differentiable launch it inside
    `ops.autograd.recompute`, where gradients are off."""
    for key, t in tensors.items():
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous float32 tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: {key} requires grad, but the "
                               "kernel has no backward")


# Weights in a kernel's own layout, made once per weight version. Key:
# (tag, the sources' data pointers, shapes, strides and devices); value:
# (sources, versions, result). The entry holds its sources, so no other
# tensor can take those addresses while it lives; a changed `_version`
# (load_state_dict, an optimizer step) remakes the result.
_LAYOUTS: dict = {}
_LAYOUTS_MAX = 64


def weight_layout(tag: str, sources, make):
    """`make()`, cached for `tag` and the current versions of the tensors
    `sources` it is made from."""
    key = (tag, tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.device)
                      for t in sources))
    versions = tuple(t._version for t in sources)
    hit = _LAYOUTS.get(key)
    if hit is None or hit[1] != versions:
        if hit is None and len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        hit = _LAYOUTS[key] = (tuple(sources), versions, make())
    return hit[2]


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` on `device`'s current stream; raise on the
    CUDA error it returns. Tensors pass as their data pointers."""
    lib = kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]   # None passes as a null pointer
        err = getattr(lib, name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.lgteun_error_string(err).decode()})")
