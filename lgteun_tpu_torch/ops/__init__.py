"""Kernel wrappers (CUDA on a CUDA tensor, plain PyTorch on a CPU
tensor) and plain resize. Import the submodules directly."""

import os as _os

import torch as _torch


def fuse_level() -> int:
    """How each LGB block of the LGT prior is computed (env
    LGTEUN_FUSE_LEVEL, default 2, parsed as
    `lgteun_tpu/ops/__init__.py::fuse_level` but values below 1 read as
    2; read when a method is built):

      3 and above  `lgb_block`: the whole block in one kernel
      2 (default)  `ln_mixer_head` -> `window_attention` -> `block_tail`
      1           LN -> `window_attention` -> `global_mixer` -> proj ->
                   residual -> `ln_ffn` (LN and proj plain torch)

    The JAX package's level 0 (no kernel) is the last rung of its bench
    retry ladder; here a CPU tensor already takes every wrapper's plain
    version, and a card always runs kernels. The JAX package also tests
    shapes (TPU lane alignment) and leaves the mixer to XLA at level 1;
    the port's kernels take every plane with H up to 14,514 and W up to
    29,026 (odd W 14,513) at any factorization (the FFT mixer above 240 x
    240 on its cluster or global route; level 3's `lgb_block` there, and
    on odd sides or prime factors above 512, as level 2's chain, by
    shape), so no level runs a plain version on a card, and the wrappers
    raise beyond those sides."""
    try:
        level = int(_os.environ.get("LGTEUN_FUSE_LEVEL", "2"))
    except ValueError:
        return 2
    return level if level >= 1 else 2


def windows_layout_attention() -> bool:
    """True when env LGTEUN_FUSED_ATTENTION is "v2" (read when a method
    is built): the local mixer of fuse levels 1 and 2 then partitions
    its input into [N, C, S] windows and runs `window_attention_windows`
    (B6, the JAX package's pinned v2 kernel) instead of
    `window_attention` on the image. Level 3 ignores it, as the JAX fast
    path does. Every other value, the JAX package's "0" (its XLA path)
    included, reads as the default: a card always runs kernels."""
    return _os.environ.get("LGTEUN_FUSED_ATTENTION", "1") == "v2"


def storage_dtype() -> tuple:
    """UnlgFormer's activation storage between the kernels of its eval
    forward (env LGTEUN_EVAL_DTYPE, parsed as `lgteun_tpu/models/
    lgteun_fast.py::_storage_dtype`; read when a method is built) ->
    (sdtype, res_f32):

      unset, any other value  (None, False): float32 storage
      "bf16"                  (torch.bfloat16, False): every tensor
                              between the kernels is bf16, the LGB
                              residual stream and the inter-scale convs
                              included
      "bf16res"               (torch.bfloat16, True): only the mixer
                              branches (y1, x1, x2) are bf16; the
                              residual stream, the inter-scale convs and
                              resamples and the block outputs stay
                              float32 (the serving mode)

    Math inside a kernel is float32 in every mode; every store rounds
    once to nearest even. The unfolding steps, the patch embed and the
    tail are float32, the output is float32, and training runs float32
    storage (`models/common/lgt.py`)."""
    mode = _os.environ.get("LGTEUN_EVAL_DTYPE")
    if mode == "bf16":
        return _torch.bfloat16, False
    if mode == "bf16res":
        return _torch.bfloat16, True
    return None, False


def upcast(t: _torch.Tensor) -> _torch.Tensor:
    """t as the input of float32 math: a bfloat16 tensor upcast (exactly),
    any other as it is (a float64 tensor stays float64)."""
    return t.float() if t.dtype == _torch.bfloat16 else t
