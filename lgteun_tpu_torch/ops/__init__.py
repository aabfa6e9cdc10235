"""Kernel wrappers (CUDA on a CUDA tensor, plain PyTorch on a CPU
tensor) and plain resize. Import the submodules directly."""

import os as _os


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
    the port's kernels take every shape of the path, so no level runs a
    plain version on a card."""
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
