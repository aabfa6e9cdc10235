"""lgteun_tpu_torch — the PyTorch/CUDA port of lgteun_tpu for one NVIDIA H100.

The JAX package `lgteun_tpu` stays the reference; this package holds the
port, slice by slice. Slice 1 is the UnlgFormer (LGTEUN, K=2) eval path:

- plain PyTorch for the unfolding data steps, resamples and 1x1 convs
  (what the JAX package left to XLA);
- three hand-written Hopper kernels (`csrc/*.cu`, built with nvcc for
  sm_90a and bound with ctypes) for the three Pallas kernels of every
  LGB block: the LN + FFT mixer head, 8x8-window attention and the
  proj + LN + FFN block tail (`ops/`).

Every kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its kernel (or raises) for a CUDA tensor. The package never
imports jax, flax or `lgteun_tpu`: it has its own config loader
(`config.py`) and registry, and reads the JAX package's shipped config
files as plain Python.
"""

from lgteun_tpu_torch.registry import MODELS  # noqa: F401
