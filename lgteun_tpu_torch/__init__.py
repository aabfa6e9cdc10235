"""lgteun_tpu_torch — the PyTorch/CUDA port of lgteun_tpu for one NVIDIA H100.

The JAX package `lgteun_tpu` stays the reference; this package holds the
port, slice by slice. It runs four eval paths: UnlgFormer (LGTEUN, K=2),
lightnet, MDCUN and INNT; the training-free GSA, SFIM and Wavelet; the
evaluation entry point (`python -m lgteun_tpu_torch.main`: the IQA
metrics on both test splits, `metrics/`); UnlgFormer's training (`runner.py`:
Adam/StepLR, l1, dropout, checkpoints; `data/`: the train iterator, the
PSDataset reader and the synthetic Wald generator); the whole-scene
engine and its CLI (`parallel/scene.py`, `python -m
lgteun_tpu_torch.fuse`); data-parallel training, eval and scene
fusion over ranks launched with torchrun (`parallel/mesh.py`); and the
reference's released checkpoints, read without its code
(`convert/from_reference.py`), with the native TIFF codec (`native/`)
and the host utilities (`utils/`) beside them, with

- plain PyTorch for what the JAX package left to XLA: the unfolding
  steps, resamples and the convs outside the kernels;
- hand-written Hopper kernels (`csrc/*.cu`, built with nvcc for sm_90a
  and bound with ctypes) for the Pallas kernels on those paths (`ops/`):
  the LGB block's (the LN + FFT mixer head, 8x8-window attention, the
  proj + LN + FFN block tail by default; the global mixer and LN + FFN,
  or the whole block in one kernel, as `LGTEUN_FUSE_LEVEL` selects; the
  attention also on [N, C, S] windows and [N*S, C] rows; the tail also
  with a dropout mask), LightNet's SpanConv stack, MDCUN's neighbourhood
  attention and INNT's texture-match and patch-match searches.

Every kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its kernel (or raises) for a CUDA tensor; the LGB block's
wrappers are differentiable there (`ops/autograd.py`: the kernel
forward, the plain version's backward). The package never
imports jax, flax or `lgteun_tpu`: it has its own config loader
(`config.py`) and registry, and reads the JAX package's shipped config
files as plain Python.
"""

from lgteun_tpu_torch.registry import MODELS  # noqa: F401
