"""Kernel wrappers (CUDA on a CUDA tensor, plain PyTorch on a CPU
tensor) and plain resize. Import the submodules directly."""
