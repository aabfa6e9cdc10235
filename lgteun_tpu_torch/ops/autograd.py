"""Gradients for the kernel wrappers: a kernel forward with a recompute
backward.

Counterpart of the JAX package's `custom_vjp` training wrappers
(`lgteun_tpu/ops/spectral_kernel.py::fused_ln_mixer_head_train`,
`window_attention.py::fused_window_attention_v2` /
`fused_window_attention_v3_packed_train`, `ffn_kernel.py::
fused_block_tail_train`): none of their kernels has a backward kernel;
each backward is the plain composition's, recomputed from the saved
inputs. `recompute(kernel, plain, *tensors)` does the same in PyTorch:

    forward   kernel(*tensors), gradients off; saves the inputs only
    backward  plain(*inputs) again under torch.enable_grad(), then
              torch.autograd.grad of it against the incoming gradients

`kernel` and `plain` take the same positional tensors and return a
tensor or a tuple of tensors; an input that needs no gradient (a dropout
mask, say) gets none. The wrappers call it only for a CUDA tensor: on a
CPU tensor they run their plain version under ordinary autograd.
"""

from __future__ import annotations

import torch

__all__ = ["recompute"]


class _Recompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


def recompute(kernel, plain, *tensors):
    """kernel(*tensors), differentiable through plain(*tensors); a plain
    kernel call when no gradient is recorded (eval, inference_mode)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Recompute.apply(kernel, plain, *tensors)
    return kernel(*tensors)
