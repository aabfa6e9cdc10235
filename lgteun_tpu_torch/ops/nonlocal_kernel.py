"""MDCUN's 15x15 neighbourhood non-local attention (blockNL) on
[B, C, H, W].

Counterpart of `lgteun_tpu/ops/nonlocal_kernel.py::
fused_neighborhood_attention` (Pallas) and `neighborhood_attention_xla`
(its plain version). Per pixel p and offset f of the fs x fs
neighbourhood:

    att(p, f) = softmax_f( theta(x)[p] . phi(x)[p + f] )
    out[p]    = W_w ( sum_f att(p, f) g(x)[p + f] ) + x[p]

theta/phi/g/w are bias-free 1x1 convs, given here as [C_out, C_in]
matrices (torch's conv weight [:, :, 0, 0]; the JAX package holds their
transposes). phi and g are zero outside the image, as `F.unfold` pads
them: such a neighbour enters the softmax with logit 0 and adds
nothing to the sum, so it dilutes the attention at the borders.

`neighborhood_attention` launches `csrc/neighborhood_attention.cu` for a
CUDA tensor, differentiable there (`ops.autograd.recompute`: the kernel
forward, the plain version's backward recomputed from the saved inputs,
as the JAX `custom_vjp` recomputes its XLA chain), and runs
`neighborhood_attention_ref` for a CPU tensor. The
kernel has two branches (`neighborhood_attention_branch`, the library's
`lgteun_neighborhood_attention_tc`): "tc", the logits and the weighted
sum of each 16-query run as mma.sync TF32 products with the 3xTF32 split
(a block of 4 runs, or 8 where the grid fills the card, phi and g
staged over its rows, the fs - 1 halo rows and 32-key chunks), wherever
the 4-run staging fits a block's shared memory; "fp32", the earlier
one-thread-a-pixel body, for the rest (large fs at C >= 8). The wrapper
counts its launches by branch (`variants`).

Storage (MDCUN's eval forward under `LGTEUN_EVAL_DTYPE=bf16`, the JAX
package's blanket cast): x may be bfloat16, and then out is too. x is
upcast exactly, all math is float32, the residual adds the upcast x, and
out is rounded once to nearest even as stored, as the Pallas kernel does
(`lgteun_tpu/ops/nonlocal_kernel.py:115-116`, `:161`). The cast's
bfloat16 weights are upcast to float32 by the wrapper (exact; [C, C]
each), so the kernel's weights stay float. `neighborhood_attention_ref(
..., out_dtype=)` spells that out. In eval the upcast weights are made
once per weight version (`_cuda.weight_layout`). Under a recorded
gradient (the zoo's blanket `mixed_precision` training, as the JAX
package trains MDCUN through its kernel's `custom_vjp` on bf16 operands,
`lgteun_tpu/ops/nonlocal_kernel.py:119-137`) the bf16 entry trains as
the float32 one does: the kernel forward, the plain version's backward
recomputed from the saved bf16 inputs (`_train_entry`). The weights'
upcast then happens inside the recorded function, in the kernel's
closure and again in the plain version, so that the bf16 weights, and
through their cast the float32 masters, get their gradients.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.autograd import recompute

__all__ = ["neighborhood_attention", "neighborhood_attention_ref",
           "neighborhood_attention_branch"]

_TILE = 16                  # csrc/neighborhood_attention.cu kT (fp32)
_RUNS = 4                   # kRuns: 16-query runs a block (tc)
_RUN = 16                   # kRun
_KEYS = 32                  # kKeys: keys of a chunk
_MAX_C = 32                 # largest channel count the kernel is built for
_SMEM_MAX = 232448          # bytes of shared memory a block may use


def neighborhood_attention_ref(x, wt, wp, wg, ww, fs: int = 15,
                               out_dtype=None):
    """Plain version with F.unfold (mirrors the reference's blockNL); a
    bfloat16 x and weights upcast, the result rounded once to
    `out_dtype` (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    x, wt, wp, wg, ww = map(upcast, (x, wt, wp, wg, ww))
    b, c, h, w = x.shape
    pw = lambda t, m: F.conv2d(t, m[:, :, None, None])
    theta, phi, g = pw(x, wt), pw(x, wp), pw(x, wg)
    unfold = lambda t: F.unfold(t, fs, padding=fs // 2).view(
        b, c, fs * fs, h, w)
    att = torch.einsum("bchw,bcfhw->bfhw", theta, unfold(phi)).softmax(dim=1)
    out = torch.einsum("bfhw,bcfhw->bchw", att, unfold(g))
    return (pw(out, ww) + x).to(out_dtype)


def _smem_bytes(c: int, fs: int) -> int:
    """Shared memory of one block of the FP32-core branch
    (csrc/neighborhood_attention.cu::na_fp32_floats)."""
    e = _TILE + 2 * (fs // 2)
    return 4 * (2 * c * e * e + 4 * c * c)


def _tc_smem_bytes(c: int, fs: int) -> int:
    """Shared memory of one block of the tensor-core branch, at 4 runs a
    block (csrc/neighborhood_attention.cu::na_tc_floats): the four
    weights zero-padded to [CP][CP], phi and g over 4 + fs - 1 rows and
    32-key chunks at a channel stride of CP + 4 (CP: C rounded up to 8,
    16 or 32)."""
    cp = 8 if c <= 8 else 16 if c <= 16 else 32
    chunks = -(-(_RUN + fs - 1) // _KEYS)
    region = (_RUNS + fs - 1) * _KEYS * chunks * (cp + 4)
    return 4 * (4 * cp * cp + 2 * region)


def neighborhood_attention_branch(c: int, fs: int) -> str:
    """The branch the kernel takes for C channels and window fs: "tc"
    where the tensor-core staging fits shared memory, else "fp32" (the
    library's rule, `lgteun_neighborhood_attention_tc`)."""
    return "tc" if _tc_smem_bytes(c, fs) <= _SMEM_MAX else "fp32"


def neighborhood_attention(x, wt, wp, wg, ww, fs: int = 15):
    """x [B, C, H, W] f32 or bf16 (the result of x's dtype), weights
    [C, C] (out, in) of x's dtype or float32, odd fs. On a CUDA tensor
    the kernel's forward, differentiable through `ops.autograd.recompute`
    (`_train_entry`) in either dtype."""
    if _cuda.plain_on_cpu("neighborhood_attention", x):
        return neighborhood_attention_ref(x, wt, wp, wg, ww, fs)
    b, c, h, w = x.shape
    mats = {"wt": wt, "wp": wp, "wg": wg, "ww": ww}
    bad = [k for k, m in mats.items() if tuple(m.shape) != (c, c)]
    branch = neighborhood_attention_branch(c, fs)
    if bad or fs % 2 == 0 or c > _MAX_C or (
            branch == "fp32" and _smem_bytes(c, fs) > _SMEM_MAX):
        raise ValueError(f"neighborhood_attention: need [C, C] weights, odd "
                         f"fs, C <= {_MAX_C} and at most {_SMEM_MAX} B of "
                         f"shared memory (x {tuple(x.shape)}, fs {fs}, "
                         f"{_smem_bytes(c, fs)} B); bad: {bad}")
    if x.dtype == torch.bfloat16 and not _cuda.records_grad(
            x, wt, wp, wg, ww):
        mats = _cuda.weight_layout("na_float32", (wt, wp, wg, ww), lambda: [
            upcast(m).contiguous() for m in (wt, wp, wg, ww)])
        return _na_kernel(x, *mats, fs)
    return _train_entry(x, wt, wp, wg, ww, fs)


def _train_entry(x, wt, wp, wg, ww, fs: int):
    """`_na_kernel` forward, `neighborhood_attention_ref`'s backward
    recomputed from the saved inputs; `fs` rides in the closures, and
    bf16 weights are upcast in both (float32 ones pass as they are)."""
    return recompute(lambda x, *w: _na_kernel(x, *map(upcast, w), fs),
                     lambda *t: neighborhood_attention_ref(*t, fs),
                     x, wt, wp, wg, ww)


def _na_kernel(x, wt, wp, wg, ww, fs: int):
    """One launch of `csrc/neighborhood_attention.cu` (no backward of its
    own): the float32 entry, or the bf16 one on a bf16 x (weights
    float32)."""
    b, c, h, w = x.shape
    bf16 = x.dtype == torch.bfloat16
    _cuda.check_cuda("neighborhood_attention", x.device,
                     (torch.bfloat16,) if bf16 else (torch.float32,), x=x)
    _cuda.check_cuda_f32("neighborhood_attention", x.device, wt=wt, wp=wp,
                         wg=wg, ww=ww)
    out = torch.empty_like(x)
    _cuda.launch("lgteun_neighborhood_attention_bf16" if bf16 else
                 "lgteun_neighborhood_attention", x.device, x, wt, wp, wg,
                 ww, out, b, c, h, w, fs)
    neighborhood_attention.launches += 1
    neighborhood_attention.variants[neighborhood_attention_branch(c, fs)] \
        += 1
    return out


neighborhood_attention.launches = 0
neighborhood_attention.variants = collections.Counter()
