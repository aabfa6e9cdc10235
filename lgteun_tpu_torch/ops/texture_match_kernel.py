"""INNT's whole-chain texture match on channel-major patch images
[N, C, side*side].

Counterpart of `lgteun_tpu/ops/texture_match_kernel.py::
fused_texture_match` (Pallas) and `texture_match_xla` (its plain
version); reference INNT.py:100-143. Per patch-image:

    lr_u, ref_u = unfold3x3(lr), unfold3x3(ref)      (zero padding 1)
    lr_n, ref_n = u / (||u||_2 + 1e-12)              (per sub-patch)
    R[i, j]     = ref_n[i] . lr_n[j]                 ([side², side²])
    s[j]        = max_i R[i, j];  idx[j] = first i reaching it
    t           = fold3x3(ref_u[:, idx]) / 9         (raw ref sub-patches)

`texture_match` launches `csrc/texture_match.cu` for a CUDA tensor,
differentiable there (`ops.autograd.recompute`: the kernel forward, the
plain version's backward recomputed from the saved inputs, search
included), and runs `texture_match_ref` for a CPU tensor. The kernel has two branches,
chosen by shape (`texture_match_branch`) and counted in
`texture_match.variants`: "tc", the search on the tensor cores (wgmma
TF32, 3xTF32 split, the first maximum from the accumulators), where 9C
<= SEARCH_KP and its shared memory fits (INNT's C = 4 at side 24), and
"fp32", the search on the FP32 cores, for every other shape.

Storage (INNT's eval forward under `LGTEUN_EVAL_DTYPE=bf16`, the JAX
package's blanket cast): lr and ref may be bfloat16, wherever float32 is
taken; then t and s are bfloat16 too. The inputs are upcast exactly, the
normalisation, search and transfer run in float32 (the kernel's 3xTF32
split stays: the normalised vectors are not exact in TF32), and t and s
are rounded once to nearest even as stored, as the Pallas kernel does
(`lgteun_tpu/ops/texture_match_kernel.py:112-113`, `:193`).
`texture_match_ref` spells that out (`out_dtype`: the float32 value
before the rounding with torch.float32). Under a recorded gradient
(the zoo's blanket `mixed_precision` training) the bf16 entry trains as
the float32 one: its forward, `texture_match_ref`'s backward on the
saved bf16 inputs (`_train_entry`).
"""

from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.autograd import recompute

__all__ = ["texture_match", "texture_match_ref", "row_normalize",
           "texture_match_branch", "search_pad", "SEARCH_KP", "SEARCH_TILE"]

_MAX_C = 8                  # largest channel count the kernel is built for
_SMEM_MAX = 232448          # bytes of shared memory a block may use
SEARCH_KP = 40              # tensor-core branch: vectors zero-padded to 40
SEARCH_TILE = 64            # ... queries a warpgroup tile, refs a chunk


def row_normalize(u: torch.Tensor, dim: int) -> torch.Tensor:
    """u / (||u||_2 + 1e-12) along `dim` (the reference's divide; an
    all-zero sub-patch stays exactly 0)."""
    return u / (torch.linalg.vector_norm(u, dim=dim, keepdim=True) + 1e-12)


def _side(q: int) -> int:
    side = math.isqrt(q)
    if side * side != q:
        raise ValueError(f"texture_match: {q} pixels is not a square image")
    return side


def texture_match_ref(lr, ref, out_dtype=None):
    """Plain version with F.unfold / bmm / max / gather / F.fold; bfloat16
    inputs upcast, (t, s) rounded once to `out_dtype` (default lr's
    dtype)."""
    out_dtype = out_dtype or lr.dtype
    lr, ref = upcast(lr), upcast(ref)
    n, c, q = lr.shape
    side = _side(q)
    unfold = lambda v: F.unfold(v.reshape(n, c, side, side), 3, padding=1)
    lr_u, ref_u = unfold(lr), unfold(ref)                   # [N, 9C, Q]
    r = torch.bmm(row_normalize(ref_u, 1).transpose(1, 2),
                  row_normalize(lr_u, 1))                   # [N, ref, query]
    s, idx = r.max(dim=1)
    t_u = torch.gather(ref_u, 2, idx[:, None, :].expand(-1, 9 * c, -1))
    t = F.fold(t_u, (side, side), 3, padding=1) / 9.0
    return t.reshape(n, c, q).to(out_dtype), s.to(out_dtype)


def _smem_bytes(c: int, q: int) -> int:
    """Shared memory of one FP32-core block (csrc/texture_match.cu): the
    raw lr and ref planes, the normalised ref unfold padded to 36 or 72
    values a row, and the chosen index per query. The shapes where it
    fits are the kernel's."""
    kp = 36 if 9 * c <= 36 else 72
    return 4 * (2 * c * q + q * kp + q)


def search_pad(n: int) -> int:
    """n vectors rounded up to whole tensor-core chunks of SEARCH_TILE."""
    return -(-n // SEARCH_TILE) * SEARCH_TILE


def texture_match_branch(c: int, side: int) -> str:
    """"tc" where the kernel searches on the tensor cores (9C <= SEARCH_KP
    and the staged hi/lo refs [search_pad(Q)][SEARCH_KP] x 2, the two
    planes, the query norms and the indices fit in shared memory), else
    "fp32" (csrc/texture_match.cu, `tm_tc_takes`)."""
    q = side * side
    smem = 4 * (2 * search_pad(q) * SEARCH_KP + 2 * c * q + 2 * q)
    return "tc" if 9 * c <= SEARCH_KP and smem <= _SMEM_MAX else "fp32"


def texture_match(lr, ref):
    """lr, ref [N, C, side*side] f32 (or both bf16) -> (t [N, C,
    side*side], s [N, side*side]) of lr's dtype. On a CUDA tensor the
    kernel's forward, differentiable through `ops.autograd.recompute`
    (float32): the backward runs `texture_match_ref` again, whose search
    may pick another ref than the kernel did at a float64 near tie, as
    the JAX package's `_fused_tm_bwd` does."""
    if _cuda.plain_on_cpu("texture_match", lr):
        return texture_match_ref(lr, ref)
    n, c, q = lr.shape
    _side(q)
    if tuple(ref.shape) != (n, c, q) or c > _MAX_C \
            or _smem_bytes(c, q) > _SMEM_MAX:
        raise ValueError(f"texture_match: need lr and ref of one shape, "
                         f"C <= {_MAX_C} and at most {_SMEM_MAX} B of shared "
                         f"memory (lr {tuple(lr.shape)}, ref "
                         f"{tuple(ref.shape)}, {_smem_bytes(c, q)} B)")
    return _train_entry(lr, ref)


def _train_entry(lr, ref):
    """`_tm_kernel` forward, `texture_match_ref`'s backward recomputed
    from the saved inputs; two outputs, (t, s); float32 or bf16 (the
    blanket `mixed_precision` training, as JAX trains its kernel's
    `custom_vjp` on bf16 operands, `lgteun_tpu/ops/
    texture_match_kernel.py:157-175`)."""
    return recompute(lambda *t: _tm_kernel(*t), texture_match_ref, lr, ref)


def _tm_kernel(lr, ref):
    """One launch of `csrc/texture_match.cu` (no backward of its own): the
    float32 entry, or the bf16 one on bf16 lr and ref."""
    n, c, q = lr.shape
    side = _side(q)
    bf16 = lr.dtype == torch.bfloat16
    _cuda.check_cuda("texture_match", lr.device,
                     (torch.bfloat16,) if bf16 else (torch.float32,),
                     lr=lr, ref=ref)
    t = torch.empty_like(lr)
    s = lr.new_empty(n, q)
    _cuda.launch("lgteun_texture_match_bf16" if bf16 else
                 "lgteun_texture_match", lr.device, lr, ref, t, s, n, c,
                 side)
    texture_match.launches += 1
    texture_match.variants[texture_match_branch(c, side)] += 1
    return t, s


texture_match.launches = 0
texture_match.variants = collections.Counter()
