"""INNT's patch search and transfer on pre-normalised unfolds.

Counterpart of `lgteun_tpu/ops/patch_match_kernel.py::fused_patch_match`
(Pallas) and `patch_match_xla` (its plain version); reference
INNT.py:100-143 without the unfold, norm and fold around it:

    R[n, i, j] = ref_n[n, i] . lr_n[n, j]
    S[n, j]    = max_i R[n, i, j];  idx = the first i reaching it
    T[n, :, j] = ref_u[n, :, idx]

`patch_match` launches `csrc/texture_match.cu` (the same search bodies
as `texture_match`) for a CUDA tensor, differentiable there
(`ops.autograd.recompute`), and runs `patch_match_ref` for a CPU
tensor. Its branches ("tc": tensor cores where K <= SEARCH_KP and
the staged refs fit; "fp32" otherwise) are chosen by shape
(`patch_match_branch`) and counted in `patch_match.variants`.

Storage (INNT's eval forward on the LGTEUN_FUSED_TM=0 route under
`LGTEUN_EVAL_DTYPE=bf16`): lr_n, ref_n and ref_u may all be bfloat16;
then T and S are bfloat16 too. The inputs are upcast exactly, the search
runs in float32, S is rounded once to nearest even and T copies the
bfloat16 ref values, as the Pallas kernel stores them
(`lgteun_tpu/ops/patch_match_kernel.py:77`, `:108`);
`patch_match_ref(..., out_dtype=)` spells that out. Under a recorded
gradient (the zoo's blanket `mixed_precision` training) the bf16 entry
trains as the float32 one: its forward, `patch_match_ref`'s backward on
the saved bf16 inputs. JAX's Pallas kernel refuses a bf16 output
(ROADMAP C.40), so this route cannot train under the cast on JAX's TPU
(`lgteun_tpu/models/innt.py:55-95`); the port's entry rounds S once on
store, as the texture match does.
"""

from __future__ import annotations

import collections

import torch

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.texture_match_kernel import SEARCH_KP, search_pad

__all__ = ["patch_match", "patch_match_ref", "patch_match_branch"]

_MAX_K = 72                 # longest sub-patch vector the kernel is built for
_SMEM_MAX = 232448          # bytes of shared memory a block may use


def patch_match_ref(lr_n, ref_n, ref_u, out_dtype=None):
    """Plain version with bmm / max / gather; bfloat16 inputs upcast,
    (T, S) rounded once to `out_dtype` (default lr_n's dtype)."""
    out_dtype = out_dtype or lr_n.dtype
    lr_n, ref_n, ref_u = upcast(lr_n), upcast(ref_n), upcast(ref_u)
    r = torch.bmm(ref_n, lr_n.transpose(1, 2))    # [N, L(ref), L(query)]
    s, idx = r.max(dim=1)
    t = torch.gather(ref_u, 2, idx[:, None, :].expand(-1, ref_u.shape[1], -1))
    return t.to(out_dtype), s.to(out_dtype)


def _smem_bytes(k: int, ll: int) -> int:
    """Shared memory of one FP32-core block: the ref vectors padded to 36
    or 72. The shapes where it fits are the kernel's."""
    return 4 * ll * (36 if k <= 36 else 72)


def patch_match_branch(k: int, ll: int) -> str:
    """"tc" where the kernel searches on the tensor cores (K <= SEARCH_KP
    and the staged hi/lo refs [search_pad(L)][SEARCH_KP] x 2 and the
    indices fit in shared memory), else "fp32" (csrc/texture_match.cu,
    `pm_tc_takes`)."""
    smem = 4 * (2 * search_pad(ll) * SEARCH_KP + ll)
    return "tc" if k <= SEARCH_KP and smem <= _SMEM_MAX else "fp32"


def patch_match(lr_n, ref_n, ref_u):
    """lr_n, ref_n [N, L, K], ref_u [N, K, L] f32 (or all bf16) ->
    (T [N, K, L], S [N, L]) of lr_n's dtype. On a CUDA tensor the
    kernel's forward, differentiable through `ops.autograd.recompute`
    (float32; the backward searches again with `patch_match_ref`, as the
    JAX package's `_fused_pm_bwd`)."""
    if _cuda.plain_on_cpu("patch_match", lr_n):
        return patch_match_ref(lr_n, ref_n, ref_u)
    n, ll, k = lr_n.shape
    if tuple(ref_n.shape) != (n, ll, k) or tuple(ref_u.shape) != (n, k, ll) \
            or k > _MAX_K or _smem_bytes(k, ll) > _SMEM_MAX:
        raise ValueError(f"patch_match: need lr_n, ref_n [N, L, K] and "
                         f"ref_u [N, K, L] with K <= {_MAX_K} and at most "
                         f"{_SMEM_MAX} B of shared memory (lr_n "
                         f"{tuple(lr_n.shape)}, ref_n {tuple(ref_n.shape)}, "
                         f"ref_u {tuple(ref_u.shape)})")
    return _train_entry(lr_n, ref_n, ref_u)


def _train_entry(lr_n, ref_n, ref_u):
    """`_pm_kernel` forward, `patch_match_ref`'s backward recomputed from
    the saved inputs; three inputs, the raw unfold `ref_u` among them."""
    return recompute(lambda *t: _pm_kernel(*t), patch_match_ref, lr_n,
                     ref_n, ref_u)


def _pm_kernel(lr_n, ref_n, ref_u):
    """One launch of `csrc/texture_match.cu`'s patch match (no backward of
    its own): the float32 entry, or the bf16 one on bf16 inputs."""
    n, ll, k = lr_n.shape
    bf16 = lr_n.dtype == torch.bfloat16
    _cuda.check_cuda("patch_match", lr_n.device,
                     (torch.bfloat16,) if bf16 else (torch.float32,),
                     lr_n=lr_n, ref_n=ref_n, ref_u=ref_u)
    t = torch.empty_like(ref_u)
    s = lr_n.new_empty(n, ll)
    _cuda.launch("lgteun_patch_match_bf16" if bf16 else "lgteun_patch_match",
                 lr_n.device, lr_n, ref_n, ref_u, t, s, n, ll, k)
    patch_match.launches += 1
    patch_match.variants[patch_match_branch(k, ll)] += 1
    return t, s


patch_match.launches = 0
patch_match.variants = collections.Counter()
