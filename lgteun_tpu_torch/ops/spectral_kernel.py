"""LGB mixer head (channel LayerNorm, split, FFT amp/phase global mixer)
and the global mixer alone.

Counterparts of `lgteun_tpu/ops/spectral_kernel.py::fused_ln_mixer_head_cm`
and `fused_global_mixer_cm` (Pallas), and of `ln_mixer_head_xla_cm` and
`global_mixer_xla_cm` (their plain versions):

    y  = LN(x)                       channel LayerNorm per pixel, eps 1e-5
    y1 = y[:, :C/2]                  -> window attention
    x2 = |irfft2(amp'cos(pha') + 2e-8, amp'sin(pha') + 1e-8)|
         with amp, pha = |rfft2(y[:, C/2:])|, angle(...) (0 at zero bins)
         and amp' = amp*amp_w + amp_b, pha' = pha*pha_w + pha_b

`ln_mixer_head` and `global_mixer` launch `csrc/spectral_head.cu` for a
CUDA tensor, differentiable there (`ops.autograd.recompute`: the kernel
forward, the plain version's backward), and run `ln_mixer_head_ref` /
`global_mixer_ref` for a CPU tensor. The kernel holds one complex plane in shared memory, so it takes
any even H, W (2^a * odd, a >= 1, the odd part at most 512) whose plane
fits: 8 * (H*W + H + W + odd(H) + odd(W)) + 4 * (W/2 + 1) bytes <=
232,448 (the H100's shared memory a block), e.g. 168 x 168; beyond that
the wrappers raise.

Branch cut: bins with exactly zero imaginary part and a negative real
part have phase +-pi by the sign of that zero, and the learned phase
scale turns the 2*pi ambiguity into a value change. The kernel and the
plain version both add +0.0 to the imaginary part first, which maps -0
to +0, so both land on +pi (as numpy/torch and the JAX kernel's atan2).
"""

from __future__ import annotations

import torch

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["ln_mixer_head", "ln_mixer_head_ref", "global_mixer",
           "global_mixer_ref"]

# shared memory one block may hold on the H100 (227 KB)
FFT_SMEM_BYTES = 232_448


def global_mixer_ref(x: torch.Tensor, amp_w: torch.Tensor,
                     amp_b: torch.Tensor, pha_w: torch.Tensor,
                     pha_b: torch.Tensor) -> torch.Tensor:
    """Plain FFT amp/phase mixer on [B, C, H, W] (reference
    LGT.py:149-180, epsilons and zero-bin convention included).

    Written so that every FFT backend gives the same values as pocketfft
    on the CPU: the self-conjugate bins of a real input are set exactly
    real (cuFFT can leave rounding noise there, which moves the phase
    across the branch cut), and the inverse is an explicit H inverse
    followed by a c2r along W that drops the imaginary parts of bins 0
    and W/2 (irfft2's semantics; cuFFT's 2-D c2r is undefined for the
    non-hermitian spectrum the mixer makes).

    The gradient stays finite at exactly zero bins (a constant plane):
    the double `where` hands |z| and angle(z) a safe point there, as
    `lgteun_tpu/models/common/lgt.py:173-181` does (ROADMAP C.2)."""
    h, w = x.shape[-2:]
    z = torch.fft.rfft2(x, norm="backward")
    re, im = z.real, z.imag.clone()
    for r in {0, h // 2} if h % 2 == 0 else {0}:
        for c in {0, w // 2} if w % 2 == 0 else {0}:
            im[..., r, c] = 0.0
    im = im + 0.0
    zero = (re == 0.0) & (im == 0.0)
    re_s = torch.where(zero, torch.ones_like(re), re)
    im_s = torch.where(zero, torch.zeros_like(im), im)
    amp = torch.where(zero, torch.zeros_like(re),
                      torch.sqrt(re_s * re_s + im_s * im_s))
    pha = torch.where(zero, torch.zeros_like(re), torch.atan2(im_s, re_s))
    col = lambda v: v[None, :, None, None]
    amp = amp * col(amp_w) + col(amp_b)
    pha = pha * col(pha_w) + col(pha_b)
    real = amp * torch.cos(pha) + 1e-8 + 1e-8
    imag = amp * torch.sin(pha) + 1e-8
    mid = torch.fft.ifft(torch.complex(real, imag), dim=-2, norm="backward")
    mid_im = mid.imag.clone()
    mid_im[..., 0] = 0.0
    if w % 2 == 0:
        mid_im[..., w // 2] = 0.0
    return torch.fft.irfft(torch.complex(mid.real, mid_im), n=w, dim=-1,
                           norm="backward").abs()


def ln_mixer_head_ref(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                      eps: float = 1e-5):
    """Plain version of the mixer head -> (y1, x2), each [B, C/2, H, W]."""
    y = channel_layer_norm(x, ln_w, ln_b, eps)
    c2 = x.shape[1] // 2
    return y[:, :c2], global_mixer_ref(y[:, c2:], amp_w, amp_b, pha_w, pha_b)


def _check_plane(name: str, x: torch.Tensor) -> None:
    """Raise unless the mixer kernel takes x's [H, W] planes."""
    h, w = x.shape[-2:]
    odd = lambda n: n // (n & -n)
    smem = 8 * (h * w + h + w + odd(h) + odd(w)) + 4 * (w // 2 + 1)
    if h % 2 or w % 2 or odd(h) > 512 or odd(w) > 512 \
            or smem > FFT_SMEM_BYTES:
        raise ValueError(
            f"{name}: the FFT kernel holds one complex plane in shared "
            f"memory and needs even H, W (odd part <= 512) with "
            f"8 * (H*W + H + W + odd(H) + odd(W)) + 4 * (W/2 + 1) <= "
            f"{FFT_SMEM_BYTES} bytes, got {tuple(x.shape)} ({smem} bytes)")


def ln_mixer_head(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                  eps: float = 1e-5):
    """Mixer head on [B, C, H, W] -> (y1, x2), each [B, C/2, H, W].
    ln_w/ln_b: [C]; amp_w/amp_b/pha_w/pha_b: [C/2]."""
    if _cuda.plain_on_cpu("ln_mixer_head", x):
        return ln_mixer_head_ref(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                                 eps)

    def kernel(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b):
        b, c, h, w = x.shape
        c2 = c // 2
        if c % 2:
            raise ValueError(f"ln_mixer_head: need even C, got "
                             f"{tuple(x.shape)}")
        _check_plane("ln_mixer_head", x)
        if ln_w.shape != (c,) or ln_b.shape != (c,) or any(
                p.shape != (c2,) for p in (amp_w, amp_b, pha_w, pha_b)):
            raise ValueError("ln_mixer_head: parameter shapes do not match "
                             "C")
        _cuda.check_cuda_f32("ln_mixer_head", x.device, x=x, ln_w=ln_w,
                             ln_b=ln_b, amp_w=amp_w, amp_b=amp_b,
                             pha_w=pha_w, pha_b=pha_b)
        y1 = torch.empty((b, c2, h, w), device=x.device, dtype=x.dtype)
        x2 = torch.empty_like(y1)
        _cuda.launch("lgteun_ln_mixer_head", x.device, x, ln_w, ln_b, amp_w,
                     amp_b, pha_w, pha_b, y1, x2, b, c, h, w, eps)
        ln_mixer_head.launches += 1
        return y1, x2

    return recompute(kernel, lambda *t: ln_mixer_head_ref(*t, eps), x, ln_w,
                     ln_b, amp_w, amp_b, pha_w, pha_b)


ln_mixer_head.launches = 0


def global_mixer(x, amp_w, amp_b, pha_w, pha_b):
    """FFT amp/phase mixer on [B, C, H, W] -> [B, C, H, W] (same
    contract as `global_mixer_ref`); amp_w/amp_b/pha_w/pha_b: [C]."""
    if _cuda.plain_on_cpu("global_mixer", x):
        return global_mixer_ref(x, amp_w, amp_b, pha_w, pha_b)

    def kernel(x, amp_w, amp_b, pha_w, pha_b):
        b, c, h, w = x.shape
        _check_plane("global_mixer", x)
        if any(p.shape != (c,) for p in (amp_w, amp_b, pha_w, pha_b)):
            raise ValueError("global_mixer: parameter shapes do not match C")
        _cuda.check_cuda_f32("global_mixer", x.device, x=x, amp_w=amp_w,
                             amp_b=amp_b, pha_w=pha_w, pha_b=pha_b)
        out = torch.empty_like(x)
        _cuda.launch("lgteun_global_mixer", x.device, x, amp_w, amp_b, pha_w,
                     pha_b, out, b, c, h, w)
        global_mixer.launches += 1
        return out

    return recompute(kernel, global_mixer_ref, x, amp_w, amp_b, pha_w, pha_b)


global_mixer.launches = 0
