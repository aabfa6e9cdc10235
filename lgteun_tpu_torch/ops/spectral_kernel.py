"""LGB mixer head: channel LayerNorm, split, FFT amp/phase global mixer.

Counterpart of `lgteun_tpu/ops/spectral_kernel.py::fused_ln_mixer_head_cm`
(Pallas) and `ln_mixer_head_xla_cm` (its plain version):

    y  = LN(x)                       channel LayerNorm per pixel, eps 1e-5
    y1 = y[:, :C/2]                  -> window attention
    x2 = |irfft2(amp'cos(pha') + 2e-8, amp'sin(pha') + 1e-8)|
         with amp, pha = |rfft2(y[:, C/2:])|, angle(...) (0 at zero bins)
         and amp' = amp*amp_w + amp_b, pha' = pha*pha_w + pha_b

`ln_mixer_head` launches `csrc/spectral_head.cu` for a CUDA tensor and
runs `ln_mixer_head_ref` for a CPU tensor.

Branch cut: bins with exactly zero imaginary part and a negative real
part have phase +-pi by the sign of that zero, and the learned phase
scale turns the 2*pi ambiguity into a value change. The kernel and the
plain version both add +0.0 to the imaginary part first, which maps -0
to +0, so both land on +pi (as numpy/torch and the JAX kernel's atan2).
"""

from __future__ import annotations

import torch

from lgteun_tpu_torch.ops import _cuda
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["ln_mixer_head", "ln_mixer_head_ref", "global_mixer_ref"]


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
    non-hermitian spectrum the mixer makes)."""
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


def _pow2(n: int) -> bool:
    return n >= 2 and n & (n - 1) == 0


def ln_mixer_head(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                  eps: float = 1e-5):
    """Mixer head on [B, C, H, W] -> (y1, x2), each [B, C/2, H, W].
    ln_w/ln_b: [C]; amp_w/amp_b/pha_w/pha_b: [C/2]."""
    if x.device.type == "cpu":
        return ln_mixer_head_ref(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                                 eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mixer_head: unsupported device {x.device}")
    b, c, h, w = x.shape
    c2 = c // 2
    if c % 2 or not (_pow2(h) and _pow2(w)) or h * w > 128 * 128:
        raise ValueError(f"ln_mixer_head: need even C and power-of-two "
                         f"H, W with H*W <= 16384, got {tuple(x.shape)}")
    if ln_w.shape != (c,) or ln_b.shape != (c,) or any(
            p.shape != (c2,) for p in (amp_w, amp_b, pha_w, pha_b)):
        raise ValueError("ln_mixer_head: parameter shapes do not match C")
    _cuda.check_cuda_f32("ln_mixer_head", x.device, x=x, ln_w=ln_w,
                         ln_b=ln_b, amp_w=amp_w, amp_b=amp_b, pha_w=pha_w,
                         pha_b=pha_b)
    y1 = torch.empty((b, c2, h, w), device=x.device, dtype=x.dtype)
    x2 = torch.empty_like(y1)
    _cuda.launch("lgteun_ln_mixer_head", x.device, x, ln_w, ln_b, amp_w,
                 amp_b, pha_w, pha_b, y1, x2, b, c, h, w, eps)
    ln_mixer_head.launches += 1
    return y1, x2


ln_mixer_head.launches = 0
