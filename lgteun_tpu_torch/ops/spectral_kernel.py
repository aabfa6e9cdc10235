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
`global_mixer_ref` for a CPU tensor. The kernel takes every H from 2 to
14,514 and every W from 2 to 29,026 (odd W to 14,513), at any
factorization (FFT_MAX_H, FFT_MAX_W, FFT_MAX_W_ODD; `_check_plane`
raises beyond them), by one of three routes chosen by the plane's shape
(`mixer_route`): where the half spectrum fits one block's shared memory,
112 + 8 * (H * ld + gbuf) bytes (the plan, the half spectrum, the line
buffer of a radix above 512) <= 232,448 (the H100's), ld = W/2 + 1
rounded up to odd (odd W: ld = W; up to 240 x 240), one block (or a
cluster of two) holds a plane ("smem"); above that, a thread-block
cluster of the smallest K of 2, 4, 8, 16 whose blocks each hold H / K
rows of the half spectrum and a stage of columns runs it in one launch
("cluster", `fft_cluster_plan`: 256^2 and 264^2 at K = 2, 512^2 at K =
8, 1024 x 512 at K = 16); a plane no cluster holds (1024^2 and up) takes
the global route, which keeps the half spectra in a scratch the wrapper
allocates, column by column, and runs the same plan in three launches
over ranges of rows and columns ("global", `fft_global_plan`). Even W
reads a row as W/2 complex points; odd W transforms it as W complex
points with imaginary part 0; a prime factor above 512 takes a direct
pass, its twiddles in a line buffer of that length in shared memory
(planes of odd width or with such a factor run kernels of their own,
`csrc/spectral_head_any.cu`). Its plan, twiddle and position tables are
made once per (H, W) and device (`fft_tables`).
`fft_plan` / `fft_mixer_plan` / `fft_cluster_plan` / `fft_global_plan`
mirror the kernel's plans (`csrc/fft_mixer.cuh`) and `fft_tables_ref`
its tables, for the tests and for `chip_smoke.py`, which holds the
card's tables and routes to them. The wrappers count their launches by
the layout the kernel picks (`mixer_variant`, `variants`: "pair",
"block512", "block256", "cluster" or "global").

Storage (`ops.storage_dtype`): x may be float32 or bfloat16, and the
head's y1 and x2, and the mixer's output, float32 or bfloat16
(`out_dtype`; default x's dtype: (float32, float32), (float32, bfloat16)
or (bfloat16, bfloat16)). A bfloat16 input is upcast as loaded, all math
is float32 (the mixer is fed the LN's float32 value, as the JAX head
kernel does; the level-1 prior feeds `global_mixer` the float32 LN with
a bfloat16 output for the same function, ROADMAP C.35), and each output
is rounded once to nearest even as stored; the plain versions spell
that out. The bfloat16 entries are for eval: given a tensor that needs
a gradient they raise (training runs float32 storage).

Branch cut: bins with exactly zero imaginary part and a negative real
part have phase +-pi by the sign of that zero, and the learned phase
scale turns the 2*pi ambiguity into a value change. The kernel and the
plain version both add +0.0 to the imaginary part first, which maps -0
to +0, so both land on +pi (as numpy/torch and the JAX kernel's atan2).
"""

from __future__ import annotations

import collections

import torch

from lgteun_tpu_torch.ops import _cuda, upcast
from lgteun_tpu_torch.ops.autograd import recompute
from lgteun_tpu_torch.ops.norm import channel_layer_norm

__all__ = ["ln_mixer_head", "ln_mixer_head_ref", "global_mixer",
           "global_mixer_ref", "PLANE_ROUNDING", "plane_rfft2", "amp_phase",
           "safe_amp_phase",
           "mixer_spectrum", "mixer_inverse", "fft_plan", "fft_pos",
           "fft_mixer_plan", "fft_cluster_plan", "fft_global_plan",
           "global_split",
           "cluster_size", "mixer_route",
           "fft_tables_ref", "fft_tables", "mixer_variant"]

# shared memory one block may hold on the H100 (227 KB)
FFT_SMEM_BYTES = 232_448
# two blocks an SM hold half of it each (fft_mixer.cuh: kFftGlobalSmem)
FFT_GLOBAL_SMEM = FFT_SMEM_BYTES // 2
# the cluster route's sizes (fft_mixer.cuh: kFftMaxCluster; 16 is a
# non-portable cluster size, which the H100 has)
FFT_CLUSTERS = (2, 4, 8, 16)
H100_SMS = 132            # streaming multiprocessors of the H100 SXM
FFT_MAX_PASS = 8          # fft_mixer.cuh: kFftMaxPass
# kFftMaxPrime: a larger radix takes fft_pass_prime, its twiddles in a
# line buffer of shared memory (`gbuf`)
FFT_MAX_PRIME = 512
# kFftMaxH, kFftMaxW, kFftMaxWOdd: the largest sides, at any
# factorization (the global route holds a row and a column of each)
FFT_MAX_H, FFT_MAX_W, FFT_MAX_W_ODD = 14_514, 29_026, 14_513
FFT_PLAN_FLOATS = 28      # kFftPlanFloats: the plan at the tables' head


# a plane's rows (columns) count as equal within this share of its
# largest value: float32 rounding apart
PLANE_ROUNDING = 2.0 ** -20


def plane_rfft2(x: torch.Tensor) -> torch.Tensor:
    """rfft2 of the planes of [B, C, H, W] with the bins of a plane whose
    rows (or columns) are all equal, within PLANE_ROUNDING of its largest
    value, set exactly zero: every bin off H-bin 0 (off W-bin 0). Those
    bins are zero in exact arithmetic, or rounding noise; a CPU run may
    leave such a plane's rows a rounding apart or its FFT library noise
    in those bins, differently on different hosts and runs, and the mixer
    would carry the noise's phase into the output (ROADMAP C.33). The
    kernel's butterflies give those zeros exactly on equal rows."""
    z = torch.fft.rfft2(x, norm="backward")
    h, half = z.shape[-2:]
    tol = PLANE_ROUNDING * x.abs().amax((-2, -1), keepdim=True)
    rows_equal = ((x - x[..., :1, :]).abs() <= tol).flatten(-2).all(-1)[
        ..., None, None]
    cols_equal = ((x - x[..., :, :1]).abs() <= tol).flatten(-2).all(-1)[
        ..., None, None]
    off_h0 = (torch.arange(h, device=x.device) != 0)[:, None]
    off_w0 = (torch.arange(half, device=x.device) != 0)[None, :]
    return z.masked_fill(rows_equal & off_h0 | cols_equal & off_w0, 0)


def global_mixer_ref(x: torch.Tensor, amp_w: torch.Tensor,
                     amp_b: torch.Tensor, pha_w: torch.Tensor,
                     pha_b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain FFT amp/phase mixer on [B, C, H, W] (reference
    LGT.py:149-180, epsilons and zero-bin convention included); a
    bfloat16 x upcast, the result rounded once to `out_dtype` (default
    x's dtype).

    Written so that every FFT backend gives the same values as pocketfft
    on the CPU: the exact zero bins of planes constant along an axis are
    exactly zero (`plane_rfft2`), the self-conjugate bins of a real input
    are set exactly
    real (cuFFT can leave rounding noise there, which moves the phase
    across the branch cut), and the inverse is an explicit H inverse
    followed by a c2r along W that drops the imaginary parts of bins 0
    and W/2 (irfft2's semantics; cuFFT's 2-D c2r is undefined for the
    non-hermitian spectrum the mixer makes).

    The gradient stays finite at exactly zero bins (a constant plane):
    the double `where` hands |z| and angle(z) a safe point there, as
    `lgteun_tpu/models/common/lgt.py:173-181` does (ROADMAP C.2)."""
    w = x.shape[-1]
    spec = mixer_spectrum(plane_rfft2(upcast(x)), w, amp_w, amp_b, pha_w,
                          pha_b)
    return mixer_inverse(spec, w).to(out_dtype or x.dtype)


def amp_phase(z: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(|z|, angle(z)) of the rfft2 `z` [..., H, W//2 + 1] of real planes
    W wide: the self-conjugate bins are set exactly real, with +0.0 as
    their imaginary part where the FFT left -0.0 or rounding noise, so a
    negative real part takes +pi (the branch of XLA's CPU FFT, which
    leaves +0.0 there at power-of-two sides); exactly zero bins get 0 and
    0 with a finite gradient (the double `where`)."""
    h = z.shape[-2]
    re, im = z.real, z.imag.clone()
    for r in {0, h // 2} if h % 2 == 0 else {0}:
        for c in {0, w // 2} if w % 2 == 0 else {0}:
            im[..., r, c] = 0.0
    return safe_amp_phase(re, im + 0.0)


def safe_amp_phase(re: torch.Tensor, im: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(|re + i im|, atan2(im, re)) as they are, 0 and 0 with a finite
    gradient where both are exactly zero (the double `where` of the JAX
    package's `_safe_amp_pha`, `lgteun_tpu/models/sfiin.py:33-41`)."""
    zero = (re == 0.0) & (im == 0.0)
    re_s = torch.where(zero, torch.ones_like(re), re)
    im_s = torch.where(zero, torch.zeros_like(im), im)
    amp = torch.where(zero, torch.zeros_like(re),
                      torch.sqrt(re_s * re_s + im_s * im_s))
    pha = torch.where(zero, torch.zeros_like(re), torch.atan2(im_s, re_s))
    return amp, pha


def mixer_spectrum(z: torch.Tensor, w: int, amp_w: torch.Tensor,
                   amp_b: torch.Tensor, pha_w: torch.Tensor,
                   pha_b: torch.Tensor) -> torch.Tensor:
    """The mixed half spectrum amp' e^(i pha') + (2e-8, 1e-8) of the
    rfft2 `z` [B, C, H, W//2 + 1] of planes W wide (`global_mixer_ref`'s
    middle)."""
    amp, pha = amp_phase(z, w)
    col = lambda v: v[None, :, None, None]
    amp = amp * col(amp_w) + col(amp_b)
    pha = pha * col(pha_w) + col(pha_b)
    real = amp * torch.cos(pha) + 1e-8 + 1e-8
    imag = amp * torch.sin(pha) + 1e-8
    return torch.complex(real, imag)


def mixer_inverse(spec: torch.Tensor, w: int) -> torch.Tensor:
    """|irfft2| of the mixed half spectrum `spec` to planes W wide
    (`global_mixer_ref`'s end): an explicit H inverse, then a c2r along
    W that drops the imaginary parts of bins 0 and W/2."""
    mid = torch.fft.ifft(spec, dim=-2, norm="backward")
    mid_im = mid.imag.clone()
    mid_im[..., 0] = 0.0
    if w % 2 == 0:
        mid_im[..., w // 2] = 0.0
    return torch.fft.irfft(torch.complex(mid.real, mid_im), n=w, dim=-1,
                           norm="backward").abs()


def ln_mixer_head_ref(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                      eps: float = 1e-5, out_dtype=None):
    """Plain version of the mixer head -> (y1, x2), each [B, C/2, H, W]
    of `out_dtype` (default x's dtype): the LN of the upcast x in
    float32, the mixer fed its float32 value, each output rounded once."""
    out_dtype = out_dtype or x.dtype
    y = channel_layer_norm(upcast(x), ln_w, ln_b, eps)
    c2 = x.shape[1] // 2
    return y[:, :c2].to(out_dtype), global_mixer_ref(
        y[:, c2:], amp_w, amp_b, pha_w, pha_b, out_dtype)


def fft_plan(n: int) -> list[int] | None:
    """The radices of the kernel's n-point transform in its forward pass
    order (`fft_mixer.cuh::fft_plan`): the power of two 2^a in ceil(a/4)
    passes as even as they go (larger first), then the odd part as 9s, 3s,
    5s, 7s and its other primes. None beyond FFT_MAX_PASS passes."""
    a, m = 0, n
    while m % 2 == 0:
        m, a = m // 2, a + 1
    odd = []
    for r in (9, 3, 5, 7):
        while m % r == 0 and len(odd) <= FFT_MAX_PASS:
            odd.append(r)
            m //= r
    q = 11
    while m > 1 and len(odd) <= FFT_MAX_PASS:
        if q * q > m:     # m is prime: the kernel's loop reaches q = m
            q = m
        while m % q == 0 and len(odd) <= FFT_MAX_PASS:
            odd.append(q)
            m //= q
        q += 2
    np2 = (a + 3) // 4
    if m > 1 or np2 + len(odd) > FFT_MAX_PASS:
        return None
    return [1 << (a // np2 + (i < a % np2)) for i in range(np2)] + odd


def fft_pos(radices: list[int], n: int, k: int) -> int:
    """Position of bin k after the forward passes `radices` of an n-point
    transform (digit i of k, first pass least significant, weighs n /
    (r_1 ... r_i))."""
    span, pos = n, 0
    for r in radices:
        span //= r
        pos += (k % r) * span
        k //= r
    return pos


def fft_mixer_plan(h: int, w: int) -> dict | None:
    """The kernel's plan of an H x W plane (`fft_mixer.cuh::
    fft_mixer_plan`): row radices (n = W/2 points for even W, W for odd
    W), column radices, row pitch ld (float2), the position qh of H-bin
    H/2 (-1 for odd H), the tables' float offsets and size (the plan
    itself first), the line buffer `gbuf` (the largest radix above
    FFT_MAX_PRIME, else 0), the width `w` and one block's shared memory;
    None beyond FFT_MAX_H, FFT_MAX_W and FFT_MAX_W_ODD (or below 2)."""
    if not (2 <= h <= FFT_MAX_H and 2 <= w <= (FFT_MAX_W_ODD if w % 2
                                                 else FFT_MAX_W)):
        return None
    n = w if w % 2 else w // 2
    row, col = fft_plan(n), fft_plan(h)
    if row is None or col is None:
        return None
    ld = w if w % 2 else n + 1 if (n + 1) % 2 else n + 2
    gbuf = max([r for r in row + col if r > FFT_MAX_PRIME], default=0)
    tw_half = FFT_PLAN_FLOATS + 2 * n
    tw_col = tw_half + (0 if w % 2 else 2 * n + 2)
    return {"row": row, "col": col, "ld": ld,
            "qh": -1 if h % 2 else fft_pos(col, h, h // 2),
            "tw_row": FFT_PLAN_FLOATS, "tw_half": tw_half, "tw_col": tw_col,
            "pos_row": tw_col + 2 * h, "floats": tw_col + 2 * h + n,
            "w": w, "gbuf": gbuf,
            "smem": 4 * FFT_PLAN_FLOATS + 8 * (h * ld + gbuf)}


# fft_mixer.cuh: kFftBlockLines, a global-route block's own cost in lines
FFT_BLOCK_LINES = 2


def global_split(n: int, most: int, planes: int, slots: int) -> int:
    """Lines a block of a plane's n rows (or columns) on the global route
    (`fft_mixer.cuh::fft_global_split`): of the block counts from the
    fewest (`most` lines a block) up to four times that, the one whose
    waves of `slots` resident blocks (rounded up) times a block's lines
    plus FFT_BLOCK_LINES is least."""
    fewest = -(-n // most)
    best, best_cost = fewest, None
    for nb in range(fewest, min(4 * fewest, n) + 1):
        cost = -(-planes * nb // slots) * (-(-n // nb) + FFT_BLOCK_LINES)
        if best_cost is None or cost < best_cost:
            best, best_cost = nb, cost
    return -(-n // best)


def fft_global_plan(h: int, w: int, planes: int = 1,
                    sms: int = H100_SMS) -> dict | None:
    """The global route's plan of `planes` H x W planes on `sms` SMs
    (`fft_mixer.cuh::fft_global_plan`): `rows` rows a block of the row
    parts (a) and (c), `row_blocks` such blocks a plane, of
    `row_threads` threads (256, two blocks an SM, where a row and the
    line buffer fit FFT_GLOBAL_SMEM, else 512, one an SM); `cols` columns
    a block of the column part (b), `col_blocks` such blocks a plane, of
    `col_threads` threads (the same rule), each column staged with the
    odd pitch `pitch` (H rounded up to odd); the lines a block as many as
    the shared memory holds (`most_rows`, `most_cols`), split evenly over
    the waves (`global_split`); each block's shared memory (`smem_rows`,
    `smem_cols`) and the scratch a plane (`plane_bytes`: its half
    spectrum column by column, [W/2 + 1][H] float2). None where there is
    no plan."""
    plan = fft_mixer_plan(h, w)
    if plan is None:
        return None
    head = 4 * FFT_PLAN_FLOATS + 8 * plan["gbuf"]
    row, pitch, half = 8 * plan["ld"], h | 1, w // 2 + 1
    col = 8 * pitch
    if head + max(row, col) > FFT_SMEM_BYTES:
        return None
    rows2, cols2 = head + row <= FFT_GLOBAL_SMEM, head + col <= FFT_GLOBAL_SMEM
    most_rows = min(h, ((FFT_GLOBAL_SMEM if rows2 else FFT_SMEM_BYTES)
                        - head) // row)
    most_cols = min(half, ((FFT_GLOBAL_SMEM if cols2 else FFT_SMEM_BYTES)
                           - head) // col)
    rows = global_split(h, most_rows, planes, 2 * sms if rows2 else sms)
    cols = global_split(half, most_cols, planes, 2 * sms if cols2 else sms)
    return {"rows": rows, "row_blocks": -(-h // rows),
            "row_threads": 256 if rows2 else 512, "most_rows": most_rows,
            "cols": cols, "pitch": pitch, "col_blocks": -(-half // cols),
            "col_threads": 256 if cols2 else 512, "most_cols": most_cols,
            "smem_rows": head + row * rows, "smem_cols": head + col * cols,
            "plane_bytes": 8 * half * h}


def fft_cluster_plan(h: int, w: int, k: int) -> dict | None:
    """The cluster route's plan of an H x W plane on k blocks
    (`fft_mixer.cuh::fft_cluster_plan`): `rows` rows of the half spectrum
    a block and `cols` of its W/2 + 1 columns a block (block j: [j rows,
    (j + 1) rows), [j cols, (j + 1) cols), clipped), its columns run
    `chunk` at a time (`chunks` of them) staged with the odd row pitch
    `pitch`, and each block's shared memory `smem` (the plan, its rows,
    the stage, the line buffer). None where there is no plan, or a
    block's rows and one staged column exceed FFT_SMEM_BYTES."""
    plan = fft_mixer_plan(h, w)
    if plan is None or k < 1:
        return None
    half, rows = w // 2 + 1, -(-h // k)
    mine = 4 * FFT_PLAN_FLOATS + 8 * (rows * plan["ld"] + plan["gbuf"])
    if mine + 8 * h > FFT_SMEM_BYTES:
        return None
    # the widest stage that fits, odd, at most W/2 + 2
    fit = min((FFT_SMEM_BYTES - mine) // (8 * h), half + 1)
    widest = fit if fit % 2 else fit - 1
    cols = -(-half // k)
    chunks = -(-cols // widest)
    chunk = -(-cols // chunks)
    return {"k": k, "rows": rows, "cols": cols, "chunk": chunk,
            "chunks": chunks, "pitch": chunk | 1,
            "smem": mine + 8 * h * (chunk | 1)}


def cluster_size(k: int, planes: int, sms: int = H100_SMS) -> int:
    """The cluster size a launch of `planes` planes on `sms` SMs takes
    (`fft_mixer.cuh::fft_cluster_size`): from the smallest k that holds a
    plane, doubled (up to the largest of FFT_CLUSTERS) while the
    clusters still take at most half of the SMs, one block an SM."""
    while 2 * k <= FFT_CLUSTERS[-1] and planes * 4 * k <= sms:
        k *= 2
    return k


def mixer_route(h: int, w: int, planes: int = 1, head: bool = False,
                sms: int = H100_SMS) -> dict | None:
    """How the kernel runs the mixer of `planes` H x W planes on `sms`
    SMs (`spectral_head.cu::launch_fft_mixer`, `fft_mixer.cuh::
    fft_mixer_route`), chosen by shape before any launch: `route` "smem"
    (one block or a cluster of two a plane, its half spectrum in shared
    memory), "cluster" (one launch, a cluster of `k` blocks a plane that
    hold its half spectrum between them: the smallest k of FFT_CLUSTERS
    that does, made larger by `cluster_size` where the planes are few)
    or "global" (three launches on a scratch); `launches` of kernels a
    call (the head's LN split counts one more with `head`),
    `scratch_bytes` the wrapper allocates (0 but on "global"), the rows
    and columns a block (`rows`, `cols`: the cluster's or the global
    route's ranges; None on "smem") and `k` (None but on "cluster").
    None where no route takes the plane: no plan (beyond FFT_MAX_H,
    FFT_MAX_W, FFT_MAX_W_ODD)."""
    plan = fft_mixer_plan(h, w)
    if plan is None:
        return None
    if plan["smem"] <= FFT_SMEM_BYTES:
        return {"route": "smem", "launches": 1 + head, "scratch_bytes": 0,
                "cols": None, "rows": None, "k": None}
    g = fft_global_plan(h, w, planes, sms)
    if g is None:
        return None
    for k in FFT_CLUSTERS:
        if fft_cluster_plan(h, w, k) is not None:
            c = fft_cluster_plan(h, w, cluster_size(k, planes, sms))
            return {"route": "cluster", "launches": 1 + head,
                    "scratch_bytes": 0, "cols": c["cols"], "rows": c["rows"],
                    "k": c["k"]}
    return {"route": "global", "launches": 3 + head,
            "scratch_bytes": planes * g["plane_bytes"], "cols": g["cols"],
            "rows": g["rows"], "k": None}


def fft_tables_ref(h: int, w: int) -> torch.Tensor:
    """The kernel's tables of an H x W plane as float32 [floats]: the
    plan as the struct FftMixerPlan lays it out (int32 bits: per FftPlan
    n, npass, 8 radices; then ld, qh, the five offsets, W), row twiddles
    w_n^j, half twiddles w_W^k (k <= n; even W only), column twiddles
    w_H^j (interleaved re, im; computed in long double, exact zeros
    snapped) and the row positions fft_pos (int32 bits)."""
    import numpy as np
    plan = fft_mixer_plan(h, w)
    n = w if w % 2 else w // 2
    out = np.zeros(plan["floats"], np.float32)
    head = []
    for radices, length in ((plan["row"], n), (plan["col"], h)):
        head += [length, len(radices)] + radices + [0] * (
            FFT_MAX_PASS - len(radices))
    head += [plan[k] for k in ("ld", "qh", "tw_row", "tw_half", "tw_col",
                               "pos_row", "floats", "w")]
    out[:len(head)] = np.array(head, np.int32).view(np.float32)

    def tw(count, length):   # in long double, then rounded
        ang = 2.0 * np.arange(count, dtype=np.longdouble) / length
        c = np.cos(np.pi * ang).astype(np.float64)
        s = -np.sin(np.pi * ang).astype(np.float64)
        c[np.abs(c) < 1e-12], s[np.abs(s) < 1e-12] = 0.0, 0.0
        return np.stack([c, s], 1).astype(np.float32).reshape(-1)

    out[plan["tw_row"]:plan["tw_row"] + 2 * n] = tw(n, n)
    if w % 2 == 0:
        out[plan["tw_half"]:plan["tw_half"] + 2 * n + 2] = tw(n + 1, w)
    out[plan["tw_col"]:plan["tw_col"] + 2 * h] = tw(h, h)
    pos = np.array([fft_pos(plan["row"], n, k) for k in range(n)], np.int32)
    out[plan["pos_row"]:] = pos.view(np.float32)
    return torch.from_numpy(out)


_TABLES: dict = {}


def fft_tables(h: int, w: int, device: torch.device) -> torch.Tensor:
    """The kernel's tables of an H x W plane on a CUDA device, made by
    one `lgteun_fft_tables` launch the first time (size, device) is
    asked for."""
    key = (h, w, torch.device(device))
    if key not in _TABLES:
        floats = fft_mixer_plan(h, w)["floats"]
        tab = torch.empty(floats, device=device, dtype=torch.float32)
        _cuda.launch("lgteun_fft_tables", tab.device, tab, floats, h, w)
        fft_tables.launches += 1
        _TABLES[key] = tab
    return _TABLES[key]


fft_tables.launches = 0


def mixer_variant(planes: int, device: torch.device, h: int, w: int
                  ) -> str:
    """The launch the kernel picks for `planes` H x W planes
    (`spectral_head.cu::launch_fft_mixer`): "cluster" or "global" (those
    routes) where a plane's half spectrum does not fit one block's shared
    memory, else "pair" (a cluster of two 512-thread blocks a plane, each
    with the whole half spectrum) where twice the planes fit on the SMs,
    "block512" (one 512-thread block a plane) where the planes do, else
    "block256" (256-thread blocks, two an SM)."""
    route = mixer_route(h, w)["route"]
    if route != "smem":
        return route
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return ("pair" if 2 * planes <= sms else
            "block512" if planes <= sms else "block256")


def _check_plane(name: str, x: torch.Tensor) -> dict:
    """Raise unless the mixer kernel takes x's [H, W] planes; return the
    route (`mixer_route`) of its B x C planes."""
    b, c, h, w = x.shape
    route = mixer_route(h, w, b * c)
    if route is not None:
        return route
    raise ValueError(
        f"{name}: the FFT kernel takes 2 <= H <= {FFT_MAX_H} and 2 <= W <= "
        f"{FFT_MAX_W} (odd W <= {FFT_MAX_W_ODD}), got {tuple(x.shape)}")


def _scratch(route: dict, device: torch.device):
    """The global route's scratch of `route` (`mixer_route`) on `device`,
    or None (a null pointer) on the shared-memory route."""
    if route["route"] != "global":
        return None
    return torch.empty(route["scratch_bytes"] // 4, device=device,
                       dtype=torch.float32)


def ln_mixer_head(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                  eps: float = 1e-5, out_dtype=None):
    """Mixer head on [B, C, H, W] -> (y1, x2), each [B, C/2, H, W] of
    `out_dtype` (default x's dtype; module docstring). ln_w/ln_b: [C];
    amp_w/amp_b/pha_w/pha_b: [C/2]."""
    out_dtype = out_dtype or x.dtype
    if _cuda.plain_on_cpu("ln_mixer_head", x):
        return ln_mixer_head_ref(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b,
                                 eps, out_dtype)
    weights = (ln_w, ln_b, amp_w, amp_b, pha_w, pha_b)
    bf16 = torch.bfloat16 in (x.dtype, out_dtype)
    if bf16:
        _cuda.check_eval_storage("ln_mixer_head", x, *weights)

    def kernel(x, ln_w, ln_b, amp_w, amp_b, pha_w, pha_b):
        b, c, h, w = x.shape
        c2 = c // 2
        if c % 2:
            raise ValueError(f"ln_mixer_head: need even C, got "
                             f"{tuple(x.shape)}")
        route = _check_plane("ln_mixer_head", x[:, :c2])
        if ln_w.shape != (c,) or ln_b.shape != (c,) or any(
                p.shape != (c2,) for p in (amp_w, amp_b, pha_w, pha_b)):
            raise ValueError("ln_mixer_head: parameter shapes do not match "
                             "C")
        _cuda.check_cuda_f32("ln_mixer_head", x.device, ln_w=ln_w,
                             ln_b=ln_b, amp_w=amp_w, amp_b=amp_b,
                             pha_w=pha_w, pha_b=pha_b)
        tables = fft_tables(h, w, x.device)
        scratch = _scratch(route, x.device)
        if bf16:
            _cuda.check_cuda("ln_mixer_head", x.device, _cuda.STORAGE,
                             x=x)
            if out_dtype != torch.bfloat16:
                raise ValueError(
                    "ln_mixer_head: takes (x, y1/x2) as (float32, float32), "
                    "(float32, bfloat16) or (bfloat16, bfloat16), got "
                    f"({x.dtype}, {out_dtype})")
            y1 = torch.empty((b, c2, h, w), device=x.device,
                             dtype=torch.bfloat16)
            x2 = torch.empty_like(y1)
            y2 = torch.empty(y1.shape, device=x.device)
            _cuda.launch("lgteun_ln_mixer_head_bf16", x.device, x, *weights,
                         tables, scratch, y1, x2, y2, b, c, h, w,
                         _cuda.storage_flag(x), eps)
        else:
            _cuda.check_cuda_f32("ln_mixer_head", x.device, x=x)
            y1 = torch.empty((b, c2, h, w), device=x.device, dtype=x.dtype)
            x2 = torch.empty_like(y1)
            _cuda.launch("lgteun_ln_mixer_head", x.device, x, *weights,
                         tables, scratch, y1, x2, b, c, h, w, eps)
        ln_mixer_head.launches += 1
        ln_mixer_head.variants[mixer_variant(b * c2, x.device, h, w)] += 1
        return y1, x2

    if bf16:
        return kernel(x, *weights)
    return recompute(kernel, lambda *t: ln_mixer_head_ref(*t, eps), x,
                     *weights)


ln_mixer_head.launches = 0
ln_mixer_head.variants = collections.Counter()


def global_mixer(x, amp_w, amp_b, pha_w, pha_b, out_dtype=None):
    """FFT amp/phase mixer on [B, C, H, W] -> [B, C, H, W] of `out_dtype`
    (default x's dtype; same contract as `global_mixer_ref`): (float32,
    float32), (float32, bfloat16) or (bfloat16, bfloat16);
    amp_w/amp_b/pha_w/pha_b: [C]."""
    out_dtype = out_dtype or x.dtype
    if _cuda.plain_on_cpu("global_mixer", x):
        return global_mixer_ref(x, amp_w, amp_b, pha_w, pha_b, out_dtype)
    bf16 = torch.bfloat16 in (x.dtype, out_dtype)
    if bf16:
        _cuda.check_eval_storage("global_mixer", x, amp_w, amp_b, pha_w,
                                 pha_b)

    def kernel(x, amp_w, amp_b, pha_w, pha_b):
        b, c, h, w = x.shape
        route = _check_plane("global_mixer", x)
        if any(p.shape != (c,) for p in (amp_w, amp_b, pha_w, pha_b)):
            raise ValueError("global_mixer: parameter shapes do not match C")
        _cuda.check_cuda("global_mixer", x.device, _cuda.STORAGE, x=x)
        _cuda.check_cuda_f32("global_mixer", x.device, amp_w=amp_w,
                             amp_b=amp_b, pha_w=pha_w, pha_b=pha_b)
        if bf16 and out_dtype != torch.bfloat16:
            raise ValueError(
                "global_mixer: takes (x, out) as (float32, float32), "
                "(float32, bfloat16) or (bfloat16, bfloat16), got "
                f"({x.dtype}, {out_dtype})")
        if x.data_ptr() % (2 * x.element_size()):  # rows read as pairs
            x = x.clone()
        out = torch.empty(x.shape, device=x.device, dtype=out_dtype)
        args = (x, amp_w, amp_b, pha_w, pha_b, fft_tables(h, w, x.device),
                _scratch(route, x.device), out, b, c, h, w)
        if bf16:
            _cuda.launch("lgteun_global_mixer_bf16", x.device, *args,
                         _cuda.storage_flag(x))
        else:
            _cuda.launch("lgteun_global_mixer", x.device, *args)
        global_mixer.launches += 1
        global_mixer.variants[mixer_variant(b * c, x.device, h, w)] += 1
        return out

    if bf16:
        return kernel(x, amp_w, amp_b, pha_w, pha_b)
    return recompute(kernel, global_mixer_ref, x, amp_w, amp_b, pha_w, pha_b)


global_mixer.launches = 0
global_mixer.variants = collections.Counter()
