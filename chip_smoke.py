"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from `lgteun_tpu_torch/csrc` with nvcc,
holds each kernel against its plain PyTorch version at the main path's
shapes, then drives the UnlgFormer eval path (shipped config: WV-3,
8 bands, K=2, random weights from a seed) through `Runner.test` at the
config's eval batch size, checks that every block went through the three
kernels and that the output agrees with a CPU run of the plain path, and
times batch-1 latency and batch-16 throughput. It also prints where the
card-vs-CPU difference of the slice comes from: the card with the
kernels, the card on the kernels' plain versions and the CPU plain path,
each against a float64 run of the CPU plain path.

`--profile` adds a torch.profiler (CUPTI) pass over a few forwards at
batch 1 and at the eval batch: device kernels per forward, device busy
time, idle share and each device kernel's share of the busy time.

Any failed phase raises (non-zero exit). With no CUDA device the script
exits non-zero before printing any result. The last line of stdout is
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit, and the one before that the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "lgteun_tpu", "configs", "unlg_former.py")
SEED = 19971118
KERNEL_BATCH = 4            # kernel checks at the main path's shapes
# (C, H=W) of the prior's LGB blocks: 4 full-res blocks, 1 bottleneck
BLOCK_SHAPES = ((32, 128), (64, 64))
KERNEL_REL_TOL = 1e-4       # max|kernel - plain| / max|plain|
SLICE_ABS_TOL = 5e-4        # card vs CPU plain path, max-abs
N_IMAGES = 64


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got, want) -> tuple[float, float]:
    """(max|got - want| / max|want|, max|got - want|) over tensors."""
    rel, ab = 0.0, 0.0
    for g, w in zip(got, want):
        torch.cuda.synchronize()
        d = (g - w).abs().max().item()
        rel = max(rel, d / max(w.abs().max().item(), 1e-30))
        ab = max(ab, d)
    return rel, ab


def kernel_cases(gen: torch.Generator):
    """(name, wrapper, plain, args) per kernel and main-path shape."""
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail, block_tail_ref
    from lgteun_tpu_torch.ops.spectral_kernel import (ln_mixer_head,
                                                      ln_mixer_head_ref)
    from lgteun_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_ref)

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    b = KERNEL_BATCH
    for c, hw in BLOCK_SHAPES:
        c2, c4 = c // 2, 4 * c
        shape = f"{b}x{c}x{hw}x{hw}"
        head = (n(b, c, hw, hw), 1 + 0.1 * n(c), 0.1 * n(c), n(c2),
                0.1 * n(c2), n(c2), 0.1 * n(c2))
        yield "ln_mixer_head", shape, ln_mixer_head, ln_mixer_head_ref, head
        attn = (n(b, c2, hw, hw), n(3 * c2, c2, scale=c2 ** -0.5),
                0.1 * n(3 * c2), n(2, 64, 64), 2, 8)
        yield ("window_attention", shape, window_attention,
               window_attention_ref, attn)
        ffn = {"ln_w": 1 + 0.1 * n(c), "ln_b": 0.1 * n(c),
               "w1": n(c4, c, scale=c ** -0.5), "b1": 0.1 * n(c4),
               "w2": n(c4, c4, scale=c4 ** -0.5), "b2": 0.1 * n(c4),
               "dw": n(c4, 3, 3, scale=1 / 3), "bdw": 0.1 * n(c4),
               "w3": n(c, c4, scale=c4 ** -0.5), "b3": 0.1 * n(c)}
        tail = (n(b, c, hw, hw), n(b, c2, hw, hw), n(b, c2, hw, hw),
                n(c, c, scale=c ** -0.5), 0.1 * n(c), ffn)
        yield "block_tail", shape, block_tail, block_tail_ref, tail
    # x = 0 and LN bias = 0: every frequency bin is exactly zero, which
    # takes the mixer's zero-bin path (amp = pha = 0) everywhere
    c, hw = BLOCK_SHAPES[0]
    zero = (torch.zeros(1, c, hw, hw).cuda(), 1 + 0.1 * n(c),
            torch.zeros(c).cuda(), n(c // 2), 0.1 * n(c // 2), n(c // 2),
            0.1 * n(c // 2))
    yield ("ln_mixer_head", f"1x{c}x{hw}x{hw}-zero", ln_mixer_head,
           ln_mixer_head_ref, zero)


KERNEL_INFO = {
    "ln_mixer_head": ("lgteun_tpu_torch/csrc/spectral_head.cu",
                      "lgteun_tpu/ops/spectral_kernel.py:281"),
    "window_attention": ("lgteun_tpu_torch/csrc/window_attention.cu",
                         "lgteun_tpu/ops/window_attention.py:274"),
    "block_tail": ("lgteun_tpu_torch/csrc/block_tail.cu",
                   "lgteun_tpu/ops/ffn_kernel.py:458"),
}


@contextlib.contextmanager
def plain_blocks():
    """Run the LGB blocks on their kernels' plain versions (for the
    numeric split only; the wrappers count no launch meanwhile)."""
    from lgteun_tpu_torch.models.common import lgt
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail_ref
    from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head_ref
    from lgteun_tpu_torch.ops.window_attention import window_attention_ref
    plain = {"ln_mixer_head": ln_mixer_head_ref,
             "window_attention": window_attention_ref,
             "block_tail": block_tail_ref}
    saved = {k: getattr(lgt, k) for k in plain}
    for k, fn in plain.items():
        setattr(lgt, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(lgt, k, fn)


def float64_forward(method, batch: dict) -> torch.Tensor:
    """The CPU plain path in float64 on a copy of `method`'s weights."""
    module = copy.deepcopy(method.module).double()
    nchw = lambda a: torch.from_numpy(np.asarray(a, np.float64)).permute(
        0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        return module(nchw(batch["input_lr"]),
                      nchw(batch["input_pan"])).permute(0, 2, 3, 1)


def device_profile(runner, batch: dict, n: int = 5) -> dict:
    """torch.profiler over `n` synchronised forwards: device kernels and
    copies per forward, device busy ms per forward (union of the device
    intervals), idle share (1 - busy / host wall of the loop, profiler
    on) and the top device kernels' shares of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    runner.predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            runner.predict(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
    total = sum(by_name.values())
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    return {"kernels_per_forward": (len(dev) - copies) / n,
            "copies_per_forward": copies / n,
            "busy_ms_per_forward": busy / n / 1e3,
            "wall_ms_per_forward": wall_us / n / 1e3,
            "idle_share": 1 - busy / wall_us,
            "top": [(name[:100], t / total)
                    for name, t in by_name.most_common(10)]}


class SceneDataset:
    """Seeded WV-3-shaped items in 11-bit DN: a smooth 8-band target
    [128,128,8], its 4x4 block mean as input_lr [32,32,8] and its band
    mean as input_pan [128,128,1]."""

    def __init__(self, n: int, bands: int, seed: int):
        rng = np.random.default_rng(seed)
        coarse = rng.uniform(200, 1800, (n, 16, 16, bands))
        fine = rng.normal(0, 40, (n, 128, 128, bands))
        target = np.clip(np.repeat(np.repeat(coarse, 8, 1), 8, 2) + fine,
                         0, 2047).astype(np.float32)
        lr = target.reshape(n, 32, 4, 32, 4, bands).mean(axis=(2, 4))
        pan = target.mean(axis=-1, keepdims=True)
        self.items = [{"input_lr": lr[i].astype(np.float32),
                       "input_pan": pan[i].astype(np.float32),
                       "target": target[i]} for i in range(n)]
        self.pairs = [(f"scene{i:03d}",) for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass at batch 1 and the "
                         "eval batch")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import eval_batches
    from lgteun_tpu_torch.ops import _cuda
    from lgteun_tpu_torch.ops.ffn_kernel import block_tail
    from lgteun_tpu_torch.ops.spectral_kernel import ln_mixer_head
    from lgteun_tpu_torch.ops.window_attention import window_attention
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s")
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(sh(_cuda.find_nvcc(), "--version").splitlines()[-1])
    print(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _cuda.build_library()
    _cuda.kernels()
    print(f"build: {lib_path.name} ({' '.join(_cuda.NVCC_FLAGS)}) "
          f"in {time.perf_counter() - t0:.1f} s")

    # 2. each kernel vs its plain version (TF32 off for the plain convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    record = {}
    for name, shape, kernel, plain, args in kernel_cases(gen):
        got, want = kernel(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rel, ab = rel_err(got, want)
        ms, plain_ms = in_turns(lambda: plain(*args), lambda: kernel(*args))
        print(f"kernel {name:17s} {shape:14s} rel err {rel:.3e} "
              f"(max-abs {ab:.3e})  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms")
        if not rel <= KERNEL_REL_TOL:
            raise AssertionError(f"{name} {shape}: rel err {rel:.3e} > "
                                 f"{KERNEL_REL_TOL}")
        rec = record.setdefault(name, {"max_abs_err": 0.0, "by_shape": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        rec["by_shape"][shape] = {"rel_err": rel, "ms": ms,
                                  "plain_ms": plain_ms}

    # 3. the slice: shipped config, seeded weights, Runner.test
    cfg = load_config(CONFIG)
    print(f"config: {cfg.model_type} {cfg.datas} ms_chans={cfg.ms_chans} "
          f"stage={cfg.model_cfg['core_module']['stage']} "
          f"eval_batch_size={cfg.eval_batch_size}")
    method = build_model(cfg.model_type, cfg, device="cuda")
    runner = Runner(cfg, method, "cuda").init(SEED)
    ds = SceneDataset(N_IMAGES, cfg.ms_chans, SEED)
    runner.predict(runner.to_device(next(eval_batches(
        ds, cfg.eval_batch_size))[0]))  # warm-up outside the counted run
    torch.cuda.synchronize()
    wrappers = {"ln_mixer_head": ln_mixer_head,
                "window_attention": window_attention,
                "block_tail": block_tail}
    for fn in wrappers.values():
        fn.launches = 0
    results = runner.test(ds)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    forwards = -(-N_IMAGES // cfg.eval_batch_size)
    print(f"slice: psnr {results['psnr'][0]:.4f} dB (random weights), "
          f"{forwards} forwards, launches {launches}")
    for k, n in launches.items():
        if n != 5 * forwards:
            raise AssertionError(f"{k}: {n} launches, want 5 per forward "
                                 f"x {forwards}")

    first2 = {k: v[:2] for k, v in next(eval_batches(ds, 2))[0].items()
              if k != "image_id"}
    got = runner.predict(runner.to_device(first2)).cpu()
    cpu = build_model(cfg.model_type, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    want = cpu.apply(first2)
    err = (got - want).abs().max().item()
    print(f"slice: output {tuple(got.shape)} finite="
          f"{bool(torch.isfinite(got).all())}  max|card - cpu plain| "
          f"{err:.3e} (max|cpu| {want.abs().max().item():.3f})")
    if not torch.isfinite(got).all() or not err <= SLICE_ABS_TOL:
        raise AssertionError(f"slice output: max-abs {err:.3e} > "
                             f"{SLICE_ABS_TOL} or not finite")
    # where that difference comes from (printed, not checked)
    with plain_blocks():
        card_plain = runner.predict(runner.to_device(first2)).cpu()
    exact = float64_forward(cpu, first2)
    d = lambda a, b: (a.double() - b.double()).abs().max().item()
    print(f"slice split: max|card kernels - card plain| "
          f"{d(got, card_plain):.3e}  max|card plain - cpu plain| "
          f"{d(card_plain, want):.3e}; vs float64 cpu plain: card kernels "
          f"{d(got, exact):.3e}, card plain {d(card_plain, exact):.3e}, "
          f"cpu plain {d(want, exact):.3e}")

    # 4. latency and throughput of the predict path
    items = next(eval_batches(ds, cfg.eval_batch_size))[0]
    b1 = runner.to_device({k: v[:1] for k, v in items.items()
                           if k != "image_id"})
    b16 = runner.to_device(items)
    lat = []
    for _ in range(3):
        runner.predict(b1)
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.predict(b1)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    b16_ms = time_ms(lambda: runner.predict(b16), iters=10)
    ips = cfg.eval_batch_size / (b16_ms / 1e3)
    print(f"slice: batch-1 latency median {statistics.median(lat) * 1e3:.3f}"
          f" ms (min {min(lat) * 1e3:.3f}); batch-{cfg.eval_batch_size} "
          f"{b16_ms:.3f} ms = {ips:.1f} images/s; Runner.test "
          f"{runner.last_time_per_image * 1e3:.3f} ms/img  [{card}]")

    if opts.profile:
        for label, batch in (("batch-1", b1),
                             (f"batch-{cfg.eval_batch_size}", b16)):
            prof = device_profile(runner, batch)
            top = "; ".join(f"{share:.3f} {name}"
                            for name, share in prof.pop("top"))
            print(f"profile {label}: " + "  ".join(
                f"{k} {v:.4g}" for k, v in prof.items()) + f"  [{card}]")
            print(f"profile {label} top device kernels: {top}")

    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        rec = record[name]
        full = rec["by_shape"][f"{KERNEL_BATCH}x32x128x128"]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": full["ms"], "plain_ms": full["plain_ms"],
                        "by_shape": rec["by_shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
