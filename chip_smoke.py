"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from `lgteun_tpu_torch/csrc` with nvcc,
holds each kernel against its plain PyTorch version at the main paths'
shapes, then drives each ported eval path through `Runner.test` at its
config's eval batch size, with random weights from a seed:

- UnlgFormer (LGTEUN, WV-3, 8 bands, K=2): three kernels per LGB block;
- lightnet (WV-3, 8 bands): the SpanConv stack kernel;
- MDCUN (WV-3, 8 bands, T=4): the neighbourhood-attention kernel.

For each path it checks that every forward went through its kernels,
that the output agrees with a CPU run of the plain path, and times
batch-1 latency and batch-16 throughput. It also prints where the
card-vs-CPU difference of each path comes from: the card with the
kernels, the card on the kernels' plain versions and the CPU plain path,
each against a float64 run of the CPU plain path.

`--profile` adds a torch.profiler (CUPTI) pass over a few forwards of
each path at batch 1 and at the eval batch: device kernels per forward,
device busy time, idle share and each device kernel's share of the busy
time.

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
import importlib
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
CONFIGS = os.path.join(REPO, "lgteun_tpu", "configs")
SEED = 19971118
KERNEL_BATCH = 4            # kernel checks at the main path's shapes
# (C, H=W) of the prior's LGB blocks: 4 full-res blocks, 1 bottleneck
BLOCK_SHAPES = ((32, 128), (64, 64))
KERNEL_REL_TOL = 1e-4       # max|kernel - plain| / max|plain|
N_IMAGES = 64

# name -> (module under lgteun_tpu_torch/ops holding the wrapper and its
# plain version, the model module that calls it, CUDA source, the TPU
# kernel it replaces, the shape whose times the JSON line reports)
KERNELS = {
    "ln_mixer_head": ("spectral_kernel", "lgteun_tpu_torch.models.common.lgt",
                      "lgteun_tpu_torch/csrc/spectral_head.cu",
                      "lgteun_tpu/ops/spectral_kernel.py:281", "4x32x128x128"),
    "window_attention": ("window_attention",
                         "lgteun_tpu_torch.models.common.lgt",
                         "lgteun_tpu_torch/csrc/window_attention.cu",
                         "lgteun_tpu/ops/window_attention.py:274",
                         "4x32x128x128"),
    "block_tail": ("ffn_kernel", "lgteun_tpu_torch.models.common.lgt",
                   "lgteun_tpu_torch/csrc/block_tail.cu",
                   "lgteun_tpu/ops/ffn_kernel.py:458", "4x32x128x128"),
    "lightnet_stack": ("lightnet_kernel", "lgteun_tpu_torch.models.lightnet",
                       "lgteun_tpu_torch/csrc/lightnet.cu",
                       "lgteun_tpu/ops/lightnet_kernel.py:163", "4x9x128x128"),
    "neighborhood_attention": (
        "nonlocal_kernel", "lgteun_tpu_torch.models.mdcun",
        "lgteun_tpu_torch/csrc/neighborhood_attention.cu",
        "lgteun_tpu/ops/nonlocal_kernel.py:120", "4x8x128x128"),
}

# (config file, {kernel: launches per forward}, card-vs-CPU max-abs bound,
#  images of the CPU comparison). The bounds: UnlgFormer the port's 5e-4
# (ROADMAP.md); lightnet 1e-4 and MDCUN 1e-3, those
# tests/test_torch_parity.py holds the JAX package to against the
# reference.
SLICES = (
    ("unlg_former.py", {"ln_mixer_head": 5, "window_attention": 5,
                        "block_tail": 5}, 5e-4, 2),
    ("lightnet.py", {"lightnet_stack": 3}, 1e-4, 2),
    ("MDCUN.py", {"neighborhood_attention": 4}, 1e-3, 1),
)


def kernel_fns(name: str):
    """(wrapper, plain version) of kernel `name`."""
    mod = importlib.import_module(f"lgteun_tpu_torch.ops.{KERNELS[name][0]}")
    return getattr(mod, name), getattr(mod, f"{name}_ref")


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

    # LightNet's stack at 8 bands: x = pan + lms (9 channels), kaiming
    # weights, biases U(+-0.1) so that the border zeroing matters
    from lgteun_tpu_torch.ops.lightnet_kernel import (lightnet_layers,
                                                      lightnet_stack,
                                                      lightnet_stack_ref)
    bands, hw = 8, 128
    layers = []
    for _n, cin, cout, _r in lightnet_layers(bands):
        span = []
        for _branch in range(2):
            span += [n(cout, cin, 1, 1, scale=(2 / cout) ** 0.5),
                     0.1 * n(cout), n(cout, 1, 3, 3, scale=(2 / 9 / cout)
                                      ** 0.5), 0.1 * n(cout)]
        layers.append(tuple(span))
    lms = n(b, bands, hw, hw)
    x = torch.cat([n(b, 1, hw, hw), lms], dim=1)
    yield ("lightnet_stack", f"{b}x{bands + 1}x{hw}x{hw}", lightnet_stack,
           lightnet_stack_ref, (x, lms, layers))
    # MDCUN's blockNL at 8 bands, and one ragged shape for the borders
    from lgteun_tpu_torch.ops.nonlocal_kernel import (
        neighborhood_attention, neighborhood_attention_ref)
    for shape in ((b, bands, hw, hw), (1, bands, 72, 100)):
        na = (n(*shape),) + tuple(n(bands, bands, scale=bands ** -0.5)
                                  for _ in range(4)) + (15,)
        yield ("neighborhood_attention", "x".join(map(str, shape)),
               neighborhood_attention, neighborhood_attention_ref, na)


@contextlib.contextmanager
def plain_kernels(names):
    """Run kernels `names` on their plain versions in the models that
    call them (for the numeric split only; the wrappers count no launch
    meanwhile)."""
    saved = []
    try:
        for name in names:
            user = importlib.import_module(KERNELS[name][1])
            saved.append((user, name, getattr(user, name)))
            setattr(user, name, kernel_fns(name)[1])
        yield
    finally:
        for user, name, fn in saved:
            setattr(user, name, fn)


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
                    help="add a torch.profiler pass of each path at batch 1 "
                         "and the eval batch")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lgteun_tpu_torch.ops import _cuda

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

    # 3. each slice: shipped config, seeded weights, Runner.test
    launches = {}
    for config, per_forward, abs_tol, n_cmp in SLICES:
        launches.update(run_slice(os.path.join(CONFIGS, config), per_forward,
                                  abs_tol, n_cmp, card, opts.profile))

    kernels = []
    for name, (_op, _user, src, replaces, main_shape) in KERNELS.items():
        rec = record[name]
        full = rec["by_shape"][main_shape]
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


def run_slice(config: str, per_forward: dict, abs_tol: float, n_cmp: int,
              card: str, profile: bool) -> dict:
    """Drive one eval path through Runner.test on the card and check
    it; returns {kernel: launches in the Runner.test run}."""
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.data.pipeline import eval_batches
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner

    cfg = load_config(config)
    tag = f"slice {cfg.model_type}"
    print(f"config: {cfg.model_type} {cfg.datas} ms_chans={cfg.ms_chans} "
          f"model_cfg={cfg.model_cfg} eval_batch_size={cfg.eval_batch_size}")
    method = build_model(cfg.model_type, cfg, device="cuda")
    runner = Runner(cfg, method, "cuda").init(SEED)
    ds = SceneDataset(N_IMAGES, cfg.ms_chans, SEED)
    runner.predict(runner.to_device(next(eval_batches(
        ds, cfg.eval_batch_size))[0]))  # warm-up outside the counted run
    torch.cuda.synchronize()
    wrappers = {k: kernel_fns(k)[0] for k in per_forward}
    for fn in wrappers.values():
        fn.launches = 0
    results = runner.test(ds)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    forwards = -(-N_IMAGES // cfg.eval_batch_size)
    print(f"{tag}: psnr {results['psnr'][0]:.4f} dB (random weights), "
          f"{forwards} forwards, launches {launches}")
    for k, n in launches.items():
        if n != per_forward[k] * forwards:
            raise AssertionError(f"{k}: {n} launches, want {per_forward[k]} "
                                 f"per forward x {forwards}")

    first = {k: v[:n_cmp] for k, v in next(eval_batches(ds, n_cmp))[
        0].items() if k != "image_id"}
    got = runner.predict(runner.to_device(first)).cpu()
    cpu = build_model(cfg.model_type, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         method.module.state_dict().items()})
    want = cpu.apply(first)
    err = (got - want).abs().max().item()
    print(f"{tag}: output {tuple(got.shape)} finite="
          f"{bool(torch.isfinite(got).all())}  max|card - cpu plain| "
          f"{err:.3e} (max|cpu| {want.abs().max().item():.3f}, bound "
          f"{abs_tol:g})")
    if not torch.isfinite(got).all() or not err <= abs_tol:
        raise AssertionError(f"{tag} output: max-abs {err:.3e} > "
                             f"{abs_tol} or not finite")
    # where that difference comes from (printed, not checked)
    with plain_kernels(per_forward):
        card_plain = runner.predict(runner.to_device(first)).cpu()
    exact = float64_forward(cpu, first)
    d = lambda a, b: (a.double() - b.double()).abs().max().item()
    print(f"{tag} split: max|card kernels - card plain| "
          f"{d(got, card_plain):.3e}  max|card plain - cpu plain| "
          f"{d(card_plain, want):.3e}; vs float64 cpu plain: card kernels "
          f"{d(got, exact):.3e}, card plain {d(card_plain, exact):.3e}, "
          f"cpu plain {d(want, exact):.3e}")

    # latency and throughput of the predict path
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
    print(f"{tag}: batch-1 latency median "
          f"{statistics.median(lat) * 1e3:.3f} ms (min {min(lat) * 1e3:.3f})"
          f"; batch-{cfg.eval_batch_size} {b16_ms:.3f} ms = {ips:.1f} "
          f"images/s; Runner.test {runner.last_time_per_image * 1e3:.3f} "
          f"ms/img  [{card}]")

    if profile:
        for label, batch in (("batch-1", b1),
                             (f"batch-{cfg.eval_batch_size}", b16)):
            prof = device_profile(runner, batch)
            top = "; ".join(f"{share:.3f} {name}"
                            for name, share in prof.pop("top"))
            print(f"profile {cfg.model_type} {label}: " + "  ".join(
                f"{k} {v:.4g}" for k, v in prof.items()) + f"  [{card}]")
            print(f"profile {cfg.model_type} {label} top device kernels: "
                  f"{top}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
