"""Batch-1 latency A/B of the port's UnlgFormer forward on one NVIDIA GPU:
each LGB block's weight views kept from the first forward (A, as
shipped) against views made anew in every forward (B).

    python3 scripts/torch_latency_ab.py [--pairs 10] [--level 2]

Builds UnlgFormer from the shipped WV-3 config (8 bands, K=2) at
`LGTEUN_FUSE_LEVEL` `--level`, seeded weights, one seeded 128^2 input.
Each arm is the median of 30 synchronised `Runner.predict` calls after 3
warm-up calls, on the host clock; the pairs alternate which arm runs
first. Prints every pair, each arm's median of the pair medians and its
quartiles, how many pairs A won, and the card's name and power limit. It
exits non-zero without a CUDA device or when the two arms' outputs
differ.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 19971118


def latency_ms(predict, batch, calls: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        predict(batch)
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--level", type=int, default=2)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_latency_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lgteun_tpu_torch.config import load_config
    from lgteun_tpu_torch.models.common.lgt import LGB
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(os.path.join(REPO, "lgteun_tpu_torch", "configs",
                                   "unlg_former.py"))
    with mock.patch.dict(os.environ, {"LGTEUN_FUSE_LEVEL": str(opts.level)}):
        method = build_model(cfg.model_type, cfg, device="cuda")
    runner = Runner(cfg, method, "cuda").init(SEED)
    rng = np.random.default_rng(SEED)
    batch = runner.to_device({
        "input_lr": rng.uniform(0, 1, (1, 32, 32, cfg.ms_chans)).astype(
            np.float32),
        "input_pan": rng.uniform(0, 1, (1, 128, 128, 1)).astype(np.float32)})
    arms = {"A": runner.predict}

    def fresh_views(b):
        with mock.patch.object(LGB, "_params", LGB._block_params):
            return runner.predict(b)

    arms["B"] = fresh_views
    if not torch.equal(arms["A"](batch), arms["B"](batch)):
        print("torch_latency_ab: the arms' outputs differ", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    got = {"A": [], "B": []}
    for i in range(opts.pairs):
        order = "AB" if i % 2 == 0 else "BA"
        pair = {k: latency_ms(arms[k], batch) for k in order}
        for k in order:
            got[k].append(pair[k])
        print(f"pair {i} ({order}): A {pair['A']:.4f} ms  B {pair['B']:.4f} "
              f"ms")
    wins = sum(a < b for a, b in zip(got["A"], got["B"]))
    for k, label in (("A", "views kept"), ("B", "views made per forward")):
        q1, _, q3 = statistics.quantiles(got[k], n=4)
        print(f"{k} ({label}): median {statistics.median(got[k]):.4f} ms, "
              f"quartiles {q1:.4f} / {q3:.4f}")
    print(f"UnlgFormer level {opts.level} batch-1: A faster in {wins} of "
          f"{opts.pairs} pairs [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
