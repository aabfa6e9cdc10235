"""Eval runner of the port (counterpart of `lgteun_tpu/runner.py`
`Runner.init` / `test`, runner.py:144-158 and 467-527).

`Runner.test(dataset)` loops over padded eval batches, predicts, scores
PSNR on the real rows and logs the mean forward time per image (the
reference's Time(s/img) column). The full metric suite, no-reference
scoring, saving outputs, training and checkpoints come with later
slices.

Numerics: the JAX scoring engine runs float32 at `highest` precision,
while cuDNN runs float32 convolutions in TF32 by default. The Runner
therefore turns TF32 off for cuBLAS and cuDNN (process-wide) when it is
built.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from lgteun_tpu_torch.config import Config
from lgteun_tpu_torch.data.pipeline import data_denormalize, eval_batches
from lgteun_tpu_torch.metrics.torch_metrics import psnr_batch
from lgteun_tpu_torch.models.base import TorchMethod

__all__ = ["Runner"]


class Runner:
    """Owns the eval lifecycle of one TorchMethod on one device."""

    def __init__(self, cfg: Config, method: TorchMethod, device,
                 logger: logging.Logger | None = None):
        self.cfg = cfg
        self.method = method
        self.device = torch.device(device)
        if method.device != self.device:
            raise ValueError(f"method is on {method.device}, runner on "
                             f"{self.device}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.logger = logger or logging.getLogger("lgteun_torch")
        self.last_time_per_image = float("nan")

    def init(self, seed: int | None = None) -> "Runner":
        """Seeded torch-default init of every parameter."""
        seed = self.cfg.seed if seed is None else seed
        self.method.init_params(torch.Generator().manual_seed(seed))
        self.logger.info(f"Total params of module core_module: "
                         f"{self.method.param_count():,}")
        return self

    def load(self, state_dict: dict) -> "Runner":
        """Reference-keyed weights (strict)."""
        self.method.load_state_dict(state_dict, strict=True)
        return self

    def to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
                    self.device)
                for k, v in batch.items() if k != "image_id"}

    def predict(self, batch: dict) -> torch.Tensor:
        """NHWC batch -> NHWC prediction on the runner's device."""
        return self.method.apply(batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def test(self, dataset) -> dict:
        """Reduced-resolution evaluation -> {"psnr": (mean, std)}.
        `dataset` yields PSDataset item dicts (NHWC `input_lr`,
        `input_pan`, `target` in DN) and has `pairs` for the ids."""
        cfg = self.cfg
        bs = max(cfg.eval_batch_size, 1)
        dr = 2.0 ** cfg.bit_depth - 0.5
        psnrs: list[float] = []
        n_images, fwd_time = 0, 0.0
        for batch, n_valid in eval_batches(dataset, bs,
                                           bit_depth=cfg.bit_depth,
                                           normalize=cfg.norm_input):
            arrays = self.to_device(batch)
            t0 = time.perf_counter()
            pred = self.predict(arrays)
            self._sync()
            fwd_time += time.perf_counter() - t0
            n_images += n_valid
            scores = psnr_batch(data_denormalize(pred, cfg.bit_depth),
                                data_denormalize(arrays["target"],
                                                 cfg.bit_depth),
                                dynamic_range=dr)
            psnrs.extend(scores[:n_valid].tolist())
        results = {"psnr": (float(np.mean(psnrs)), float(np.std(psnrs)))}
        tag = "reduced-res (ref)"
        for k, (mean, std) in results.items():
            self.logger.info(f"{tag} {k}: {mean:.4f} +- {std:.4f}")
        self.last_time_per_image = fwd_time / max(n_images, 1)
        self.logger.info(
            f"{tag} avg time per img: "
            f"{self.last_time_per_image * 1000:.3f} ms "
            f"({n_images} images, batch {bs}, {self.device})")
        return results
