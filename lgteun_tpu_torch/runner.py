"""Runner of the port: training, eval and checkpoints (counterpart of
`lgteun_tpu/runner.py`).

    Runner(cfg, method, device, train_ds=..., test_ds=...)
        .init()                 seeded torch-default init
        .set_optim()            Adam / AdamW / SGD / RMSprop + StepLR
        .train()                the iteration loop up to cfg.max_iter
        .test(dataset)          PSNR and time per image (reduced res.)
        .save(iter) / .load_checkpoint(path) / .load_pretrained(path)

`train()` (runner.py:350-463) draws batches from `train_iterator`
(fast-forwarded to `last_iter`), runs `train_step` per iteration, logs
the losses' means every `log_freq` iterations (and keeps them in
`loss_log`), saves every `save_freq` and scores `test_ds` every
`eval_freq`. Each step's dropout generator is
seeded statelessly from (seed + 1, iteration), as the JAX Runner's
`fold_in`, so a resumed run replays an uninterrupted one: bit for bit on
the CPU; on a card up to the order of atomic adds in the backward of
`F.interpolate`'s bicubic, which CUDA does not fix. StepLR at step s
gives lr * gamma^floor(s / step_size), optax's `exponential_decay(...,
staircase=True)`. A checkpoint is a `torch.save` of the reference-keyed
state_dict, the optimizer's and scheduler's states and `iter_num`.

Left out: the JAX Runner's device prefetch and multi-step dispatch (TPU
round-trip workarounds; `steps_per_dispatch` is read by nothing, which
changes no number), `remat` and mixed precision (a config that sets
either raises), the full metric suite,
no-reference scoring (`test_freq`) and saving outputs.

Numerics: the JAX scoring engine runs float32 at `highest` precision,
while cuDNN runs float32 convolutions in TF32 by default. The Runner
therefore turns TF32 off for cuBLAS and cuDNN (process-wide) when it is
built.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from lgteun_tpu_torch.config import Config, OptimCfg
from lgteun_tpu_torch.data.pipeline import (data_denormalize, eval_batches,
                                            train_iterator)
from lgteun_tpu_torch.metrics.torch_metrics import psnr_batch
from lgteun_tpu_torch.models.base import TorchMethod

__all__ = ["Runner", "make_optimizer", "read_checkpoint", "step_generator"]


def make_optimizer(params, ocfg: OptimCfg) -> torch.optim.Optimizer:
    """The optimiser of `ocfg`, as `lgteun_tpu/runner.py::make_optimizer`
    builds it with optax (RMSprop: optax's decay 0.9; torch adds eps
    outside the square root, optax inside)."""
    kind = ocfg.type.lower()
    if kind == "adam":
        return torch.optim.Adam(params, lr=ocfg.lr, betas=tuple(ocfg.betas),
                                eps=ocfg.eps)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=ocfg.lr, betas=tuple(ocfg.betas),
                                 eps=ocfg.eps, weight_decay=ocfg.weight_decay)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=ocfg.lr, momentum=ocfg.momentum)
    if kind == "rmsprop":
        return torch.optim.RMSprop(params, lr=ocfg.lr, alpha=0.9, eps=1e-8,
                                   momentum=ocfg.momentum)
    raise ValueError(f"unknown optimiser {ocfg.type!r}")


def step_generator(seed: int, iter_id: int,
                   device: torch.device) -> torch.Generator:
    """A generator on `device` seeded from (seed, iter_id) alone."""
    state = np.random.SeedSequence([seed, iter_id]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def read_checkpoint(path: str, map_location) -> tuple:
    """(state_dict, iter_num or None, {"optimizer", "scheduler"} or None)
    of a Runner checkpoint (`Runner.save`: a dict with "state_dict" and
    "iter_num") or of a bare state_dict, which gives (it, None, None)."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    if not isinstance(payload.get("state_dict"), dict):
        return payload, None, None
    restored = ({k: payload[k] for k in ("optimizer", "scheduler")}
                if "optimizer" in payload else None)
    return payload["state_dict"], int(payload["iter_num"]), restored


class Runner:
    """Owns the train/eval/checkpoint lifecycle of one TorchMethod on one
    device."""

    def __init__(self, cfg: Config, method: TorchMethod, device,
                 logger: logging.Logger | None = None, train_ds=None,
                 test_ds=None):
        self.cfg = cfg
        self.method = method
        self.device = torch.device(device)
        if method.device != self.device:
            raise ValueError(f"method is on {method.device}, runner on "
                             f"{self.device}")
        for flag, item in (("mixed_precision", "A.5.5"), ("remat", "A.5.4")):
            if cfg.get(flag):
                raise NotImplementedError(
                    f"config sets {flag}=True, which the port does not "
                    f"implement yet (ROADMAP {item}); unset it to train in "
                    "float32")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.logger = logger or logging.getLogger("lgteun_torch")
        self.train_ds, self.test_ds = train_ds, test_ds
        self.last_time_per_image = float("nan")
        self.last_iter = 0
        self.loss_log: list[tuple[int, dict]] = []  # (iter, loss means)
        self.optimizer = self.scheduler = None
        self._restored = None   # optimizer/scheduler states to resume

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

    # ------------------------------------------------------------ train

    def set_optim(self) -> "Runner":
        """The core module's optimiser (`optim_cfg["core_module"]`,
        default Adam lr 1e-4) and its StepLR; states restored by
        `load_checkpoint` are loaded into them, so init ->
        load_checkpoint -> set_optim resumes the moments and the
        schedule."""
        ocfg = self.cfg.optim_cfg.get("core_module", OptimCfg())
        self.optimizer = make_optimizer(self.method.module.parameters(), ocfg)
        self.scheduler = torch.optim.lr_scheduler.StepLR(
            self.optimizer, step_size=self.cfg.sched_cfg.step_size,
            gamma=self.cfg.sched_cfg.gamma)
        if self._restored is not None:
            self.optimizer.load_state_dict(self._restored["optimizer"])
            self.scheduler.load_state_dict(self._restored["scheduler"])
            self._restored = None
        return self

    def train_step(self, batch: dict, iter_id: int) -> dict:
        """One optimiser step on a device batch (`to_device`); returns the
        loss parts, detached, on the device."""
        gen = step_generator(self.cfg.seed + 1, iter_id, self.device)
        self.method.train()
        _, parts = self.method.losses(batch, gen)
        self.optimizer.zero_grad(set_to_none=True)
        parts["full_loss"].backward()
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in parts.items()}

    def train(self) -> "Runner":
        """Iterations last_iter .. cfg.max_iter on `train_ds`."""
        cfg = self.cfg
        if cfg.max_iter <= self.last_iter:
            self.logger.info("nothing to train (max_iter reached)")
            return self
        if self.optimizer is None:
            self.set_optim()
        it = train_iterator(self.train_ds, cfg.train_set_cfg.batch_size,
                            bit_depth=cfg.bit_depth,
                            normalize=cfg.norm_input,
                            aug_dict=cfg.aug_dict or None, seed=cfg.seed,
                            start_iter=self.last_iter)
        t0 = time.time()
        iter_id = self.last_iter
        window: list[dict] = []
        try:
            while iter_id < cfg.max_iter:
                window.append(self.train_step(self.to_device(next(it)),
                                              iter_id))
                iter_id += 1
                if iter_id % cfg.log_freq == 0:
                    means = {k: float(torch.stack([p[k] for p in window])
                                      .mean()) for k in window[-1]}
                    window.clear()
                    self.loss_log.append((iter_id, means))
                    done = iter_id - self.last_iter
                    eta = (time.time() - t0) / done * (cfg.max_iter - iter_id)
                    self.logger.info(
                        f"iter [{iter_id}/{cfg.max_iter}] "
                        + ", ".join(f"{k}={v:.5f}" for k, v in means.items())
                        + f" ETA {eta:.0f}s")
                if cfg.save_freq and iter_id % cfg.save_freq == 0:
                    self.save(iter_id)
                if cfg.eval_freq and iter_id % cfg.eval_freq == 0 \
                        and self.test_ds is not None:
                    self.test(self.test_ds)
        finally:
            self.last_iter = iter_id
            self.method.eval()
        return self

    # ------------------------------------------------------------- eval

    def test(self, dataset) -> dict:
        """Reduced-resolution evaluation -> {"psnr": (mean, std)}.
        `dataset` yields PSDataset item dicts (NHWC `input_lr`,
        `input_pan`, `target` in DN) and has `pairs` for the ids. The
        module runs in eval mode and is put back in its mode after."""
        cfg = self.cfg
        training = self.method.module.training
        self.method.eval()
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
        self.method.train(training)
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

    # ------------------------------------------------------ checkpoints

    def save(self, iter_id: int) -> str:
        """{work_dir}/{datas}/train_out/model_iter_{iter_id}.pt: weights,
        optimizer and scheduler states and the iteration."""
        out = os.path.join(self.cfg.work_dir, self.cfg.datas, "train_out")
        os.makedirs(out, exist_ok=True)
        path = os.path.abspath(os.path.join(out, f"model_iter_{iter_id}.pt"))
        payload = {"state_dict": self.method.module.state_dict(),
                   "iter_num": iter_id}
        if self.optimizer is not None:
            payload["optimizer"] = self.optimizer.state_dict()
            payload["scheduler"] = self.scheduler.state_dict()
        torch.save(payload, path)
        self.logger.info(f"saved checkpoint {path}")
        return path

    def load_checkpoint(self, path: str) -> "Runner":
        """Weights from a Runner checkpoint (`save`) or a bare state_dict
        (the CLI's form, `convert/from_jax.py`'s output). A Runner
        checkpoint also restores last_iter and the optimizer and
        scheduler states, so that train() resumes mid-schedule; a bare
        state_dict sets neither."""
        state_dict, iter_num, restored = read_checkpoint(path, self.device)
        self.method.load_state_dict(state_dict, strict=True)
        if iter_num is not None:
            self.last_iter = iter_num
        if restored is not None:
            self._restored = restored
            if self.optimizer is not None:
                self.set_optim()
        self.logger.info(f"loaded checkpoint {path} (iter {self.last_iter})")
        return self

    def load_pretrained(self, path: str) -> "Runner":
        """Weights only: the iteration and optimizer state start anew."""
        self.load_checkpoint(path)
        self.last_iter, self._restored = 0, None
        self.optimizer = self.scheduler = None
        return self
