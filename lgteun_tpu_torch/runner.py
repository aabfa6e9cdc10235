"""Runner of the port: training, eval and checkpoints (counterpart of
`lgteun_tpu/runner.py`).

    Runner(cfg, method, device, train_ds=..., test_ds_full=...,
           test_ds_reduced=...)
        .init()                 seeded torch-default init
        .set_optim()            per module: Adam / AdamW / SGD / RMSprop
                                + StepLR
        .train()                the iteration loop up to cfg.max_iter
        .test(iter_id=, save=, ref=)
                                the reduced-resolution split scored with
                                PSNR, SSIM, Q, SAM, ERGAS (ref=True) or
                                the full-resolution split with D_lambda,
                                D_s, QNR (ref=False); `test(dataset)`
                                scores a given split
        .log_eval_curves()      {work_dir}/{datas}/eval_curves.json
        .save(iter) / .load_checkpoint(path) / .load_pretrained(path)

`train()` (runner.py:350-463) draws batches from `train_iterator`
(fast-forwarded to `last_iter`), runs `train_step` per iteration, logs
the losses' means every `log_freq` iterations (and keeps them in
`loss_log`), saves every `save_freq`, scores the reduced split every
`eval_freq` and the full split every `test_freq`. Each step's dropout
generator is seeded statelessly from (seed + 1, iteration), as the JAX
Runner's `fold_in`, so a resumed run replays an uninterrupted one: bit
for bit on the CPU; on a card up to the order of atomic adds in the
backward of `F.interpolate`'s bicubic, which CUDA does not fix. StepLR
at step s gives lr * gamma^floor(s / step_size), optax's
`exponential_decay(..., staircase=True)`. Every module of the method
(`TorchMethod.module_names`: the core module, and MutInf's `mi`) has
its own optimiser, `optim_cfg.get(name, OptimCfg())`, and its own
StepLR, as the JAX Runner gives every module in `params` one
(runner.py:160-184). A checkpoint is a `torch.save` of the core
module's reference-keyed state_dict ("state_dict"), `iter_num`, the
other modules' weights under their names ("modules") and each module's
optimizer and scheduler states under its name ("optimizers",
"schedulers"); a checkpoint written before the port trained more than
one module (one "optimizer" and one "scheduler") resumes as the core
module's. A training-free method (`ClassicalMethod`) has no module:
nothing to count, optimise or train, and an empty state_dict.

`test` (runner.py:467-562) scores each eval batch on the device and
keeps every metric sliced to the batch's real images: the reference
metrics on the denormalised prediction and target with dynamic range
2**bit_depth - 0.5, the no-reference ones on the normalised prediction,
LrMS and PAN (also for a split without targets, which then takes the
full-resolution tag; the JAX Runner keeps the tag asked for). It logs
mean +- std and the forward's time per image in the JAX Runner's words,
appends (iter, mean, std) to `eval_results[f"{tag}/{metric}"]`, keeps the
per-image values in `image_scores[tag]`, and with `save` writes each
prediction as a uint16 GeoTIFF (`REFERENCE_GEO`) under
{work_dir}/{datas}/test_out/iter_{n}/{reduced|full}/{id}_mul_hat.tif.

The training step (`train_step`; `lgteun_tpu/runner.py:187-338`) takes
the JAX Runner's three modes:

- `remat` (`cfg.get("remat")`): the loss runs inside
  `torch.utils.checkpoint` (non-reentrant), as JAX wraps it in
  `jax.checkpoint`: the backward recomputes the forward instead of
  keeping its activations. The checkpointed function makes its dropout
  generator from (seed + 1, iteration) itself on every call, so the
  replay draws the masks (and MutInf's noise) of the forward; an
  explicit generator is not among the states that `preserve_rng_state`
  restores. The parameters follow the run without remat bit for bit.
- `mixed_precision`: a method with `handles_mixed` (UnlgFormer) runs it
  inside its module; every other runs `losses` under
  `TorchMethod.training_cast(bfloat16)` on bfloat16 copies of the
  batch's floating tensors, and the total goes back to float32. The
  parameters, their gradients, the optimiser states and the schedules
  stay float32.
- adversarial training (a method with a discriminator, `adv_loss` in
  its `loss_cfg`): `_adversarial_step`, the JAX Runner's alternating
  two-optimiser step. `mixed_precision` then logs a warning and the
  step runs float32, and `remat` is not applied, as in JAX.

Data parallelism (`mesh`, `parallel/mesh.py`; the JAX Runner's mesh,
runner.py:116-140, 373-375): the Runner runs on one rank of a `Mesh`
(by default `make_mesh(cfg.mesh_shape)`: one rank without a launcher,
with no collective, bit-equal to the Runner before it had a mesh; under
`torchrun` every rank of the launch). A run over W ranks computes what
the one-rank run computes, up to the order of the gradient sums:

- `train()`: every rank draws the same global batch from the same
  seeded `train_iterator` and `train_step` keeps the rank's rows
  (`shard_batch`: rows [r*B/W, (r+1)*B/W), or the whole batch on every
  rank when B % W != 0, as JAX's `_put_batch` replicates it). The
  step's generator is a `ShardGenerator` (the same seed on every rank,
  the rank's rows named), through which the dropout masks, MutInf's
  noise and WGAN-GP's eps are the rank's rows of the one-rank draws and
  every loss part is the global batch's value whose backward reaches the
  rank's rows. Before each optimiser's `step()` its module's gradients
  are SUM-reduced (`all_reduce_grads`; the adversarial step reduces the
  discriminator's, then the generator side's); a replicated batch's
  gradients are averaged. The logged parts are the global batch's.
- `init`, `load`, `load_checkpoint`: every rank; the weights are then
  broadcast from rank 0 (`replicated`).
- `save`, `log_eval_curves`, the log: rank 0, `save` followed by a
  barrier.
- `test()`: each rank scores its rows of each eval batch; the per-image
  scores are gathered in order, so `eval_results` and `image_scores` are
  the one-rank run's; with `save` each rank writes the TIFFs of its own
  real rows (rank 0 all of a replicated batch), each once; the time per
  image is the slowest rank's forward time over the global count.
- A mesh with a `space` axis (`mesh_shape` {"data": d, "space": s}): the
  batch rows go over `data` as above and every rank of a space group
  holds the same rows and runs the whole forward, as the JAX Runner's
  P("data") batch sharding leaves the space axis replicated; gradients
  and scores reduce over the data group alone, and the first rank of
  each space group writes its TIFFs. Height-sharded eval forwards are
  `parallel/spatial.py`'s.

Left out: the JAX Runner's device prefetch and multi-step dispatch (TPU
round-trip workarounds; `steps_per_dispatch` changes no number, and the
Runner warns when a config sets it to another value than 1).

Numerics: the JAX scoring engine runs float32 at `highest` precision,
while cuDNN runs float32 convolutions in TF32 by default. The Runner
therefore turns TF32 off for cuBLAS and cuDNN (process-wide) when it is
built.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import time

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from lgteun_tpu_torch.config import Config, OptimCfg
from lgteun_tpu_torch.data.pipeline import (data_denormalize, eval_batches,
                                            train_iterator)
from lgteun_tpu_torch.data.tiff import REFERENCE_GEO, write_tiff
from lgteun_tpu_torch.losses import gan_d_loss, gan_g_loss
from lgteun_tpu_torch.metrics.torch_metrics import (no_ref_evaluate_batch,
                                                    ref_evaluate_batch)
from lgteun_tpu_torch.models.base import TorchMethod, _nchw
from lgteun_tpu_torch.parallel.mesh import (Mesh, Shard, ShardGenerator,
                                            all_gather_rows,
                                            all_reduce_grads,
                                            check_mesh_shape, make_mesh,
                                            replicated, shard_batch)

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


def step_generator(seed: int, iter_id: int, device: torch.device,
                   shard: Shard | None = None) -> torch.Generator:
    """A generator on `device` seeded from (seed, iter_id) alone; with a
    `shard`, the `ShardGenerator` of the rank's rows (the same seed)."""
    state = np.random.SeedSequence([seed, iter_id]).generate_state(
        1, np.uint64)[0]
    gen = (torch.Generator(device=device) if shard is None
           else ShardGenerator(device, shard))
    return gen.manual_seed(int(state) >> 1)


def read_checkpoint(path: str, map_location) -> tuple:
    """(core state_dict, iter_num or None, {"modules", "optimizers",
    "schedulers"} or None) of a Runner checkpoint (`Runner.save`: a dict
    with "state_dict" and "iter_num") or of a bare state_dict, which
    gives (it, None, None). Each entry of the third maps a module's name
    to its weights (the modules other than the core one), its optimizer
    state or its scheduler state; a checkpoint with one "optimizer" and
    one "scheduler" gives them as the core module's. A file that
    `torch.load(weights_only=True)` refuses (the reference's pickle of
    whole modules) raises a ValueError that names its converter."""
    try:
        payload = torch.load(path, map_location=map_location,
                             weights_only=True)
    except pickle.UnpicklingError as e:
        named = re.search(r"GLOBAL (\S+)", str(e))
        raise ValueError(
            f"{path} is neither a Runner checkpoint nor a state_dict: "
            "torch.load(weights_only=True) refused it"
            + (f" (it names {named.group(1)})" if named else "") + ". A "
            "reference checkpoint (a pickle of whole modules) is "
            "converted first: python -m "
            "lgteun_tpu_torch.convert.from_reference --model-type X "
            f"--torch-ckpt {path} --out OUT.pt") from e
    if not isinstance(payload.get("state_dict"), dict):
        return payload, None, None
    restored = {"modules": payload.get("modules", {}),
                "optimizers": payload.get("optimizers", {}),
                "schedulers": payload.get("schedulers", {})}
    if "optimizer" in payload:
        restored["optimizers"] = {"core_module": payload["optimizer"]}
        restored["schedulers"] = {"core_module": payload["scheduler"]}
    return payload["state_dict"], int(payload["iter_num"]), restored


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a and b name one device ("cuda" is the current card)."""
    index = lambda d: (torch.cuda.current_device() if d.index is None
                       and d.type == "cuda" else d.index)
    return a.type == b.type and index(a) == index(b)


class Runner:
    """Owns the train/eval/checkpoint lifecycle of one TorchMethod on one
    device, one rank of `mesh` (module docstring)."""

    def __init__(self, cfg: Config, method: TorchMethod, device,
                 logger: logging.Logger | None = None, train_ds=None,
                 test_ds_full=None, test_ds_reduced=None,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.method = method
        self.device = torch.device(device)
        if method.device != self.device:
            raise ValueError(f"method is on {method.device}, runner on "
                             f"{self.device}")
        if mesh is None:
            mesh = make_mesh(cfg.mesh_shape, device=self.device)
        elif cfg.mesh_shape and check_mesh_shape(
                cfg.mesh_shape, mesh.world) != (mesh.data_world,
                                                mesh.space_world):
            raise ValueError(
                f"mesh_shape {cfg.mesh_shape} but the mesh given is data="
                f"{mesh.data_world} x space={mesh.space_world}")
        if not _same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's rank is on {mesh.device}, the "
                             f"runner on {self.device}")
        self.mesh = mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # a bf16 GEMM accumulates and reduces in float32 (the mixed paths'
        # float32 products of bf16 operands, JAX's preferred_element_type)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        self.logger = logger or logging.getLogger("lgteun_torch")
        if mesh.rank:
            # rank 0 logs; the others only their warnings and errors
            self.logger = self.logger.getChild(f"rank{mesh.rank}")
            self.logger.setLevel(logging.WARNING)
        if cfg.get("steps_per_dispatch", 1) != 1:
            self.logger.warning(
                f"steps_per_dispatch={cfg.get('steps_per_dispatch')} is the "
                "JAX Runner's TPU dispatch setting; the port dispatches each "
                "step, which changes no number")
        self.adversarial = method.adv_name is not None
        self.remat = bool(cfg.get("remat", False))
        mixed = bool(cfg.get("mixed_precision", False))
        if mixed and self.adversarial:
            self.logger.warning("mixed_precision=True is not implemented for "
                                "adversarial training; the GAN step runs in "
                                "f32")
        # the blanket cast's dtype, or None
        self.blanket = (torch.bfloat16 if mixed and not self.adversarial
                        and not method.handles_mixed
                        else None)
        self.train_ds = train_ds
        self.test_ds_full, self.test_ds_reduced = test_ds_full, test_ds_reduced
        self.eval_results: dict[str, list] = {}  # tag/metric: (it, mean, std)
        self.image_scores: dict[str, dict] = {}  # tag: {"image_id", metric}
        self.last_time_per_image = float("nan")
        self.last_iter = 0
        self.loss_log: list[tuple[int, dict]] = []  # (iter, loss means)
        self.optimizers: dict[str, torch.optim.Optimizer] = {}
        self.schedulers: dict[str, torch.optim.lr_scheduler.StepLR] = {}
        self._restored = None   # optimizer/scheduler states to resume
        self.last_outputs: list[str] = []  # TIFFs this rank last wrote

    @property
    def optimizer(self) -> torch.optim.Optimizer | None:
        """The core module's optimiser (None before `set_optim`)."""
        return self.optimizers.get("core_module")

    @property
    def scheduler(self):
        """The core module's StepLR (None before `set_optim`)."""
        return self.schedulers.get("core_module")

    def init(self, seed: int | None = None) -> "Runner":
        """Seeded torch-default init of every parameter of every module;
        the sides of the first item of the first dataset given (train,
        reduced, full) are the method's `sample_hw`, as in the JAX
        Runner."""
        seed = self.cfg.seed if seed is None else seed
        sample_hw = None
        for ds in (self.train_ds, self.test_ds_reduced, self.test_ds_full):
            if ds is not None and len(ds) > 0:
                item = ds[0]
                sample_hw = (item["input_lr"].shape[0],
                             item["input_pan"].shape[0])
                break
        self.method.init_params(torch.Generator().manual_seed(seed),
                                sample_hw)
        replicated(self.method.modules().values(), self.mesh)
        if self.method.trainable:
            for name, n in self.method.param_counts().items():
                self.logger.info(f"Total params of module {name}: {n:,}")
        return self

    def load(self, state_dict: dict) -> "Runner":
        """Reference-keyed weights (strict)."""
        self.method.load_state_dict(state_dict, strict=True)
        replicated(self.method.modules().values(), self.mesh)
        return self

    def to_device(self, batch: dict) -> dict:
        """The batch's arrays (or tensors) as float32 tensors on the
        runner's device, the image ids left out."""
        return {k: v.to(self.device, torch.float32)
                if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(v, np.float32)).to(self.device)
                for k, v in batch.items() if k != "image_id"}

    def predict(self, batch: dict) -> torch.Tensor:
        """NHWC batch -> NHWC prediction on the runner's device."""
        return self.method.apply(batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ train

    def set_optim(self) -> "Runner":
        """Each module's optimiser (`optim_cfg[name]`, default Adam lr
        1e-4) and its StepLR; states restored by `load_checkpoint` are
        loaded into them, so init -> load_checkpoint -> set_optim
        resumes the moments and the schedule. A training-free method has
        nothing to optimise."""
        if not self.method.trainable:
            return self
        self.optimizers, self.schedulers = {}, {}
        for name, module in self.method.modules().items():
            opt = make_optimizer(module.parameters(),
                                 self.cfg.optim_cfg.get(name, OptimCfg()))
            self.optimizers[name] = opt
            self.schedulers[name] = torch.optim.lr_scheduler.StepLR(
                opt, step_size=self.cfg.sched_cfg.step_size,
                gamma=self.cfg.sched_cfg.gamma)
        if self._restored is not None:
            for name, state in self._restored["optimizers"].items():
                self.optimizers[name].load_state_dict(state)
            for name, state in self._restored["schedulers"].items():
                self.schedulers[name].load_state_dict(state)
            self._restored = None
        return self

    def _losses(self, batch: dict, iter_id: int,
                shard: Shard | None = None) -> tuple:
        """(total, parts) of the step at `iter_id` on the rank's rows of
        the global batch (`shard`; None: the batch is all of it), its
        dropout generator made here from (seed + 1, iter_id), so that a
        remat replay draws the same masks; under the blanket cast on
        bfloat16 copies of the parameters and of the batch's floating
        tensors, the total float32."""
        gen = step_generator(self.cfg.seed + 1, iter_id, self.device, shard)
        if self.blanket is None:
            return self.method.losses(batch, gen, iter_id)
        cast = {k: v.to(self.blanket) if v.is_floating_point() else v
                for k, v in batch.items()}
        with self.method.training_cast(self.blanket):
            total, parts = self.method.losses(cast, gen, iter_id)
        return total.float(), parts

    def train_step(self, batch: dict, iter_id: int) -> dict:
        """One step of every module's optimiser on the global batch
        (arrays, or tensors such as `to_device` gives) at iteration
        `iter_id` (0-based): the rank takes its rows (`shard_batch`) to
        its device; returns the loss parts, the global batch's, detached,
        on the device."""
        n = len(next(v for k, v in batch.items() if k != "image_id"))
        shard = self.mesh.shard(n)
        batch = self.to_device(shard_batch(batch, self.mesh))
        self.method.train()
        if self.adversarial:
            parts = self._adversarial_step(batch, iter_id, shard)
        else:
            if self.remat:
                total, parts = checkpoint(self._losses, batch, iter_id,
                                          shard, use_reentrant=False)
            else:
                total, parts = self._losses(batch, iter_id, shard)
            for opt in self.optimizers.values():
                opt.zero_grad(set_to_none=True)
            total.backward()
            self._reduce_grads(self.optimizers, shard)
            for opt in self.optimizers.values():
                opt.step()
        for sched in self.schedulers.values():
            sched.step()
        return {k: v.detach() for k, v in parts.items()}

    def _reduce_grads(self, names, shard: Shard | None) -> None:
        """The gradients of modules `names` summed over the ranks (a
        sharded step), or averaged (a replicated batch: every rank has
        the whole batch's gradient); nothing on one rank."""
        modules = self.method.modules()
        all_reduce_grads([modules[k] for k in names], self.mesh,
                         average=shard is None)

    def _adversarial_step(self, batch: dict, iter_id: int,
                          shard: Shard | None = None) -> dict:
        """The JAX Runner's alternating step (`lgteun_tpu/runner.py:
        270-338`; reference losses.py:68-137): one generator forward
        (`losses(..., with_output=True)`); the discriminator's loss on the
        detached output and the target, its backward and its optimiser's
        step; the generator's adversarial term against the updated
        discriminator, whose weights it holds fixed (detached, so they get
        no gradient from it); the generator's backward and the step of
        every other module's optimiser. Log parts `<adv>_G` and
        `<adv>_D`; the WGAN-GP eps comes from the step's generator, after
        the forward's draws. On a mesh the discriminator's gradients are
        reduced before its step, the other modules' before theirs."""
        method, adv = self.method, self.method.adv_cfg
        gen = step_generator(self.cfg.seed + 1, iter_id, self.device, shard)
        total, parts, out = method.losses(batch, gen, iter_id,
                                          with_output=True)
        d_opt = self.optimizers["discriminator"]
        d_opt.zero_grad(set_to_none=True)
        d_loss = gan_d_loss(method.disc, out,
                            _nchw(batch["target"], self.device), adv.type,
                            generator=gen, gp_w=adv.gp_w)
        d_loss.backward()
        self._reduce_grads(["discriminator"], shard)
        d_opt.step()
        fixed = {k: v.detach() for k, v in method.disc.named_parameters()}
        g_adv = gan_g_loss(lambda x: functional_call(method.disc, fixed,
                                                     (x,)), out, adv.type,
                           generator=gen)
        total = total + adv.w * g_adv
        parts[f"{method.adv_name}_G"] = g_adv
        parts[f"{method.adv_name}_D"] = d_loss
        parts["full_loss"] = total
        g_names = [k for k in self.optimizers if k != "discriminator"]
        for k in g_names:
            self.optimizers[k].zero_grad(set_to_none=True)
        total.backward()
        self._reduce_grads(g_names, shard)
        for k in g_names:
            self.optimizers[k].step()
        return parts

    def train(self) -> "Runner":
        """Iterations last_iter .. cfg.max_iter on `train_ds`."""
        cfg = self.cfg
        if not self.method.trainable:
            self.logger.info("method is training-free; skipping train()")
            return self
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
                window.append(self.train_step(next(it), iter_id))
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
                        and self.test_ds_reduced is not None:
                    self.test(iter_id=iter_id, ref=True)
                if cfg.test_freq and iter_id % cfg.test_freq == 0 \
                        and self.test_ds_full is not None:
                    self.test(iter_id=iter_id, ref=False)
        finally:
            self.last_iter = iter_id
            self.method.eval()
        return self

    # ------------------------------------------------------------- eval

    def test(self, dataset=None, iter_id: int = 0, save: bool = False,
             ref: bool = True) -> dict:
        """Score `dataset`, or without it the reduced-resolution split
        (ref=True) or the full-resolution one (ref=False) -> {metric:
        (mean, std)}; {} when that split is not set. A split without
        targets takes the no-reference metrics, and its scores, log lines
        and outputs the full-resolution tag and folder (every batch has
        the keys of the split's first item). `dataset` yields
        PSDataset item dicts (NHWC `input_lr`, `input_pan`, `target` in
        DN) and has `pairs` for the ids. The module runs in eval mode and
        is put back in its mode after. On a mesh each rank scores its
        rows of each batch (module docstring)."""
        ds = dataset if dataset is not None else (
            self.test_ds_reduced if ref else self.test_ds_full)
        if ds is None:
            return {}
        ref = ref and "target" in ds[0]
        cfg = self.cfg
        training = self.method.training
        self.method.eval()
        bs = max(cfg.eval_batch_size, 1)
        dr = 2.0 ** cfg.bit_depth - 0.5
        per_metric: dict[str, list] = {}
        ids, outputs = [], []
        n_images, fwd_time = 0, 0.0
        shard = self.mesh.shard(bs)
        # the batch rows this rank scores and, with `save`, writes
        first = 0 if shard is None else shard.start
        writes = self.mesh.space_rank == 0 and (
            shard is not None or self.mesh.data_rank == 0)
        for batch, n_valid in eval_batches(ds, bs, bit_depth=cfg.bit_depth,
                                           normalize=cfg.norm_input):
            local = shard_batch(batch, self.mesh)
            arrays = self.to_device(local)
            t0 = time.perf_counter()
            pred = self.predict(arrays)
            self._sync()
            fwd_time += time.perf_counter() - t0
            n_images += n_valid
            if ref:
                scores = ref_evaluate_batch(
                    data_denormalize(pred, cfg.bit_depth),
                    data_denormalize(arrays["target"], cfg.bit_depth),
                    dynamic_range=dr)
            else:
                scores = no_ref_evaluate_batch(pred, arrays["input_lr"],
                                               arrays["input_pan"])
            if shard is not None:
                names = list(scores)
                rows = all_gather_rows(torch.stack(
                    [scores[k] for k in names], dim=1), self.mesh)
                scores = {k: rows[:, i] for i, k in enumerate(names)}
            for k, v in scores.items():
                per_metric.setdefault(k, []).extend(v[:n_valid].tolist())
            ids.extend(batch["image_id"][:n_valid])
            mine = max(0, min(n_valid - first, len(pred)))
            if save and writes and mine:
                outputs.append((local["image_id"][:mine],
                                pred[:mine].cpu().numpy()))
        self.method.train(training)
        results = {k: (float(np.mean(v)), float(np.std(v)))
                   for k, v in per_metric.items()}
        tag = "reduced-res (ref)" if ref else "full-res (no-ref)"
        self.image_scores[tag] = {"image_id": ids, **per_metric}
        for k, (mean, std) in results.items():
            self.eval_results.setdefault(f"{tag}/{k}", []).append(
                (iter_id, mean, std))
            self.logger.info(f"[iter {iter_id}] {tag} {k}: "
                             f"{mean:.4f} +- {std:.4f}")
        self.last_time_per_image = (self.mesh.reduce_max(fwd_time)
                                    / max(n_images, 1))
        ranks = f", {self.mesh.world} ranks" if self.mesh.world > 1 else ""
        self.logger.info(
            f"[iter {iter_id}] {tag} avg time per img: "
            f"{self.last_time_per_image * 1000:.3f} ms "
            f"({n_images} images, batch {bs}, {self.device}{ranks})")
        if save:
            self.last_outputs = self._save_outputs(outputs, iter_id, ref)
            self.mesh.barrier()
        return results

    def _save_outputs(self, outputs: list, iter_id: int,
                      ref: bool) -> list[str]:
        """Each prediction as a uint16 GeoTIFF with the reference's fake
        georeference (reference base_model.py:336-337 ->
        dataset/utils.py:42-86): rounded DN, clipped to [0, 65535]; the
        paths written."""
        out_dir = os.path.join(self.cfg.work_dir, self.cfg.datas, "test_out",
                               f"iter_{iter_id}",
                               "reduced" if ref else "full")
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for image_ids, preds in outputs:
            for image_id, pred in zip(image_ids, preds):
                arr = np.clip(np.round(data_denormalize(
                    pred, self.cfg.bit_depth)), 0, 65535).astype(np.uint16)
                paths.append(os.path.join(out_dir,
                                          f"{image_id}_mul_hat.tif"))
                write_tiff(paths[-1], arr, geo=REFERENCE_GEO)
        return paths

    def log_eval_curves(self) -> str:
        """Log and write the accumulated metric curves to
        {work_dir}/{datas}/eval_curves.json (reference
        base_model.py:348-351)."""
        for key, curve in self.eval_results.items():
            pts = ", ".join(f"{it}:{m:.4f}" for it, m, _ in curve)
            self.logger.info(f"eval curve {key}: {pts}")
        out = os.path.join(self.cfg.work_dir, self.cfg.datas,
                           "eval_curves.json")
        if self.mesh.rank == 0:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as f:
                json.dump(self.eval_results, f, indent=1)
        return out

    # ------------------------------------------------------ checkpoints

    def save(self, iter_id: int) -> str:
        """{work_dir}/{datas}/train_out/model_iter_{iter_id}.pt: the core
        module's weights ("state_dict"), the other modules' ("modules"),
        every optimizer and scheduler state by module name and the
        iteration. Rank 0 writes it; every rank returns after it is
        written."""
        out = os.path.join(self.cfg.work_dir, self.cfg.datas, "train_out")
        path = os.path.abspath(os.path.join(out, f"model_iter_{iter_id}.pt"))
        if self.mesh.rank == 0:
            self._write_checkpoint(path, iter_id)
        self.mesh.barrier()
        return path

    def _write_checkpoint(self, path: str, iter_id: int) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"state_dict": self.method.state_dict(),
                   "iter_num": iter_id}
        extra = {name: m.state_dict() for name, m in
                 self.method.modules().items() if name != "core_module"}
        if extra:
            payload["modules"] = extra
        if self.optimizers:
            payload["optimizers"] = {k: v.state_dict()
                                     for k, v in self.optimizers.items()}
            payload["schedulers"] = {k: v.state_dict()
                                     for k, v in self.schedulers.items()}
        torch.save(payload, path)
        self.logger.info(f"saved checkpoint {path}")

    def load_checkpoint(self, path: str) -> "Runner":
        """Weights from a Runner checkpoint (`save`) or a bare state_dict
        (the CLI's form, `convert/from_jax.py`'s output). A Runner
        checkpoint also restores the other modules' weights, last_iter
        and the optimizer and scheduler states, so that train() resumes
        mid-schedule; a bare state_dict sets the core module's weights
        alone."""
        state_dict, iter_num, restored = read_checkpoint(path, self.device)
        self.method.load_state_dict(state_dict, strict=True)
        if iter_num is not None:
            self.last_iter = iter_num
        if restored is not None:
            for name, sd in restored["modules"].items():
                self.method.load_module_state_dict(name, sd, strict=True)
        replicated(self.method.modules().values(), self.mesh)
        if restored is not None:
            if restored["optimizers"]:
                self._restored = restored
                if self.optimizers:
                    self.set_optim()
        self.logger.info(f"loaded checkpoint {path} (iter {self.last_iter})")
        return self

    def load_pretrained(self, path: str) -> "Runner":
        """Weights only: the iteration and optimizer state start anew."""
        self.load_checkpoint(path)
        self.last_iter, self._restored = 0, None
        self.optimizers, self.schedulers = {}, {}
        return self
