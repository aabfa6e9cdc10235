"""Port model registration: importing this package registers every
ported method into `lgteun_tpu_torch.registry.MODELS`."""

import contextlib
import math
import os

import torch

from lgteun_tpu_torch.losses import (MutualInfoReg, build_loss_weights,
                                     reconstruction_loss)
from lgteun_tpu_torch.models.base import (ClassicalMethod, TorchMethod,
                                          _nchw, swapped)
from lgteun_tpu_torch.models.classical import (gsa_fuse, sfim_fuse,
                                               wavelet_fuse)
from lgteun_tpu_torch.models.innt import GPPNNINNT
from lgteun_tpu_torch.models.lgteun import LGTEUN
from lgteun_tpu_torch.models.lightnet import (LightNetModule,
                                              lightnet_fast_forward,
                                              tap_dtype)
from lgteun_tpu_torch.models.mdcun import PanUnfolding
from lgteun_tpu_torch.models.mutinf import GPPNNMutInf
from lgteun_tpu_torch.models.panformer import CrossSwinTransformer
from lgteun_tpu_torch.models.sfiin import SFIINNet, spectrum_amp_phase
from lgteun_tpu_torch.ops import (fuse_level, storage_dtype,
                                  windows_layout_attention)
from lgteun_tpu_torch.parallel.mesh import batch_mean
from lgteun_tpu_torch.registry import MODELS

__all__ = ["UnlgFormer", "lightnet", "MDCUN", "INNT", "PanFormer", "SFIIN",
           "MutInf", "GSA", "SFIM", "Wavelet", "TorchMethod",
           "ClassicalMethod"]


@MODELS.register()
class UnlgFormer(TorchMethod):
    """LGTEUN flagship (reference models/unlg_former.py:70-113), eval
    and training: K = `model_cfg["core_module"]["stage"]` unfolding steps
    (default 5, as in the JAX Method), embed 4 * ms_chans, Dropout
    `drop_rate` (default 0.1) after each mixer proj in training. Each LGB
    block runs as `LGTEUN_FUSE_LEVEL` and `LGTEUN_FUSED_ATTENTION` say
    when the method is built (`ops.fuse_level`,
    `ops.windows_layout_attention`), and its eval forward stores its
    activations as `LGTEUN_EVAL_DTYPE` says then (`ops.storage_dtype`:
    "bf16res" or "bf16"; the output is float32).

    `mixed_precision` training is selective, inside the module
    (`handles_mixed`; `lgteun_tpu/models/__init__.py:28-47`): each LGB
    block of a training forward runs the local mixer, the proj and the
    LN-FFN on bfloat16 operands and keeps the LNs, the global mixer, the
    residual stream, the trunk and the unfolding steps float32
    (`common/lgt.py`). The eval forward stays the float32 kernels', as
    the JAX package's TPU eval path (`lgteun_fast_forward`) is."""

    bf16_storage = True
    handles_mixed = True

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return LGTEUN(ms_chans=self.cfg.ms_chans,
                      stage=g_cfg.get("stage", 5), level=fuse_level(),
                      drop_rate=g_cfg.get("drop_rate", 0.1),
                      windows=windows_layout_attention(),
                      storage=storage_dtype(),
                      mixed=(torch.bfloat16
                             if self.cfg.get("mixed_precision") else None))

    def forward(self, ms, pan, generator=None):
        return self.module(ms, pan, generator)


@MODELS.register()
class lightnet(TorchMethod):  # noqa: N801  (the reference's name)
    """LightNet (reference models/lightnet.py:138-139), eval and
    training: the SpanConv stack runs as `lightnet_stack` in both. The
    JAX package trains on its flax chain and takes its kernel only when
    not training (lgteun_tpu/models/lightnet.py:170-172); the port trains
    through the kernel's forward with the plain chain's backward
    (`ops.autograd.recompute`), the same function, so that a card never
    runs a plain forward.

    Under `LGTEUN_LIGHTNET_DTYPE=bf16`, or `LGTEUN_EVAL_DTYPE=bf16` with
    LGTEUN_LIGHTNET_DTYPE unset (`lightnet.tap_dtype`, read when the
    method is built), `apply` runs the bf16 tap path instead, as JAX's
    `lightnet.apply` does on the TPU (`lightnet_fast_forward`; no blanket
    cast, no kernel). "bf16res" leaves it float32 (ROADMAP C.39)."""

    bf16_cast = False

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.tap_dtype = tap_dtype()

    def make_module(self):
        return LightNetModule(ms_chans=self.cfg.ms_chans)

    def taps(self) -> bool:
        """True where the eval forward takes the tap path."""
        return self.tap_dtype is not None and not self.training

    def eval_forward(self, ms, pan):
        with self.eval_cast(ms, pan) as (ms, pan):
            if self.taps():
                return lightnet_fast_forward(self.module, ms, pan,
                                             self.tap_dtype)
            return self.forward(ms, pan)

    @contextlib.contextmanager
    def eval_cast(self, ms, pan):
        """The tap path's context: the module holds the `tap_dtype` copy
        of its parameters (ms and pan stay float32: the stack's input is
        cast inside the path)."""
        if not self.taps():
            yield ms, pan
            return
        cast, _ = self.cast_parameters(self.tap_dtype, ms, pan)
        with swapped(self.module, cast):
            yield ms, pan


@MODELS.register()
class MDCUN(TorchMethod):
    """MDCUN (reference models/MDCUN.py:422-464), eval and training (the
    neighbourhood attention's kernel forward, its plain backward):
    `model_cfg["core_module"]` may set `mid_channels` (default 64) and
    `T` stages (default 4)."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return PanUnfolding(ms_chans=self.cfg.ms_chans,
                            mid_channels=g_cfg.get("mid_channels", 64),
                            stages=g_cfg.get("T", 4))


@MODELS.register()
class INNT(TorchMethod):
    """INNT (reference models/INNT.py:393-450), eval and training:
    `model_cfg["core_module"]` may set `n_feat` (default 8). The texture
    transformer runs `texture_match` (whole chain) unless LGTEUN_FUSED_TM
    is "0" when the method is built, as in the JAX package
    (lgteun_tpu/models/innt.py:57); then it runs `patch_match`. In
    training either search's backward searches again in the plain
    version (`ops.autograd.recompute`), as the JAX `custom_vjp`s do."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return GPPNNINNT(
            ms_chans=self.cfg.ms_chans, n_feat=g_cfg.get("n_feat", 8),
            whole_chain=os.environ.get("LGTEUN_FUSED_TM", "1") == "1")


@MODELS.register()
class PanFormer(TorchMethod):
    """PanFormer (reference models/panformer.py:111-153), eval and the
    generic training (its shipped loss is `rec_loss` alone):
    `model_cfg["core_module"]` may set n_feats (default 64), n_heads (4),
    head_dim (16), win_size (4) and n_blocks (3)."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return CrossSwinTransformer(
            ms_chans=self.cfg.ms_chans, n_feats=g_cfg.get("n_feats", 64),
            n_heads=g_cfg.get("n_heads", 4),
            head_dim=g_cfg.get("head_dim", 16),
            win_size=g_cfg.get("win_size", 4),
            n_blocks=g_cfg.get("n_blocks", 3),
            norm_input=self.cfg.norm_input, bit_depth=self.cfg.bit_depth)


@MODELS.register()
class SFIIN(TorchMethod):
    """SFIIN (reference models/SFIIN.py:343-408), eval and training with
    its frequency losses (`fre_amp_rec_loss`, `fre_pha_rec_loss`: the
    configured loss between the rfft2 amplitudes and phases of output
    and target, `models/sfiin.py::spectrum_amp_phase`)."""

    def make_module(self):
        return SFIINNet(ms_chans=self.cfg.ms_chans)

    def losses(self, batch: dict, generator: torch.Generator | None = None,
               iter_id: int = 0, with_output: bool = False):
        """As the JAX `SFIIN.losses` (lgteun_tpu/models/sfiin.py:
        128-158): `rec_loss` on the output, the two frequency losses on
        its spectrum; any other weighted entry (`QNR_loss` among them) is
        skipped as JAX skips it."""
        weights = build_loss_weights(self.cfg.loss_cfg)
        out = self.forward(_nchw(batch["input_lr"], self.device),
                           _nchw(batch["input_pan"], self.device))
        target = _nchw(batch["target"], self.device)
        pairs = {"rec_loss": (out, target)}
        if any("fre_" in name for name in weights):
            (out_amp, out_pha), (tgt_amp, tgt_pha) = (
                spectrum_amp_phase(out), spectrum_amp_phase(target))
            pairs.update(fre_amp_rec_loss=(out_amp, tgt_amp),
                         fre_pha_rec_loss=(out_pha, tgt_pha))
        total = torch.zeros((), device=self.device)
        parts = {}
        for name, lcfg in weights.items():
            if name in pairs:
                parts[name] = batch_mean(reconstruction_loss(
                    *pairs[name], lcfg.type), generator)
                total = total + lcfg.w * parts[name]
        parts["full_loss"] = total
        return (total, parts, out) if with_output else (total, parts)


@MODELS.register()
class MutInf(TorchMethod):
    """MutInf (reference models/MutInf.py:452-505): the core module
    (`model_cfg["core_module"]` may set n_feat, default 8) and the `mi`
    module (`losses.MutualInfoReg` over the core's PAN and MS features),
    each with its own optimiser (`optim_cfg["mi"]`, default Adam lr
    1e-4). The heads' width follows the PAN side the method is built for
    (`pan_size`, 128 by default; `init_params(sample_hw=...)` and a
    loaded `mi` state_dict reset it), as the JAX Method's `sample_hw`.
    `LGTEUN_EVAL_DTYPE=bf16` leaves it float32: JAX's MutInf overrides
    `apply` and never casts (lgteun_tpu/models/mutinf.py:235-239)."""

    module_names = ("core_module", "mi")
    bf16_cast = False

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.mi = self._make_mi(128)

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return GPPNNMutInf(ms_chans=self.cfg.ms_chans,
                           n_feat=g_cfg.get("n_feat", 8))

    def _make_mi(self, pan_size: int) -> MutualInfoReg:
        """A `mi` module on the meta device for PAN side `pan_size` (two
        stride-2 convs: the encoded side is pan_size // 4)."""
        self.pan_size = pan_size
        with torch.device("meta"):
            mi = MutualInfoReg(input_channels=4, channels=4, latent_size=4,
                               side=pan_size // 2 // 2)
        return mi.train(self.module.training)

    def modules(self) -> dict:
        return {"core_module": self.module, "mi": self.mi,
                **self._disc_modules()}

    def init_params(self, generator: torch.Generator, sample_hw=None):
        if sample_hw is not None and sample_hw[1] != self.pan_size:
            self.mi = self._make_mi(sample_hw[1])
        return super().init_params(generator, sample_hw)

    def load_module_state_dict(self, name: str, state_dict: dict,
                               strict: bool = True):
        """As `TorchMethod.load_module_state_dict`; a `mi` state_dict whose
        heads are another width rebuilds `mi` for that PAN side first."""
        if name == "mi":
            side = math.isqrt(state_dict["fc1_rgb3.weight"].shape[1] // 4)
            if side != self.pan_size // 2 // 2:
                self.mi = self._make_mi(4 * side)
        return super().load_module_state_dict(name, state_dict, strict)

    def forward(self, ms, pan, generator=None):
        return self.module(ms, pan)[0]

    def losses(self, batch: dict, generator: torch.Generator | None = None,
               iter_id: int = 0, with_output: bool = False, noise=None):
        """As the JAX `MutInf.losses` (lgteun_tpu/models/mutinf.py:
        241-266): `rec_loss` on hr, and `MI_rec_loss`, the loss of
        mi = clip(MutualInfoReg(panf, mhrf), -1, 1) against 2 mi (|mi|
        for l1) weighted by w * min(iter_id / max_iter, 1), the ramp in
        float32; any other entry is skipped, as JAX skips it. `noise` =
        (eps_a, eps_b) replaces the draws from `generator`. Under a
        data-parallel step's generator mi is the global batch's (a sum of
        BCE sums and a mean KL, `losses.MutualInfoReg`) before its
        clip."""
        weights = build_loss_weights(self.cfg.loss_cfg)
        hr, panf, mhrf = self.module(_nchw(batch["input_lr"], self.device),
                                     _nchw(batch["input_pan"], self.device))
        total = torch.zeros((), device=self.device)
        parts = {}
        if "rec_loss" in weights:
            lcfg = weights["rec_loss"]
            parts["rec_loss"] = batch_mean(reconstruction_loss(
                hr, _nchw(batch["target"], self.device), lcfg.type),
                generator)
            total = total + lcfg.w * parts["rec_loss"]
        if "MI_rec_loss" in weights:
            lcfg = weights["MI_rec_loss"]
            mi = self.mi(panf, mhrf, generator, noise).clamp(-1.0, 1.0)
            parts["MI_rec_loss"] = reconstruction_loss(mi, 2.0 * mi,
                                                       lcfg.type)
            ramp = (torch.tensor(iter_id, dtype=torch.float32)
                    / max(self.cfg.max_iter, 1)).clamp(max=1.0)
            total = total + lcfg.w * ramp * parts["MI_rec_loss"]
        parts["full_loss"] = total
        return (total, parts, hr) if with_output else (total, parts)


@MODELS.register()
class GSA(ClassicalMethod):
    """Component substitution (reference models/GSA.py)."""

    fuse_fn = staticmethod(gsa_fuse)


@MODELS.register()
class SFIM(ClassicalMethod):
    """Smoothing-filter intensity modulation (reference models/SFIM.py)."""

    fuse_fn = staticmethod(sfim_fuse)


@MODELS.register()
class Wavelet(ClassicalMethod):
    """Wavelet substitution (reference models/Wavelet.py)."""

    fuse_fn = staticmethod(wavelet_fuse)
