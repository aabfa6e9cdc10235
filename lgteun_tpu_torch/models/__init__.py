"""Port model registration: importing this package registers every
ported method into `lgteun_tpu_torch.registry.MODELS`."""

import os

from lgteun_tpu_torch.models.base import ClassicalMethod, TorchMethod
from lgteun_tpu_torch.models.classical import (gsa_fuse, sfim_fuse,
                                               wavelet_fuse)
from lgteun_tpu_torch.models.innt import GPPNNINNT
from lgteun_tpu_torch.models.lgteun import LGTEUN
from lgteun_tpu_torch.models.lightnet import LightNetModule
from lgteun_tpu_torch.models.mdcun import PanUnfolding
from lgteun_tpu_torch.ops import fuse_level, windows_layout_attention
from lgteun_tpu_torch.registry import MODELS

__all__ = ["UnlgFormer", "lightnet", "MDCUN", "INNT", "GSA", "SFIM",
           "Wavelet", "TorchMethod", "ClassicalMethod"]


@MODELS.register()
class UnlgFormer(TorchMethod):
    """LGTEUN flagship (reference models/unlg_former.py:70-113), eval
    and training: K = `model_cfg["core_module"]["stage"]` unfolding steps
    (default 5, as in the JAX Method), embed 4 * ms_chans, Dropout
    `drop_rate` (default 0.1) after each mixer proj in training. Each LGB
    block runs as `LGTEUN_FUSE_LEVEL` and `LGTEUN_FUSED_ATTENTION` say
    when the method is built (`ops.fuse_level`,
    `ops.windows_layout_attention`)."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return LGTEUN(ms_chans=self.cfg.ms_chans,
                      stage=g_cfg.get("stage", 5), level=fuse_level(),
                      drop_rate=g_cfg.get("drop_rate", 0.1),
                      windows=windows_layout_attention())

    def forward(self, ms, pan, generator=None):
        return self.module(ms, pan, generator)


@MODELS.register()
class lightnet(TorchMethod):  # noqa: N801  (the reference's name)
    """LightNet (reference models/lightnet.py:138-139), eval path: the
    SpanConv stack runs as `lightnet_stack`."""

    def make_module(self):
        return LightNetModule(ms_chans=self.cfg.ms_chans)


@MODELS.register()
class MDCUN(TorchMethod):
    """MDCUN (reference models/MDCUN.py:422-464), eval path:
    `model_cfg["core_module"]` may set `mid_channels` (default 64) and
    `T` stages (default 4)."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return PanUnfolding(ms_chans=self.cfg.ms_chans,
                            mid_channels=g_cfg.get("mid_channels", 64),
                            stages=g_cfg.get("T", 4))


@MODELS.register()
class INNT(TorchMethod):
    """INNT (reference models/INNT.py:393-450), eval path:
    `model_cfg["core_module"]` may set `n_feat` (default 8). The texture
    transformer runs `texture_match` (whole chain) unless LGTEUN_FUSED_TM
    is "0" when the method is built, as in the JAX package
    (lgteun_tpu/models/innt.py:57); then it runs `patch_match`."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return GPPNNINNT(
            ms_chans=self.cfg.ms_chans, n_feat=g_cfg.get("n_feat", 8),
            whole_chain=os.environ.get("LGTEUN_FUSED_TM", "1") == "1")


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
