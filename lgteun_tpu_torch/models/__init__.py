"""Port model registration: importing this package registers every
ported method into `lgteun_tpu_torch.registry.MODELS`."""

from lgteun_tpu_torch.models.base import TorchMethod
from lgteun_tpu_torch.models.lgteun import LGTEUN
from lgteun_tpu_torch.registry import MODELS

__all__ = ["UnlgFormer", "TorchMethod"]


@MODELS.register()
class UnlgFormer(TorchMethod):
    """LGTEUN flagship (reference models/unlg_former.py:70-113), eval
    path: K = `model_cfg["core_module"]["stage"]` unfolding steps
    (default 5, as in the JAX Method), embed 4 * ms_chans."""

    def make_module(self):
        g_cfg = dict(self.cfg.model_cfg.get("core_module", {}))
        return LGTEUN(ms_chans=self.cfg.ms_chans,
                      stage=g_cfg.get("stage", 5))
