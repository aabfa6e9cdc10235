"""Host utilities of the port (counterpart of `lgteun_tpu/utils`):
.mat files and PNG previews."""

from lgteun_tpu_torch.utils.io import load_mat, save_mat  # noqa: F401
from lgteun_tpu_torch.utils.viz import (linear_stretch,  # noqa: F401
                                        save_preview_png)
