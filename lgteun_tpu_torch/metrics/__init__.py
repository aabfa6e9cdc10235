"""Metrics of the port: the float64 host oracle (`numpy_ref`) and the
batched torch metrics (`torch_metrics`), under the names of
`lgteun_tpu/metrics/__init__.py`."""

from lgteun_tpu_torch.metrics.numpy_ref import (  # noqa: F401
    DYNAMIC_RANGE,
    ref_evaluate,
    no_ref_evaluate,
    psnr,
    ssim,
    qindex,
    sam,
    ergas,
    scc,
    d_lambda,
    d_s,
    qnr,
)
from lgteun_tpu_torch.metrics.torch_metrics import (  # noqa: F401
    ref_evaluate_batch,
    no_ref_evaluate_batch,
    qindex_global,
    d_lambda_global,
    d_s_global,
)
