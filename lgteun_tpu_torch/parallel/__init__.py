"""Whole-scene fusion and data parallelism of the port (counterparts of
`lgteun_tpu/parallel/scene.py` and `lgteun_tpu/parallel/mesh.py`)."""

from lgteun_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_grads,
    make_mesh,
    replicated,
    shard_batch,
)
from lgteun_tpu_torch.parallel.scene import fuse_scene  # noqa: F401
