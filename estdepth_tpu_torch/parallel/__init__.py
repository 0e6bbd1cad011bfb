"""Data parallelism across processes (port of estdepth_tpu/parallel/):
the process group, the `data` mesh over it, and DDP replicas; and the
width-sharded eval forward over the same mesh (parallel/spatial.py)."""

from estdepth_tpu_torch.parallel.mesh import (
    Mesh, barrier, create_mesh, init_distributed, process_count,
    process_index, replicate, shard_batch, shutdown,
)
from estdepth_tpu_torch.parallel.spatial import make_spatial_window_fn

__all__ = ["Mesh", "barrier", "create_mesh", "init_distributed",
           "make_spatial_window_fn", "process_count", "process_index",
           "replicate", "shard_batch", "shutdown"]
