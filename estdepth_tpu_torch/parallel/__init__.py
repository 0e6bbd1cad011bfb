"""Data parallelism across processes (port of estdepth_tpu/parallel/):
the process group, the `data` mesh over it, and DDP replicas."""

from estdepth_tpu_torch.parallel.mesh import (
    Mesh, barrier, create_mesh, init_distributed, process_count,
    process_index, replicate, shard_batch, shutdown,
)

__all__ = ["Mesh", "barrier", "create_mesh", "init_distributed",
           "process_count", "process_index", "replicate", "shard_batch",
           "shutdown"]
