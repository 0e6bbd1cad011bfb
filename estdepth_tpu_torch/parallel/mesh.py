"""Process group, data mesh and replica helpers (port of
estdepth_tpu/parallel/mesh.py).

The reference trains on several GPUs with torch.distributed DDP and apex
sync-BN (train_hybrid.py:256-261, :291-295); the JAX package runs its train
step as a shard_map over a 1-D `data` mesh, averages gradients and scalars
with pmean and syncs BatchNorm statistics with pmean. Here the mesh is the
process group: one process per device, each holding only its own samples
(the JAX package's multi-process branch), gradients averaged by
DistributedDataParallel, scalars and BatchNorm statistics by `Mesh.pmean`
(models/layers.SyncBatchNorm2d/3d).

    device = init_distributed()        # torchrun's RANK, WORLD_SIZE, ...
    mesh = create_mesh()
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from estdepth_tpu_torch.config import resolve_device
from estdepth_tpu_torch.data.pipeline import to_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device (the
    counterpart of jax.distributed.initialize).

    With `coordinator` ("host:port") the group meets at
    tcp://<coordinator> with `num_processes` ranks, this one `process_id`;
    without it at env:// (torchrun's RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). `device` None or "cuda" means the CUDA device of the
    local rank (LOCAL_RANK, else process_id modulo the visible devices),
    made current with torch.cuda.set_device; an indexed device ("cuda:0")
    is taken as given, "cpu" runs on the host. `backend` None means nccl
    for a CUDA device and gloo for the CPU."""
    dev = resolve_device(device)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kwargs = dict(init_method=f"tcp://{coordinator}",
                      world_size=num_processes, rank=process_id)
        local_rank = process_id
    else:
        kwargs = dict(init_method="env://")
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        os.environ.get("RANK", 0)))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, **kwargs)
    return dev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient is the sum of the ranks'
    cotangents (torch.distributed.nn.functional.all_reduce, which 2.13
    deprecates, computes the same)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D `data` mesh over a process group: this process's rank and
    device, and the group's size."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = ("data",)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over the group (lax.pmean over `data`): one
        all-reduce, differentiable; its gradient is the all-reduced sum of
        the ranks' cotangents over the size, as the transpose of JAX's
        pmean."""
        return _AllReduceSum.apply(x, self.group) / self.size


def create_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The data mesh over the initialized process group, one device per
    process: `device` this process's, init_distributed's result (default:
    the current CUDA device under nccl, else the CPU). `n_devices`, when
    given, must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices {n_devices}: the mesh spans the "
                         f"process group's {size} processes")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(dist.group.WORLD, dist.get_rank(), size,
                torch.device(device))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This process's shard of the batch on its device: each process holds
    only its own samples (its loader is sharded by rank), so nothing is
    scattered; numpy arrays are uploaded (data/pipeline.to_device)."""
    arrays = {k: v for k, v in batch.items()
              if not isinstance(v, torch.Tensor)}
    return {**{k: v.to(mesh.device) for k, v in batch.items()
               if isinstance(v, torch.Tensor)},
            **to_device(arrays, mesh.device)}


def replicate(model: nn.Module, mesh: Mesh,
              find_unused_parameters: bool = False,
              broadcast_buffers: bool = False) -> DistributedDataParallel:
    """`model` as a DistributedDataParallel replica on the mesh: rank 0's
    parameters and buffers are broadcast once, and every backward averages
    the gradients over the group. With synced BatchNorm the running
    statistics stay equal on every rank without `broadcast_buffers`;
    without it, pass True to copy rank 0's before each forward."""
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return DistributedDataParallel(
        model, device_ids=ids, process_group=mesh.group,
        find_unused_parameters=find_unused_parameters,
        broadcast_buffers=broadcast_buffers)


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process of the group (nothing without one)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (jax.distributed.shutdown)."""
    if dist.is_initialized():
        dist.destroy_process_group()
