"""The training step (port of estdepth_tpu/train/trainer.py; reference
train_hybrid.py:155-211): forward in train mode, the multi-scale loss,
backward, staged gradient clipping (train_hybrid.py:94-97,182) and
Adam-with-L2 (torch Adam + weight_decay, train_hybrid.py:308), on one
device or data-parallel over a mesh (parallel/mesh.py: DDP averages the
gradients, one all-reduce the scalars, as the JAX step's pmeans). The warp
kernels run in the forward; their gradients are the plain versions'
(ops/cuda/build.sample_with_plain_grad).

Spans (utils/trace.py): `step` around each training step; the batch is
on the device already, so its host waits are the model's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from estdepth_tpu_torch.parallel.mesh import Mesh, replicate
from estdepth_tpu_torch.train.loss import multi_scale_loss
from estdepth_tpu_torch.utils import trace

REMAT_POLICIES = ("nothing", "save_features")


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: `step` counts the optimizer updates."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def make_optimizer(
    params: Iterable[tuple[str, nn.Parameter]],
    schedule: Callable[[int], float], weight_decay: float = 4e-4,
    betas: tuple[float, float] = (0.9, 0.999),
    frozen_prefixes: tuple[str, ...] = (),
):
    """(optimizer, scheduler) over `params` = `model.named_parameters()`.

    torch Adam(lr, betas, weight_decay) semantics: the L2 term is added to
    the gradient BEFORE the moment updates (not AdamW), eps 1e-8. The
    learning rate of update n is schedule(n - 1). `frozen_prefixes` are
    top-level subtrees that do not train, the reference's
    --fix_matchingFeature / --fix_semanticFeature (train_hybrid.py:297-306;
    here "matchingFeature", "semanticFeature"): their parameters get
    requires_grad=False, so they also stay out of the gradient norm."""
    trainable = []
    for name, p in params:
        if name.split(".")[0] in frozen_prefixes:
            p.requires_grad_(False)
        else:
            trainable.append(p)
    optimizer = torch.optim.Adam(trainable, lr=1.0, betas=betas, eps=1e-8,
                                 weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return optimizer, scheduler


def clip_by_global_norm(params: Iterable[nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale every `.grad` in place by min(1, max_norm / norm) and return
    the norm before clipping (torch clip_grad_norm_ with the clip value
    given per call)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(max_norm / norm.clamp(min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


class _TrainForward(nn.Module):
    """The train-mode depth maps of `model`: the module DDP wraps, so that
    remat's recomputation runs inside the replica's forward."""

    def __init__(self, model: nn.Module, remat: bool, remat_policy: str):
        super().__init__()
        self.model = model
        self.remat_all = remat and remat_policy == "nothing"
        self.remat_after_features = remat and remat_policy == "save_features"

    def forward(self, imgs, cam_poses, cam_intr):
        def run():
            return self.model(imgs, cam_poses, cam_intr, train=True,
                              remat_after_features=self.remat_after_features,
                              )[0]["depth"]

        if self.remat_all:
            return checkpoint(run, use_reentrant=False)
        return run()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, depth_min: float, depth_max: float,
                    loss_weight: float = 0.8, remat: bool = False,
                    grad_accum: int = 1, remat_policy: str = "nothing",
                    mesh: Mesh | None = None):
    """Returns step(batch, clip_norm) -> scalars (0-d tensors: `loss`,
    `loss_s`, `delta_s`, `thred_s`, `grad_norm`).

    batch: imgs [B, V, H, W, 3] in 0..255, cam_poses [B, V, 4, 4],
    cam_intr [B, 3, 3], dmaps and dmasks [B, T, H, W], tensors on the
    model's device.

    remat recomputes the forward during the backward
    (torch.utils.checkpoint, non-reentrant) and so launches each forward
    kernel twice per step: policy "nothing" keeps no activation of the
    forward, "save_features" keeps the two encoders' outputs and
    recomputes the cost volumes and the decoder. BatchNorm's running
    statistics are put back after the backward, so a recomputed forward
    does not update them a second time; synced BatchNorm's all-reduces
    run again inside the backward, in the same order on every rank. The
    JAX trainer's "dots" policy (keep matmul and conv outputs) has no
    counterpart here.

    grad_accum splits the batch into that many microbatches, sums their
    gradients, divides by the count and averages the scalars; BatchNorm's
    batch statistics and running-stat updates are per microbatch, as if
    the microbatches were separate steps.

    With a `mesh` each process steps on its own shard of the batch: the
    model is wrapped in a DDP replica at the first step (rank 0's weights
    broadcast), whose backward averages the gradients over the group
    (under grad_accum, on the last microbatch only: the others run under
    `no_sync`); the scalars are averaged by one all-reduce, and clipping
    follows both, as in the JAX step. Synced BatchNorm
    (models/layers.convert_sync_batchnorm) keeps the running statistics
    equal on every rank; with plain BatchNorm the replica copies rank 0's
    before each forward. DDP is told to look for unused parameters only
    where the loss does not reach every parameter
    (DepthNetHybrid.trains_every_parameter: no EST fusion, or a window of
    one target)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}: one of "
                         f"{REMAT_POLICIES} (the JAX trainer's 'dots' is "
                         f"not ported)")
    params = [p for p in model.parameters() if p.requires_grad]
    net = _TrainForward(model, remat, remat_policy)
    replica = None

    def replica_for(views: int) -> nn.Module:
        nonlocal replica
        if replica is None:  # the window length is known at the first step
            replica = replicate(
                net, mesh,
                find_unused_parameters=not model.trains_every_parameter(
                    views),
                broadcast_buffers=not any(getattr(m, "mesh", None) is mesh
                                          for m in model.modules()))
        return replica

    @torch.enable_grad()  # whatever grad mode the caller is in
    def accumulate(mb, sync: bool):
        if mesh is None:
            run, context = net, contextlib.nullcontext()
        else:
            run = replica_for(mb["imgs"].shape[1])
            context = contextlib.nullcontext() if sync else run.no_sync()
        with context:
            loss, scalars = multi_scale_loss(
                run(mb["imgs"], mb["cam_poses"], mb["cam_intr"]),
                mb["dmaps"], mb["dmasks"], depth_min, depth_max,
                weight=loss_weight)
            if remat:
                buffers = [b.clone() for b in model.buffers()]
            (loss / grad_accum).backward()
        if remat:
            with torch.no_grad():
                for b, kept in zip(model.buffers(), buffers):
                    b.copy_(kept)
        return scalars

    @trace.spanned("step")
    def step(batch, clip_norm: float):
        optimizer.zero_grad(set_to_none=True)
        n = batch["imgs"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum "
                             f"{grad_accum}")
        size = n // grad_accum
        runs = [accumulate({k: v[i * size:(i + 1) * size]
                            for k, v in batch.items()},
                           sync=i == grad_accum - 1)
                for i in range(grad_accum)]
        scalars = (runs[0] if grad_accum == 1 else
                   {k: torch.stack([r[k] for r in runs]).mean()
                    for k in runs[0]})
        if mesh is not None:  # one all-reduce of the stacked scalars
            names = list(scalars)
            scalars = dict(zip(names, mesh.pmean(
                torch.stack([scalars[k] for k in names])).unbind()))
        scalars["grad_norm"] = clip_by_global_norm(params, clip_norm)
        optimizer.step()
        scheduler.step()
        return scalars

    return step
