"""One rank of the port's data-parallel CPU tests (no test of its own).

    PYTHONPATH=. python tests/torch_port_ddp_worker.py \
        --coordinator localhost:PORT --rank R --world 2 \
        --inputs inputs.pt --out DIR

Joins a gloo group of `--world` processes, runs the cases that
tests/test_torch_port_parallel.py holds against JAX and against the port's
one-process step, and writes `DIR/rank<R>.pt`. `inputs.pt` holds the model
weights (the JAX package's export, same names as the port's), the training
windows of each rank, and the inputs of the BatchNorm layer case. Imports
nothing of JAX.

Cases:
  * bn: one SyncBatchNorm2d layer over the group, float32 and bfloat16:
    output, running statistics and the gradients of input, weight and bias
    of sum(out * cotangent);
  * ddp: the train step on the mesh, 2 steps on this rank's windows
    (losses, grad norms, the step-1 gradients, the final state_dict on
    rank 0, and max |rank r - rank 0| of every parameter and statistic);
  * accum: 1 step of grad_accum 2 over this rank's first window twice
    (losses, BN statistics, and the gradients on rank 0);
  * remat_<policy>: the ddp case under remat (losses, BN statistics, and
    each gradient's distance from the ddp case's).
"""

from __future__ import annotations

import argparse
import os

import torch

from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.layers import (
    SyncBatchNorm2d, convert_sync_batchnorm,
)
from estdepth_tpu_torch.parallel.mesh import (
    create_mesh, init_distributed, shutdown,
)
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step

LR, WD, CLIP, DMIN, DMAX = 4e-5, 4e-4, 10.0, 0.5, 8.0


def bn_case(inputs, mesh):
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = inputs["bn_x"][mesh.rank].to(dtype).requires_grad_()
        layer = SyncBatchNorm2d(x.shape[1])
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(layer, name).copy_(inputs[f"bn_{name}"])
        layer.mesh = mesh
        layer.train()
        y = layer(x)
        (y.float() * inputs["bn_ct"][mesh.rank]).sum().backward()
        out[str(dtype)] = {"y": y.detach(), "x_grad": x.grad,
                           "weight_grad": layer.weight.grad,
                           "bias_grad": layer.bias.grad,
                           "running_mean": layer.running_mean.clone(),
                           "running_var": layer.running_var.clone()}
    return out


def train_case(inputs, mesh, windows, **step_kwargs):
    model = DepthNetHybrid(ModelConfig(
        ndepths=8, depth_min=DMIN, depth_max=DMAX, resnet=18,
        frustum_mode="plane_mix_exact_z", sequential_cost_bn=True))
    model.load_state_dict(inputs["weights"], strict=True)
    convert_sync_batchnorm(model, mesh)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(),
        warmup_multistep_schedule(LR, steps_per_epoch=10**6,
                                  warmup_steps=500), WD)
    step = make_train_step(model, optimizer, scheduler, DMIN, DMAX,
                           mesh=mesh, **step_kwargs)
    losses, norms, grads = [], [], None
    for i, batch in enumerate(windows):
        scalars = step(batch, CLIP)
        losses.append(float(scalars["loss"]))
        norms.append(float(scalars["grad_norm"]))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None}
    return model, {"losses": losses, "grad_norms": norms, "grads": grads}


def spread(model, mesh) -> float:
    """max |this rank's - rank 0's| over every parameter and buffer."""
    worst = 0.0
    for t in model.state_dict().values():
        ref = t.clone()
        torch.distributed.broadcast(ref, 0, group=mesh.group)
        worst = max(worst, float((t.double() - ref.double()).abs().max()))
    return worst


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    init_distributed(args.coordinator, args.world, args.rank, device="cpu")
    mesh = create_mesh()
    inputs = torch.load(args.inputs, weights_only=True)
    mine = [{k: v[mesh.rank] for k, v in step.items()}
            for step in inputs["steps"]]
    res = {"bn": bn_case(inputs, mesh)}

    model, res["ddp"] = train_case(inputs, mesh, mine)
    res["ddp"]["spread"] = spread(model, mesh)
    if mesh.rank == 0:
        res["ddp"]["state"] = model.state_dict()
    else:
        del res["ddp"]["grads"]

    twice = {k: torch.cat([v, v]) for k, v in mine[0].items()}
    model, res["accum"] = train_case(inputs, mesh, [twice], grad_accum=2)
    res["accum"]["stats"] = {k: v for k, v in model.state_dict().items()
                             if k.endswith(("running_mean", "running_var"))}
    if mesh.rank != 0:
        del res["accum"]["grads"]

    for policy in ("nothing", "save_features"):
        model, r = train_case(inputs, mesh, mine, remat=True,
                              remat_policy=policy)
        r["grad_dist"] = {
            k: float((g - res["ddp"]["grads"][k]).norm()
                     / res["ddp"]["grads"][k].norm().clamp(min=1e-30))
            for k, g in r.pop("grads").items()} if mesh.rank == 0 else {}
        r["stats"] = {k: v for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}
        res[f"remat_{policy}"] = r
    torch.save(res, os.path.join(args.out, f"rank{mesh.rank}.pt"))
    shutdown()


if __name__ == "__main__":
    main()
