#!/usr/bin/env python3
"""How well conditioned the tiny SENet model's training gradient is, on CPU.

    python scripts/senet_grad_conditioning.py

The case of tests/test_torch_port_senet.py::test_senet_train_step_matches_jax
(the tiny configuration with `feature_net="senet"`, weights drawn with
numpy from seed 0, one 4-frame window of the pitched stream, the
reference's recipe): JAX's shipped make_train_step on a 1-device mesh,
the port's step in float32, and the port's gradient in float64. The
float64 run is the port's model with its float32 pins widened (the pixel
grid, the depth candidates, GroupNorm's float32 compute), set up here by
patching; it is a yardstick, not a mode of the port. Prints each float32
gradient's relative distance from the float64 one, and the two float32
gradients' distance from each other: per tensor (the largest 15, then the
median and the largest), and over all parameters together. Needs JAX (the
JAX package's CPU test environment) and takes about a minute.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from estdepth_tpu.parallel.mesh import create_mesh, shard_batch  # noqa: E402
from estdepth_tpu.train.schedule import (  # noqa: E402
    warmup_multistep_schedule as jax_sched,
)
from estdepth_tpu.train.trainer import (  # noqa: E402
    TrainState, make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from estdepth_tpu_torch import config as tconfig  # noqa: E402
from estdepth_tpu_torch.config import ModelConfig  # noqa: E402
from estdepth_tpu_torch.models import layers  # noqa: E402
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid  # noqa: E402
from estdepth_tpu_torch.ops import geometry  # noqa: E402
from estdepth_tpu_torch.train.schedule import (  # noqa: E402
    warmup_multistep_schedule,
)
from estdepth_tpu_torch.train.trainer import (  # noqa: E402
    make_optimizer, make_train_step,
)
from estdepth_tpu_torch.utils.convert import grads_from_jax  # noqa: E402
from test_torch_port_common import (  # noqa: E402
    DMAX, DMIN, ND, model_pair, pitched_frames,
)

LR, WD, CLIP, B1 = 4e-5, 4e-4, 10.0, 0.9
SENET = dict(feature_net="senet")


def _batch() -> dict:
    frames = pitched_frames(4)
    return {
        "imgs": np.stack([f["img"] for f in frames])[None].astype(
            np.float32),
        "cam_poses": np.stack([f["cam_pose"] for f in frames])[None],
        "cam_intr": frames[0]["cam_intr"][None].astype(np.float32),
        "dmaps": np.stack([f["dmap"] for f in frames[1:3]])[None].astype(
            np.float32),
        "dmasks": np.stack([f["dmask"] for f in frames[1:3]])[None]}


def _jax_grads(jm, variables, batch) -> dict:
    """JAX's clipped step-1 gradient, from Adam's first moment."""
    mesh = create_mesh(1)
    tx = jax_make_optimizer(
        jax_sched(LR, steps_per_epoch=10**6, warmup_steps=500),
        weight_decay=WD)
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))
    state, _ = jax_make_train_step(jm, tx, mesh, DMIN, DMAX)(
        state, shard_batch(batch, mesh), jnp.float32(CLIP))
    mu = jax.device_get(state.opt_state[1].mu)
    return {k: v.double() for k, v in grads_from_jax(jax.tree.map(
        lambda m, p0: np.asarray(m) / (1.0 - B1) - WD * p0, mu,
        variables["params"])).items()}


def _port_grads(model, batch, dtype) -> dict:
    opt, sched = make_optimizer(
        model.named_parameters(),
        warmup_multistep_schedule(LR, steps_per_epoch=10**6,
                                  warmup_steps=500), WD)
    step = make_train_step(model, opt, sched, DMIN, DMAX)
    step({k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in batch.items()}, CLIP)
    return {k: p.grad.double() for k, p in model.named_parameters()}


def _float64_model(state_dict) -> DepthNetHybrid:
    """The port's model computing in float64: its float32 pins widened."""
    tconfig.COMPUTE_DTYPES["float64"] = torch.float64
    grid, arange = geometry.pixel_grid, torch.arange
    geometry.pixel_grid = lambda h, w, device=None, dtype=None: grid(
        h, w, device=device, dtype=torch.float64)
    torch.arange = lambda *a, **k: arange(*a, **(
        {**k, "dtype": torch.float64} if k.get("dtype") == torch.float32
        else k))
    layers.GroupNorm.forward = lambda self, x: nn.GroupNorm.forward(self, x)
    model = DepthNetHybrid(ModelConfig(
        ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
        frustum_mode="plane_mix_exact_z", sequential_cost_bn=True,
        compute_dtype="float64", **SENET))
    model.load_state_dict(state_dict, strict=True)
    return model.double()


def main() -> None:
    torch.set_num_threads(1)
    jm, variables, tm = model_pair(
        views=4, jax_kwargs=dict(sequential_cost_bn=True,
                                 bn_axis_name="data", **SENET),
        sequential_cost_bn=True, **SENET)
    batch = _batch()
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    jax32 = _jax_grads(jm, variables, batch)
    port32 = _port_grads(tm, batch, torch.float32)
    # last: the patches of _float64_model stay for the rest of the process
    port64 = _port_grads(_float64_model(state), batch, torch.float64)
    total = sum(float(g.norm()) ** 2 for g in port64.values()) ** 0.5
    names = [k for k, g in port64.items() if float(g.norm()) > 1e-6 * total]
    pairs = {"port32-port64": (port32, port64),
             "jax32-port64": (jax32, port64),
             "port32-jax32": (port32, jax32)}
    rel = {p: np.array([float((a[k] - b[k]).norm()) / float(b[k].norm())
                        for k in names]) for p, (a, b) in pairs.items()}
    order = np.argsort(-np.max(np.stack(list(rel.values())), 0))
    for i in order[:15]:
        print(f"{names[i]:<58}" + "  ".join(
            f"{p} {rel[p][i]:.2e}" for p in pairs))
    for p, (a, b) in pairs.items():
        over = (sum(float((a[k] - b[k]).norm()) ** 2 for k in names)
                / sum(float(b[k].norm()) ** 2 for k in names)) ** 0.5
        print(f"{p}: median {np.median(rel[p]):.2e}, max "
              f"{rel[p].max():.2e}, over all {over:.2e} ({len(names)} "
              f"tensors)")


if __name__ == "__main__":
    main()
