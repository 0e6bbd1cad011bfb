"""The training slice as a whole: the port's train step against the JAX
package's `make_train_step` on CPU.

Same weights (numpy from a seed, through the weight bridge), the same three
distinct batches, the reference's recipe on both sides (Adam 4e-5 with L2
4e-4, the warm-up schedule, clip 10, `sequential_cost_bn=True`), warp route
`plane_mix_exact_z` (JAX: `fast_frustum` + `exact_z_warp`, the XLA forms;
the port on CPU tensors: the plain versions of kernels 1 and 2 with the
wrappers' gradient rules). The JAX step runs as shipped: shard_map over a
1-device mesh with the sync-BN axis. One JAX compile in this file.

Held, with the trajectory tolerances of PARITY.md as
tests/test_reference_parity.py applies them: the loss of each of 3 steps at
rtol 3e-3; every BatchNorm running mean and variance after the 3 steps at
rtol 5e-3 (atol 5e-4 for means near zero); and the step-1 parameter
gradients, tensor by tensor under the port's names (`grads_from_jax`),
wherever the tensor's norm is above 1e-6 of the global gradient norm.

The gradient tolerance is 2e-2 per tensor and 1e-2 over all parameters
together, not float rounding, and the reason is measured: with train-mode
BatchNorm over a handful of values (the tiny model's pooled branches see 4
values per channel) the float32 gradient is ill-conditioned. Against a
float64 run of the same port model, the port's own float32 gradient lies
2e-3 away (median per tensor; 9e-3 at most) with 1 or 4 threads and 1e-5
with 8: the summation order alone moves it that far. Against JAX it lies
7e-3 away (median; 1.5e-2 at most; 5.8e-3 over all parameters together),
while the losses of the 3 steps agree to 6e-5 and the gradient norms to
1.5e-3. A wrong backward (a missing term, a wrong BatchNorm mode, a
gradient through the coordinates) moves whole subtrees by tens of percent.

The JAX step returns no gradients. They are read back from Adam's first
moment after step 1, which then holds (1 - b1) * (clipped gradient +
wd * parameter); the port's `.grad` after its step is the clipped gradient.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.parallel.mesh import create_mesh, shard_batch
from estdepth_tpu.train.schedule import warmup_multistep_schedule as jax_sched
from estdepth_tpu.train.trainer import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step
from estdepth_tpu_torch.utils.convert import (
    grads_from_jax, state_dict_from_jax,
)
from test_torch_port_common import (
    DMAX, DMIN, model_pair, one_torch_thread, pitched_frames,
    training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
LR, WD, CLIP, B1 = 4e-5, 4e-4, 10.0, 0.9
WINDOWS = [(0, 4), (2, 6), (3, 7)]  # 2 targets each, distinct per step


def _batches():
    frames = pitched_frames(7)
    for lo, hi in WINDOWS:
        yield {
            "imgs": np.stack([f["img"] for f in frames[lo:hi]])[None].astype(
                np.float32),
            "cam_poses": np.stack([f["cam_pose"] for f in frames[lo:hi]])[
                None].astype(np.float32),
            "cam_intr": frames[0]["cam_intr"][None].astype(np.float32),
            "dmaps": np.stack([f["dmap"] for f in frames[lo + 1:hi - 1]])[
                None].astype(np.float32),
            "dmasks": np.stack([f["dmask"] for f in frames[lo + 1:hi - 1]])[
                None],
        }


def test_three_train_steps_match_jax():
    jm, variables, tm = model_pair(
        views=4, jax_kwargs=dict(sequential_cost_bn=True,
                                 bn_axis_name="data"),
        sequential_cost_bn=True)
    batches = list(_batches())

    # ---- JAX: the shipped step on a 1-device mesh -------------------------
    mesh = create_mesh(1)
    tx = jax_make_optimizer(
        jax_sched(LR, steps_per_epoch=10**6, warmup_steps=500),
        weight_decay=WD)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))
    jax_step = jax_make_train_step(jm, tx, mesh, DMIN, DMAX)
    jax_losses, jax_norms, jax_grads = [], [], None
    for i, batch in enumerate(batches):
        state, scalars = jax_step(state, shard_batch(batch, mesh),
                                  jnp.float32(CLIP))
        jax_losses.append(float(scalars["loss"]))
        jax_norms.append(float(scalars["grad_norm"]))
        if i == 0:  # Adam's first moment: (1 - b1) (g_clipped + wd p0)
            mu = jax.device_get(state.opt_state[1].mu)
            jax_grads = jax.tree.map(
                lambda m, p0: np.asarray(m) / (1.0 - B1) - WD * p0,
                mu, variables["params"])

    # ---- the port ---------------------------------------------------------
    optimizer, scheduler = make_optimizer(
        tm.named_parameters(),
        warmup_multistep_schedule(LR, steps_per_epoch=10**6,
                                  warmup_steps=500), WD)
    step = make_train_step(tm, optimizer, scheduler, DMIN, DMAX)
    losses, norms, grads = [], [], None
    for i, batch in enumerate(batches):
        scalars = step({k: torch.from_numpy(v) for k, v in batch.items()},
                       CLIP)
        losses.append(float(scalars["loss"]))
        norms.append(float(scalars["grad_norm"]))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    assert not tm.training  # the step leaves the model in eval mode

    # ---- per-step losses and gradient norms -------------------------------
    np.testing.assert_allclose(losses, jax_losses, rtol=3e-3)
    np.testing.assert_allclose(norms, jax_norms, rtol=1e-2)  # measured 1.5e-3

    # ---- BatchNorm running statistics after 3 momentum-0.1 updates --------
    want_sd = state_dict_from_jax({
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats)})
    got_sd = tm.state_dict()
    init_sd = state_dict_from_jax(variables)
    n_stats = 0
    for name, want in want_sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                got_sd[name].numpy(), want.numpy(), rtol=5e-3, atol=5e-4,
                err_msg=f"BN running stat {name}")
            # and it moved: the step really ran BatchNorm in train mode
            n_stats += int(not np.allclose(want.numpy(),
                                           init_sd[name].numpy(), rtol=1e-3))
    assert n_stats > 100, n_stats

    # ---- step-1 parameter gradients under the port's names ----------------
    want_grads = grads_from_jax(jax_grads)
    assert set(want_grads) == set(grads)
    scale = min(1.0, CLIP / jax_norms[0])
    global_norm = jax_norms[0] * scale
    checked, err2, all2 = 0, 0.0, 0.0
    for name, want in want_grads.items():
        norm = float(want.norm())
        if norm <= 1e-6 * global_norm:
            continue
        diff = float((grads[name] - want).norm())
        assert diff < 2e-2 * norm, (name, diff / norm, norm)
        err2, all2 = err2 + diff ** 2, all2 + norm ** 2
        checked += 1
    assert checked > 150, checked
    assert (err2 / all2) ** 0.5 < 1e-2, (err2 / all2) ** 0.5
    for prefix in ("matchingFeature", "semanticFeature", "CostRegNet",
                   "pre0"):
        assert any(k.startswith(prefix) and float(v.norm()) > 0
                   for k, v in grads.items()), prefix
