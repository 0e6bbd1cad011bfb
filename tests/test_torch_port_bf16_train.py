"""bf16 training: the port's train step on a bf16 model against the JAX
package's shipped `make_train_step` on its bf16 model, on CPU, and the
train tool's `--bf16`.

The setup of tests/test_torch_port_train_jax.py (the same numpy-drawn
weights through the weight bridge, the same 4-frame windows, the
reference's recipe, the JAX step on a 1-device mesh with the sync-BN
axis; the cost volume's BatchNorm pooled over the window's pairs, each
package's default) with both models computing in bfloat16:
`ModelConfig(compute_dtype="bfloat16")` against
`DepthNetHybrid(dtype=jnp.bfloat16)`. Two steps; their losses agree at
rtol 1e-2, a third of the float32 trajectory tolerance (3e-3) above it:
the train-mode BatchNorm's batch statistics and every convolution round
to bf16 at other places in the two frameworks, and the loss of a bf16 step
moves with them (measured 1.9e-3 and 1.3e-3). The parameters, Adam's
moments and BatchNorm's running statistics stay float32, as flax keeps
`params` and `batch_stats`.

The step-1 parameter gradients are held tensor by tensor as in
tests/test_torch_port_train_jax.py (JAX's read back from Adam's first
moment, under the port's names), against a bound measured in the same
test: JAX's own bf16 step-1 gradient against its float32 one on the same
batch. At this size that distance is large: train-mode BatchNorm over a
handful of values per channel (4 in the PSM's pooled branches) turns
bf16 rounding into gradient noise of the order of the gradient itself
(measured per tensor: median 0.87 of the tensor's norm, 0.64 over all
parameters together). So the port's bf16 gradient is held (1) within 4x
JAX's own bf16-against-float32 distance per tensor (measured at most
2.7x, median 1.00x; a wrong term in a well-conditioned tensor, whose own
distance is a few percent, moves it by far more) and within 1.25x over
all parameters (measured 0.94x), and (2) no farther from the float32
gradient than JAX's bf16 gradient is (measured 0.40 against 0.64 over
all parameters). The well-conditioned backward of the bf16 paths (the
plane sweep's gradient on a bf16 map, the mixed-dtype train-mode
BatchNorm, the bf16 convolutions' weight gradients) is held tightly
against JAX in tests/test_torch_port_bf16.py. The JAX compiles of the
bf16 and float32 train steps take most of this file's time on one
worker.
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
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step
from estdepth_tpu_torch.utils.convert import grads_from_jax
from test_torch_port_common import (  # noqa: F401
    DMAX, DMIN, H, ND, W, model_pair, one_torch_thread, pitched_frames,
    training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
LR, WD, CLIP, B1 = 4e-5, 4e-4, 10.0, 0.9
WINDOWS = [(0, 4), (2, 6)]  # 2 targets each, distinct per step


def _batches():
    frames = pitched_frames(6)
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


def _jax_steps(jm, variables, batches):
    """The JAX package's shipped train step over `batches` on a 1-device
    mesh: (final state, losses, step-1 gradient under the port's names)."""
    mesh = create_mesh(1)
    tx = jax_make_optimizer(
        jax_sched(LR, steps_per_epoch=10**6, warmup_steps=500),
        weight_decay=WD)
    jax_step = jax_make_train_step(jm, tx, mesh, DMIN, DMAX)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))
    losses, grads = [], None
    for i, batch in enumerate(batches):
        state, scalars = jax_step(state, shard_batch(batch, mesh),
                                  jnp.float32(CLIP))
        losses.append(float(scalars["loss"]))
        if i == 0:  # Adam's first moment: (1 - b1) (g_clipped + wd p0)
            mu = jax.device_get(state.opt_state[1].mu)
            grads = grads_from_jax(jax.tree.map(
                lambda m, p0: np.asarray(m) / (1.0 - B1) - WD * p0,
                mu, variables["params"]))
    return state, losses, grads


def _distances(got, want, names):
    """Per-tensor |got - want| / |want| and the same over all `names`."""
    per = {k: float((got[k] - want[k]).norm() / want[k].norm())
           for k in names}
    err2 = sum(float((got[k] - want[k]).norm()) ** 2 for k in names)
    all2 = sum(float(want[k].norm()) ** 2 for k in names)
    return per, (err2 / all2) ** 0.5


def test_two_bf16_train_steps_match_jax():
    jm, variables, tm = model_pair(
        views=4, jax_kwargs=dict(bn_axis_name="data", dtype=jnp.bfloat16),
        compute_dtype="bfloat16")
    jm32, _, _ = model_pair(views=4, jax_kwargs=dict(bn_axis_name="data"))
    batches = list(_batches())
    state, jax_losses, jax_grads = _jax_steps(jm, variables, batches)
    _, _, jax_grads32 = _jax_steps(jm32, variables, batches[:1])

    optimizer, scheduler = make_optimizer(
        tm.named_parameters(),
        warmup_multistep_schedule(LR, steps_per_epoch=10**6,
                                  warmup_steps=500), WD)
    step = make_train_step(tm, optimizer, scheduler, DMIN, DMAX)
    losses, grads = [], None
    for i, b in enumerate(batches):
        losses.append(float(step({k: torch.from_numpy(v)
                                  for k, v in b.items()}, CLIP)["loss"]))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    # measured 1.9e-3 and 1.3e-3 apart, relative
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-2)
    assert all(np.isfinite(losses))

    # step-1 gradients, wherever the tensor's norm is above 1e-6 of the
    # global gradient norm (as the float32 test)
    assert set(jax_grads) == set(grads) == set(jax_grads32)
    global_norm = sum(float(g.norm()) ** 2 for g in jax_grads.values()) ** 0.5
    names = [k for k, g in jax_grads.items()
             if float(g.norm()) > 1e-6 * global_norm]
    assert len(names) > 150, len(names)
    assert all(g.dtype == torch.float32 for g in grads.values())
    own, own_all = _distances(jax_grads, jax_grads32, names)
    err, err_all = _distances(grads, jax_grads, names)
    for k in names:  # measured at most 2.7x, median 1.00x
        assert err[k] <= 4 * own[k], (k, err[k], own[k])
    assert err_all <= 1.25 * own_all, (err_all, own_all)  # measured 0.94x
    # the port's bf16 gradient is no worse an approximation of the float32
    # gradient than JAX's bf16 one: measured 0.40 against 0.64
    _, from_f32 = _distances(grads, jax_grads32, names)
    assert from_f32 <= own_all, (from_f32, own_all)
    for prefix in ("matchingFeature", "semanticFeature", "CostRegNet",
                   "pre0"):
        assert any(k.startswith(prefix) and float(v.norm()) > 0
                   for k, v in grads.items()), prefix

    # float32 state on both sides: parameters, Adam's two moments, and
    # BatchNorm's running statistics (which the steps moved)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    moments = [t for s in optimizer.state.values() for k, t in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * sum(1 for _ in tm.parameters())
    assert all(t.dtype == torch.float32 for t in moments)
    stats = {k: v for k, v in tm.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and all(v.dtype == torch.float32 for v in stats.values())
    assert all(leaf.dtype == jnp.float32 for leaf in
               jax.tree.leaves((state.params, state.batch_stats)))


def test_train_tool_bf16(tmp_path):
    """`tools/train.py --synthetic --bf16 --steps 2` on the CPU: finite
    losses, a bf16 model with float32 parameters and Adam state."""
    args = train_tool.parse_args([
        "--synthetic", "--bf16", "--steps", "2", "--device", "cpu",
        "--height", str(H), "--width", str(W), "--ndepths", str(ND),
        "--depth-min", str(DMIN), "--depth-max", str(DMAX), "--resnet",
        "18", "--n-frames", "4", "--logdir", str(tmp_path),
        "--summary-freq", "1", "--num-workers", "1"])
    res = train_tool.run(args)
    assert [r["step"] for r in res["records"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    model = res["state"].model
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32
               for s in res["state"].optimizer.state.values()
               for t in s.values() if t.is_floating_point())
