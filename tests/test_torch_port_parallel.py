"""Data parallelism of the port (parallel/mesh.py, the synced BatchNorm of
models/layers.py, the trainer's mesh, the train tool's --multihost) on 2
gloo processes on the CPU, against the JAX package's shard_map step on a
2-device mesh of the conftest's CPU devices.

The ranks run in tests/torch_port_ddp_worker.py (one module-scoped launch
of 2 processes, started before the JAX step compiles so the two overlap),
at the tiny size of tests/test_torch_port_train_jax.py: ResNet-18, 64x96,
8 planes, 4-frame windows (2 targets), sequential cost BN, the
reference's Adam recipe. The weights come from the JAX variables through
the JAX package's own export (estdepth_tpu/utils/convert.export_state_dict).
Each step feeds rank r the r-th of two distinct windows; JAX takes both as
its global batch of 2, one per device.

Held, with the trajectory tolerances of PARITY.md (losses rtol 3e-3, BN
statistics rtol 5e-3) and the gradient tolerance of
tests/test_torch_port_train_jax.py (2e-2 per tensor, 1e-2 over all; the
tiny model's float32 gradient is ill-conditioned, measured there):
  * one synced BatchNorm layer over 2 ranks against JAX's
    TorchBatchNorm(axis_name="data") in shard_map (atol 1e-5; bf16 within
    2x JAX's own bf16-to-float32 distance, the port's bf16 rule), and at world size
    1 against nn.BatchNorm (1e-6);
  * 2 train steps on 2 ranks against JAX's make_train_step on
    create_mesh(2), and against the port's one-process step on the batch of
    both windows, the function sync-BN makes the ranks compute;
  * grad_accum 2 over a duplicated window on each rank against JAX's plain
    step (tests/test_train_step.py:73's case), remat against no remat;
  * tools/train.py --multihost in 2 processes, as tests/test_multihost.py
    runs the JAX tool: equal losses, rank 0 alone writes, --resume, the
    checkpoint into a one-device model, torchrun's environment.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch import nn

from estdepth_tpu.models.layers import TorchBatchNorm
from estdepth_tpu.parallel.mesh import create_mesh as jax_create_mesh
from estdepth_tpu.parallel.mesh import shard_batch as jax_shard_batch
from estdepth_tpu.train.schedule import warmup_multistep_schedule as jax_sched
from estdepth_tpu.train.trainer import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from estdepth_tpu.utils.convert import export_state_dict
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.layers import (
    SyncBatchNorm2d, SyncBatchNorm3d, convert_sync_batchnorm,
)
from estdepth_tpu_torch.parallel import mesh as port_mesh
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step
from estdepth_tpu_torch.utils.convert import grads_from_jax
from test_torch_port_common import (  # noqa: F401
    DMAX, DMIN, H, ND, W, model_pair, one_torch_thread, pitched_frames,
    training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD, CLIP, B1 = 4e-5, 4e-4, 10.0, 0.9
# per step, the windows of rank 0 and rank 1 (4 frames: 2 targets)
STEP_WINDOWS = [((0, 4), (2, 6)), ((3, 7), (1, 5))]
BN_SHAPE = (2, 6, 5, 7)  # per rank: N, C, H, W
RANK_TIMEOUT = 300  # seconds, per process
TOOL_SIZE = ["--device", "cpu", "--synthetic", "--height", str(H),
             "--width", str(W), "--ndepths", str(ND), "--resnet", "18",
             "--n-frames", "3", "--batch-per-device", "1",
             "--num-workers", "1", "--summary-freq", "1"]


def _window(frames, lo, hi):
    return {
        "imgs": np.stack([f["img"] for f in frames[lo:hi]])[None],
        "cam_poses": np.stack([f["cam_pose"] for f in frames[lo:hi]])[None],
        "cam_intr": frames[0]["cam_intr"][None],
        "dmaps": np.stack([f["dmap"] for f in frames[lo + 1:hi - 1]])[None],
        "dmasks": np.stack([f["dmask"] for f in frames[lo + 1:hi - 1]])[None],
    }


def _steps():
    """Per step {name: [2 ranks, 1, ...]} as float32 / bool arrays."""
    frames = pitched_frames(7)
    out = []
    for pair in STEP_WINDOWS:
        ws = [_window(frames, lo, hi) for lo, hi in pair]
        out.append({k: np.stack([w[k] for w in ws]).astype(
            bool if k == "dmasks" else np.float32) for k in ws[0]})
    return out


def _global(step):
    """A step's two rank windows as one batch of 2."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in step.items()}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def no_tensorflow(tmp_path_factory):
    """A directory whose `tensorflow` fails to import. Put first on a
    subprocess's path, it keeps TensorBoard's writer (the train tool's
    ScalarLogger mirror) on its own stub: importing TensorFlow costs rank 0
    16 s before its first step, which every rank waits for."""
    root = tmp_path_factory.mktemp("no_tensorflow")
    (root / "tensorflow").mkdir()
    (root / "tensorflow" / "__init__.py").write_text(
        'raise ImportError("tensorflow is hidden from this process")\n')
    return str(root)


def _env(path=(), **extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([*path, REPO]),
               OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _start(argvs, envs):
    return [subprocess.Popen(argv, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env,
                             cwd=REPO) for argv, env in zip(argvs, envs)]


def _finish(procs):
    """Each process's output after it exits (RANK_TIMEOUT each); every
    process is killed if one fails or hangs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    return outs


def _tool(no_tf, logdirs, *flags, torchrun=False):
    """tools/train.py in 2 processes (one logdir each, or one shared)."""
    port = _free_port()
    argvs, envs = [], []
    for rank, logdir in enumerate(logdirs):
        argv = [sys.executable, "-m", "estdepth_tpu_torch.tools.train",
                "--multihost", *TOOL_SIZE, "--logdir", str(logdir), *flags]
        if torchrun:
            env = _env([no_tf], RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        else:
            argv += ["--coordinator", f"localhost:{port}",
                     "--num-processes", "2", "--process-id", str(rank)]
            env = _env([no_tf])
        argvs.append(argv)
        envs.append(env)
    return _finish(_start(argvs, envs))


def _losses(out):
    return [float(v) for v in re.findall(r"step \d+ loss ([0-9.]+)", out)]


def _jax_state(variables, tx):
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))


def _jax_bn(x, ct, params, stats, dtype):
    """JAX TorchBatchNorm(axis_name="data") over a 2-device mesh on x
    [2 ranks, N, H, W, C]: (outputs, stats, input grads, per-rank scale and
    bias grads) of sum(out * ct) on each device."""
    bn = TorchBatchNorm(use_running_average=False, axis_name="data",
                        dtype=dtype)

    def local(x, ct, params, stats):
        def f(x, params):
            y, upd = bn.apply({"params": params, "batch_stats": stats},
                              x[0], mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * ct[0]), (y, upd)

        (_, (y, upd)), (gx, gp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(x, params)
        return (y[None], upd["batch_stats"], gx,
                jax.tree.map(lambda g: g[None], gp))

    fn = jax.jit(jax.shard_map(
        local, mesh=jax_create_mesh(2),
        in_specs=(P("data"), P("data"), P(), P()),
        out_specs=(P("data"), P(), P("data"), P("data")), check_vma=False))
    return jax.device_get(fn(x, ct, params, stats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2 ranks' results, JAX's 2-device steps, and what both started
    from."""
    tmp = tmp_path_factory.mktemp("ddp")
    jm, variables, _ = model_pair(
        views=4, jax_kwargs=dict(sequential_cost_bn=True,
                                 bn_axis_name="data"),
        sequential_cost_bn=True)
    weights = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in export_state_dict(variables).items()}
    steps = _steps()
    rng = np.random.default_rng(3)
    c = BN_SHAPE[1]
    bn = {"bn_x": 1.5 * rng.normal(size=(2, *BN_SHAPE)) + 0.4,
          "bn_ct": rng.normal(size=(2, *BN_SHAPE)),
          "bn_weight": rng.uniform(0.5, 1.5, c),
          "bn_bias": 0.1 * rng.normal(size=c),
          "bn_running_mean": 0.1 * rng.normal(size=c),
          "bn_running_var": rng.uniform(0.5, 1.5, c)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    torch.save({"weights": weights,
                "steps": [{k: torch.from_numpy(v) for k, v in s.items()}
                          for s in steps],
                **{k: torch.from_numpy(v) for k, v in bn.items()}},
               tmp / "inputs.pt")
    port = _free_port()
    procs = _start(
        [[sys.executable, os.path.join(REPO, "tests",
                                       "torch_port_ddp_worker.py"),
          "--coordinator", f"localhost:{port}", "--rank", str(r),
          "--world", "2", "--inputs", str(tmp / "inputs.pt"),
          "--out", str(tmp)] for r in range(2)], [_env(), _env()])
    try:
        # ---- JAX, while the ranks run: the shipped step on 2 devices ----
        mesh = jax_create_mesh(2)
        tx = jax_make_optimizer(
            jax_sched(LR, steps_per_epoch=10**6, warmup_steps=500),
            weight_decay=WD)
        jax_step = jax_make_train_step(jm, tx, mesh, DMIN, DMAX)
        state = _jax_state(variables, tx)
        jax_losses, jax_norms, jax_stats1 = [], [], None
        for i, s in enumerate(steps):
            state, scalars = jax_step(state, jax_shard_batch(_global(s), mesh),
                                      jnp.float32(CLIP))
            jax_losses.append(float(scalars["loss"]))
            jax_norms.append(float(scalars["grad_norm"]))
            if i == 0:
                mu = jax.device_get(state.opt_state[1].mu)
                jax_grads = grads_from_jax(jax.tree.map(
                    lambda m, p0: np.asarray(m) / (1.0 - B1) - WD * p0,
                    mu, variables["params"]))
                jax_stats1 = jax.device_get(state.batch_stats)
        jax_state = export_state_dict({
            "params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)})
        jax_stats1 = export_state_dict({"params": variables["params"],
                                        "batch_stats": jax_stats1})
        # ---- JAX's synced BatchNorm layer -------------------------------
        x = np.transpose(bn["bn_x"], (0, 1, 3, 4, 2))
        ct = np.transpose(bn["bn_ct"], (0, 1, 3, 4, 2))
        params = {"scale": bn["bn_weight"], "bias": bn["bn_bias"]}
        stats = {"mean": bn["bn_running_mean"], "var": bn["bn_running_var"]}
        jax_bn = {"float32": _jax_bn(x, ct, params, stats, None)}
        xb = jnp.asarray(x, jnp.bfloat16)
        jax_bn["bfloat16"] = _jax_bn(xb, ct, params, stats, jnp.bfloat16)
        jax_bn["float32_of_bf16_input"] = _jax_bn(
            np.asarray(xb, np.float32), ct, params, stats, None)
    finally:
        outs = _finish(procs)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    return dict(ranks=ranks, outs=outs, weights=weights, steps=steps,
                jax_losses=jax_losses, jax_norms=jax_norms,
                jax_grads=jax_grads, jax_state=jax_state,
                jax_stats1=jax_stats1, jax_bn=jax_bn,
                init_state=export_state_dict(variables), **bn)


def _nchw(a):
    """JAX [2, N, H, W, C] per-rank arrays as torch's [2, N, C, H, W]."""
    return np.transpose(np.asarray(a, np.float32), (0, 1, 4, 2, 3))


def _port_bn(ranks, dtype):
    r0, r1 = (r["bn"][dtype] for r in ranks)
    for name in ("running_mean", "running_var"):  # synced: equal
        assert torch.equal(r0[name], r1[name]), name
    return {"y": np.stack([r0["y"].float(), r1["y"].float()]),
            "x_grad": np.stack([r0["x_grad"].float(), r1["x_grad"].float()]),
            "weight_grad": np.stack([r0["weight_grad"], r1["weight_grad"]]),
            "bias_grad": np.stack([r0["bias_grad"], r1["bias_grad"]]),
            "running_mean": r0["running_mean"].numpy(),
            "running_var": r0["running_var"].numpy()}


def _jax_bn_values(res):
    y, stats, gx, gp = res
    return {"y": _nchw(y), "x_grad": _nchw(gx),
            "weight_grad": np.asarray(gp["scale"]),
            "bias_grad": np.asarray(gp["bias"]),
            "running_mean": np.asarray(stats["mean"]),
            "running_var": np.asarray(stats["var"])}


def test_sync_bn_matches_jax_over_two_ranks(runs):
    got = _port_bn(runs["ranks"], "torch.float32")
    want = _jax_bn_values(runs["jax_bn"]["float32"])
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)
    # the statistics are both ranks': rank 0's batch alone gives others
    x, m0 = runs["bn_x"], runs["bn_running_mean"]
    assert np.allclose(got["running_mean"],
                       0.9 * m0 + 0.1 * x.mean((0, 1, 3, 4)), atol=1e-6)
    assert not np.allclose(got["running_mean"],
                           0.9 * m0 + 0.1 * x[0].mean((0, 2, 3)), atol=1e-3)


def test_sync_bn_bf16_within_jax_bf16_distance(runs):
    """The port's bf16 rule: its bf16 layer lies within 2x of JAX's own bf16
    layer's distance from JAX float32 on the same (bf16-rounded) input."""
    got = _port_bn(runs["ranks"], "torch.bfloat16")
    jb = _jax_bn_values(runs["jax_bn"]["bfloat16"])
    jf = _jax_bn_values(runs["jax_bn"]["float32_of_bf16_input"])
    for name in ("y", "x_grad", "weight_grad", "bias_grad", "running_mean",
                 "running_var"):
        own = np.abs(jb[name] - jf[name]).max()
        err = np.abs(got[name] - jb[name]).max()
        assert err <= 2 * own + 1e-6, (name, err, own)


@pytest.mark.parametrize("dims", [2, 3])
def test_sync_bn_at_world_size_one_is_batchnorm(dims):
    """Without a mesh the synced layer computes nn.BatchNorm's train-mode
    function (mean and mean of squares instead of a two-pass variance):
    output, running statistics and gradients within 1e-6 of each tensor's
    largest value (a bias gradient of 0.03 sums 144 terms of order 1 and
    lies 2e-6 from nn.BatchNorm's, which sums in another order)."""
    gen = torch.Generator().manual_seed(dims)
    shape = (3, 5, 4, 6) if dims == 2 else (2, 5, 3, 4, 6)
    x = torch.randn(shape, generator=gen) * 1.3 + 0.2
    ct = torch.randn(shape, generator=gen)
    ref = (nn.BatchNorm2d if dims == 2 else nn.BatchNorm3d)(5)
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5, generator=gen)
        ref.bias.normal_(generator=gen)
        ref.running_var.uniform_(0.5, 1.5, generator=gen)
    ref.train()
    layer = convert_sync_batchnorm(nn.Sequential(
        (nn.BatchNorm2d if dims == 2 else nn.BatchNorm3d)(5)))[0]
    assert type(layer) is (SyncBatchNorm2d if dims == 2 else SyncBatchNorm3d)
    layer.load_state_dict(ref.state_dict())
    layer.train()
    outs = []
    for m in (ref, layer):
        xi = x.clone().requires_grad_()
        y = m(xi)
        (y * ct).sum().backward()
        outs.append([y, xi.grad, m.weight.grad, m.bias.grad,
                     m.running_mean, m.running_var])
    for name, a, b in zip(("y", "x_grad", "weight_grad", "bias_grad",
                           "running_mean", "running_var"), *outs):
        err = float((b - a).detach().abs().max())
        assert err <= 1e-6 * float(a.detach().abs().max()), (name, err)
    assert int(layer.num_batches_tracked) == 1
    layer.eval()  # eval: nn.BatchNorm's, on the running statistics
    ref.eval()
    torch.testing.assert_close(layer(x), ref(x), rtol=0, atol=0)


def test_convert_sync_batchnorm_keeps_names_and_tensors():
    model = DepthNetHybrid(ModelConfig(ndepths=4, resnet=18))
    before = model.state_dict()
    params = dict(model.named_parameters())
    convert_sync_batchnorm(model)
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(after[k] is before[k] or torch.equal(after[k], before[k])
               for k in before)
    assert all(p is params[k] for k, p in model.named_parameters())
    bns = [m for m in model.modules()
           if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d))]
    assert bns and all(isinstance(m, (SyncBatchNorm2d, SyncBatchNorm3d))
                       for m in bns)
    assert not model.training and not any(m.training for m in bns)


def _check_grads(got, want, norm):
    """Per tensor within 2e-2 of JAX's where its norm is above 1e-6 of the
    global norm, and within 1e-2 over all of them together."""
    checked, err2, all2 = 0, 0.0, 0.0
    for name, w in want.items():
        n = float(w.norm())
        if n <= 1e-6 * norm:
            continue
        diff = float((got[name] - w).norm())
        assert diff < 2e-2 * n, (name, diff / n, n)
        err2, all2 = err2 + diff ** 2, all2 + n ** 2
        checked += 1
    assert checked > 150, checked
    assert (err2 / all2) ** 0.5 < 1e-2, (err2 / all2) ** 0.5


def test_two_rank_steps_match_jax(runs):
    r0, r1 = runs["ranks"]
    # the ranks agree on every scalar and end with equal weights
    assert r0["ddp"]["losses"] == r1["ddp"]["losses"]
    assert r0["ddp"]["grad_norms"] == r1["ddp"]["grad_norms"]
    assert r1["ddp"]["spread"] == 0.0, r1["ddp"]["spread"]
    np.testing.assert_allclose(r0["ddp"]["losses"], runs["jax_losses"],
                               rtol=3e-3)
    np.testing.assert_allclose(r0["ddp"]["grad_norms"], runs["jax_norms"],
                               rtol=1e-2)
    state, moved = r0["ddp"]["state"], 0
    for name, want in runs["jax_state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[name].numpy(), want, rtol=5e-3,
                                       atol=5e-4, err_msg=name)
            moved += int(not np.allclose(want, runs["init_state"][name],
                                         rtol=1e-3))
    assert moved > 100, moved
    scale = min(1.0, CLIP / runs["jax_norms"][0])
    _check_grads(r0["ddp"]["grads"], runs["jax_grads"],
                 runs["jax_norms"][0] * scale)


def test_two_ranks_compute_the_step_on_both_windows(runs):
    """The port's one-process step on the batch of both windows (plain
    BatchNorm over the 2 windows) is the function sync-BN and DDP make the
    two ranks compute: the losses, the step-1 gradients and the parameters
    after 2 updates."""
    model = DepthNetHybrid(ModelConfig(
        ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
        sequential_cost_bn=True))
    model.load_state_dict(runs["weights"], strict=True)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(),
        warmup_multistep_schedule(LR, steps_per_epoch=10**6,
                                  warmup_steps=500), WD)
    step = make_train_step(model, optimizer, scheduler, DMIN, DMAX)
    losses, norms = [], []
    for i, s in enumerate(runs["steps"]):
        scalars = step({k: torch.from_numpy(v) for k, v in _global(s).items()},
                       CLIP)
        losses.append(float(scalars["loss"]))
        norms.append(float(scalars["grad_norm"]))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    r0 = runs["ranks"][0]["ddp"]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norms"], norms, rtol=1e-2)
    _check_grads(r0["grads"], grads, norms[0] * min(1.0, CLIP / norms[0]))
    # the parameters' updates: Adam's first ones normalize each element's
    # gradient by its own size, so an element whose gradient is at the
    # float noise bounded above can move either way by up to 2 lr; measured
    # 4.2% over all the updates, at most 3.1% of a tensor's elements off by
    # more than 0.1 lr (the median tensor: none)
    final, err2, all2, share = model.state_dict(), 0.0, 0.0, []
    for k, p in model.named_parameters():
        want = final[k] - runs["weights"][k]
        diff = r0["state"][k] - final[k]
        err2 += float(diff.square().sum())
        all2 += float(want.square().sum())
        share.append(float((diff.abs() > 0.1 * LR).float().mean()))
    assert (err2 / all2) ** 0.5 < 0.1, (err2 / all2) ** 0.5
    assert max(share) < 0.1, max(share)


def _bn_calls_per_forward(weights, window) -> dict:
    """How many times a train-mode forward of `window` calls each
    BatchNorm (sequential cost BN: the pre-stack once per (target,
    neighbour) pair, stereo_head1 once per target), by state_dict prefix."""
    model = DepthNetHybrid(ModelConfig(
        ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
        sequential_cost_bn=True))
    model.load_state_dict(weights, strict=True)
    calls = {}
    for name, m in model.named_modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            calls[name] = 0
            m.register_forward_hook(
                lambda m, i, o, name=name: calls.__setitem__(
                    name, calls[name] + 1))
    b = {k: torch.from_numpy(v) for k, v in window.items()}
    with torch.no_grad():
        model(b["imgs"], b["cam_poses"], b["cam_intr"], train=True)
    return calls


def test_grad_accum_on_two_ranks_matches_jax(runs):
    """grad_accum 2 over the rank's first window twice (batch 2 per rank)
    is JAX's plain 2-device step on those windows (tests/test_train_step.py
    :73): the same loss and gradients. A BatchNorm called k times per
    forward takes s -> 0.9^k s + c per forward, c from JAX's one step, so
    after the two microbatches its statistics are 0.9^2k s0 + (0.9^k + 1)
    c."""
    r0, r1 = runs["ranks"]
    assert r0["accum"]["losses"] == r1["accum"]["losses"]
    np.testing.assert_allclose(r0["accum"]["losses"][0],
                               runs["jax_losses"][0], rtol=3e-3)
    scale = min(1.0, CLIP / runs["jax_norms"][0])
    _check_grads(r0["accum"]["grads"], runs["jax_grads"],
                 runs["jax_norms"][0] * scale)
    first = {k: v[0] for k, v in runs["steps"][0].items()}
    calls = _bn_calls_per_forward(runs["weights"], first)
    assert max(calls.values()) == 4 and min(calls.values()) == 1
    checked = 0
    for name, s1 in runs["jax_stats1"].items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        decay = 0.9 ** calls[name.rsplit(".", 1)[0]]
        s0 = runs["init_state"][name]
        c = s1 - decay * s0
        want = decay ** 2 * s0 + (decay + 1) * c
        np.testing.assert_allclose(r0["accum"]["stats"][name].numpy(), want,
                                   rtol=5e-3, atol=5e-4, err_msg=name)
        assert torch.equal(r0["accum"]["stats"][name],
                           r1["accum"]["stats"][name])
        checked += 1
    assert checked > 100, checked


@pytest.mark.parametrize("policy", ["nothing", "save_features"])
def test_remat_on_two_ranks_matches_no_remat(runs, policy):
    """The recomputed forward issues its sync-BN all-reduces inside the
    backward in the same order on both ranks; the running statistics are
    updated once per forward, not again by the recomputation."""
    r0, r1 = runs["ranks"]
    got = r0[f"remat_{policy}"]
    assert got["losses"] == r1[f"remat_{policy}"]["losses"]
    np.testing.assert_allclose(got["losses"], r0["ddp"]["losses"], rtol=1e-6)
    assert len(got["grad_dist"]) > 150
    worst = max(got["grad_dist"].values())
    assert worst < 1e-4, worst
    for name, v in got["stats"].items():
        torch.testing.assert_close(v, r0["ddp"]["state"][name], rtol=1e-6,
                                   atol=1e-7)


def test_train_tool_on_two_processes(no_tensorflow, tmp_path):
    """--multihost --coordinator on 2 gloo processes: equal losses, the JAX
    tool's `processes=2` line, rank 0 alone logging, dumping images and
    checkpointing into the shared logdir; --resume on 2 ranks continues at
    step 2; the checkpoint loads strictly into a one-device model."""
    logdir = tmp_path / "logs"
    outs = _tool(no_tensorflow, [logdir, logdir], "--steps", "2",
                 "--image-freq", "1")
    for out in outs:
        assert "devices=2 global_batch=2 local_batch=1 processes=2" in out
    losses = [_losses(out) for out in outs]
    assert len(losses[0]) == 2
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    scalars = (logdir / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in scalars] == [1, 2]
    assert sorted(os.listdir(logdir / "images")) == sorted(
        f"{kind}_{s:07d}.jpg" for kind in ("depth", "prob", "gt")
        for s in (1, 2))
    assert os.listdir(logdir / "ckpt") == ["step_00000002.pt"]
    blob = torch.load(logdir / "ckpt" / "step_00000002.pt",
                      weights_only=True)
    assert not any(k.startswith("module.") for k in blob["model"])
    DepthNetHybrid(ModelConfig(ndepths=ND, resnet=18)).load_state_dict(
        blob["model"], strict=True)

    outs = _tool(no_tensorflow, [logdir, logdir], "--steps", "1",
                 "--resume", "--image-freq", "100")
    for out in outs:
        assert "resumed from step 2" in out
        assert re.search(r"step 3 loss", out)
    assert _losses(outs[0]) == _losses(outs[1])
    scalars = (logdir / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in scalars] == [1, 2, 3]


def test_train_tool_under_torchrun_environment(no_tensorflow, tmp_path):
    """--multihost alone reads torchrun's RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT and LOCAL_RANK; with a logdir per rank, rank 1's stays
    without a file."""
    dirs = [tmp_path / "r0", tmp_path / "r1"]
    outs = _tool(no_tensorflow, dirs, "--steps", "1", "--image-freq", "1",
                 torchrun=True)
    assert all("processes=2" in out for out in outs)
    assert _losses(outs[0]) == _losses(outs[1]) and _losses(outs[0])
    written = [sorted(os.path.relpath(os.path.join(root, f), d)
                      for root, _, files in os.walk(d) for f in files)
               for d in dirs]
    assert "scalars.jsonl" in written[0]
    assert os.path.join("ckpt", "step_00000001.pt") in written[0]
    assert written[1] == [], written[1]


def test_trains_every_parameter_names_the_unused():
    """DDP looks for unused parameters only where a train step's loss does
    not reach every parameter: the key layer is unused without EST fusion
    and in a window of one target."""
    frames = pitched_frames(5)
    for est, views in ((True, 3), (True, 4), (False, 4)):
        model = DepthNetHybrid(ModelConfig(
            ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
            est_transformer=est))
        b = {k: torch.from_numpy(v.astype(bool if k == "dmasks"
                                          else np.float32))
             for k, v in _window(frames, 0, views).items()}
        depth = model(b["imgs"], b["cam_poses"], b["cam_intr"],
                      train=True)[0]["depth"]
        depth.sum().backward()
        unused = [k for k, p in model.named_parameters() if p.grad is None]
        assert model.trains_every_parameter(views) == (not unused), (
            est, views, unused)
        assert all(k.startswith("CostRegNet.key_layer.") for k in unused)


def test_multihost_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.init_distributed("localhost:1", 1, 0)
    args = train_tool.parse_args(["--synthetic", "--multihost",
                                  "--coordinator", "localhost:1",
                                  "--num-processes", "1",
                                  "--process-id", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tool.run(args)
    assert port_mesh.process_index() == 0 and port_mesh.process_count() == 1
    with pytest.raises(RuntimeError, match="init_distributed"):
        port_mesh.create_mesh()


def test_shard_batch_puts_this_process_shard_on_its_device():
    """Each process already holds only its own windows (its loader shard):
    shard_batch uploads numpy arrays and moves tensors, scattering
    nothing."""
    mesh = port_mesh.Mesh(None, 0, 1, torch.device("cpu"))
    batch = {"imgs": np.ones((1, 3, 4, 5, 3), np.float32),
             "dmasks": torch.ones(1, 1, 4, 5, dtype=torch.bool)}
    got = port_mesh.shard_batch(batch, mesh)
    assert set(got) == set(batch)
    assert all(isinstance(v, torch.Tensor) and v.device == mesh.device
               for v in got.values())
    assert got["imgs"].shape == (1, 3, 4, 5, 3)
    assert torch.equal(got["dmasks"], batch["dmasks"])
