"""The port's training parts against the JAX package on CPU: the loss, the
schedule, Adam-with-L2 and the clip against optax, gradient accumulation,
rematerialization, frozen subtrees and checkpoints.

Inputs are made with numpy from a seed and handed to both sides. No JAX
model is compiled here (tests/test_torch_port_train_jax.py holds the whole
step against JAX); the model-level tests run the port's tiny model
(ndepths 8, 64x96, ResNet-18, 3 views).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from estdepth_tpu.train import loss as jloss
from estdepth_tpu.train.schedule import warmup_multistep_schedule as jax_sched
from estdepth_tpu.train.trainer import (
    clip_by_global_norm as jax_clip, make_optimizer as jax_make_optimizer,
)
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_window,
)
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.train import loss as tloss
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import (
    TrainState, clip_by_global_norm, make_optimizer, make_train_step,
)
from estdepth_tpu_torch.utils.checkpoint import (
    CheckpointManager, load_weights_for_finetune, partial_restore,
)
from estdepth_tpu_torch.utils.logging import DictAverageMeter, ScalarLogger

from test_torch_port_common import (  # noqa: F401
    one_torch_thread, training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
DMIN, DMAX = 0.5, 8.0


def _model(seed=0, **cfg):
    return DepthNetHybrid(ModelConfig(ndepths=8, depth_min=DMIN,
                                      depth_max=DMAX, resnet=18, **cfg),
                          seed=seed)


def _batch(batch=1, n_frames=3):
    cfg = SyntheticSceneConfig(height=64, width=96, focal=80.0)
    w = synthetic_window(cfg, n_frames=n_frames, depth_min=DMIN,
                         depth_max=DMAX, batch=batch)
    return {k: torch.from_numpy(v) for k, v in w.items()}


def _sgd_step(model, lr=1e-3, **kwargs):
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    return make_train_step(model, opt, sched, DMIN, DMAX, **kwargs)


def test_loss_and_stats_match_jax():
    rng = np.random.default_rng(0)
    b, t, s, h, w = 2, 3, 4, 12, 16
    pred = rng.uniform(0.2, 9.0, size=(b, t, s, h, w)).astype(np.float32)
    gt = rng.uniform(0.0, 9.0, size=(b, t, h, w)).astype(np.float32)
    mask = (gt > DMIN) & (gt < DMAX) & (rng.uniform(size=gt.shape) > 0.2)
    mask[:, 2] = False  # a target without a valid pixel
    want_total, want = jloss.multi_scale_loss(pred, gt, mask, DMIN, DMAX)
    got_total, got = tloss.multi_scale_loss(
        torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask),
        DMIN, DMAX)
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    want_d, want_a = jloss.depth_stats(gt, pred[:, :, 0], DMIN, DMAX)
    got_d, got_a = tloss.depth_stats(torch.from_numpy(gt),
                                     torch.from_numpy(pred[:, :, 0]), DMIN,
                                     DMAX)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5)
    img = rng.uniform(-1, 1, size=(b, h, w, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(tloss.edge_aware_smoothness(torch.from_numpy(gt[:, 0]),
                                          torch.from_numpy(img))),
        float(jloss.edge_aware_smoothness(gt[:, 0], img)), rtol=1e-5)


def test_schedule_values():
    """The five points of tests/test_train_step.py::test_schedule_values,
    and the JAX schedule at more of them."""
    kw = dict(steps_per_epoch=1000, milestones_epochs=(2, 4), gamma=0.5,
              warmup_steps=500, warmup_factor=1.0 / 3.0)
    sched = warmup_multistep_schedule(4e-5, **kw)
    np.testing.assert_allclose(sched(0), 4e-5 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(sched(500), 4e-5, rtol=1e-6)
    np.testing.assert_allclose(sched(1999), 4e-5, rtol=1e-6)
    np.testing.assert_allclose(sched(2000), 2e-5, rtol=1e-6)
    np.testing.assert_allclose(sched(4000), 1e-5, rtol=1e-6)
    want = jax_sched(4e-5, **kw)
    for step in (1, 137, 499, 501, 2001, 3999, 9000):
        np.testing.assert_allclose(sched(step), float(want(step)), rtol=1e-6)


def test_adam_with_l2_and_clip_match_optax():
    """Three updates of a toy tree with the clip active: parameters within
    1e-6, the returned norm within 1e-6 relative."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3.0 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(steps_per_epoch=2, milestones_epochs=(1,), warmup_steps=2)
    tx = jax_make_optimizer(jax_sched(1e-2, **kw), weight_decay=4e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    optimizer, scheduler = make_optimizer(
        params.items(), warmup_multistep_schedule(1e-2, **kw), 4e-4)
    for g in grads:
        clipped, want_norm = jax_clip({k: jnp.asarray(v)
                                       for k, v in g.items()}, 2.0)
        updates, opt_state = tx.update(clipped, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_by_global_norm(params.values(), 2.0)
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        assert float(norm) > 2.0  # the clip was active
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_grad_accum_matches_plain_step_on_duplicated_microbatches():
    """grad_accum=2 over two IDENTICAL microbatches gives the plain B = 1
    step's parameter update (tests/test_train_step.py, SGD for the same
    reason): per-microbatch BN statistics equal the B = 1 statistics, so
    the averaged gradient is the plain gradient. The running statistics
    take their momentum update once per microbatch."""
    b1 = _batch(1)
    b2 = {k: torch.cat([v, v], 0) for k, v in b1.items()}
    plain, accum = _model(), _model()
    sc_plain = _sgd_step(plain)(b1, 10.0)
    sc_accum = _sgd_step(accum, grad_accum=2)(b2, 10.0)
    np.testing.assert_allclose(float(sc_accum["loss"]),
                               float(sc_plain["loss"]), rtol=1e-5)
    for (k, a), (_, p) in zip(accum.named_parameters(),
                              plain.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # running_mean after two momentum-0.1 updates towards the same batch
    # mean m from 0: 0.19 m against 0.1 m
    ra = accum.pre0[1].running_mean
    rp = plain.pre0[1].running_mean
    np.testing.assert_allclose(ra.numpy(), 1.9 * rp.numpy(), rtol=1e-4,
                               atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        _sgd_step(_model(), grad_accum=2)(b1, 10.0)


@pytest.mark.parametrize("policy", ["nothing", "save_features"])
def test_remat_gives_the_plain_step(policy):
    """Recomputing the forward in the backward changes neither the update
    nor BatchNorm's running statistics (one momentum update per step)."""
    batch = _batch(1, n_frames=4)
    plain, remat = _model(seed=2), _model(seed=2)
    sc_plain = _sgd_step(plain)(batch, 10.0)
    sc_remat = _sgd_step(remat, remat=True, remat_policy=policy)(batch, 10.0)
    np.testing.assert_allclose(float(sc_remat["loss"]),
                               float(sc_plain["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(sc_remat["grad_norm"]),
                               float(sc_plain["grad_norm"]), rtol=1e-4)
    for (k, a), (_, p) in zip(remat.state_dict().items(),
                              plain.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert int(remat.pre0[1].num_batches_tracked) == 1


def test_remat_policy_dots_is_refused():
    model = _model()
    with pytest.raises(ValueError, match="dots"):
        _sgd_step(model, remat=True, remat_policy="dots")


def test_frozen_prefixes_do_not_train():
    model = _model(seed=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = make_optimizer(
        model.named_parameters(), warmup_multistep_schedule(1e-3, 100),
        frozen_prefixes=("matchingFeature",))
    step = make_train_step(model, optimizer, scheduler, DMIN, DMAX)
    scalars = step(_batch(1), 10.0)
    assert np.isfinite(float(scalars["loss"]))
    assert np.isfinite(float(scalars["grad_norm"]))
    after = model.state_dict()
    moved = {k.split(".")[0] for k, v in after.items()
             if "running" not in k and "num_batches" not in k
             and not torch.equal(v, before[k])}
    assert moved == {"semanticFeature", "CostRegNet", "pre0", "pre1", "pre2"}
    # the frozen encoder still runs BatchNorm in train mode
    assert int(model.matchingFeature.firstconv[0][1].num_batches_tracked) == 1
    assert all(p.grad is None for p in model.matchingFeature.parameters())


def test_checkpoint_save_restore_gives_the_identical_next_step(tmp_path):
    def fresh(seed):
        model = _model(seed=seed)
        optimizer, scheduler = make_optimizer(
            model.named_parameters(),
            warmup_multistep_schedule(1e-3, 100, warmup_steps=5))
        return TrainState(model, optimizer, scheduler)

    batch = _batch(1)
    state = fresh(4)
    step = make_train_step(state.model, state.optimizer, state.scheduler,
                           DMIN, DMAX)
    step(batch, 10.0)
    state.step = 1
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(fresh(5))
    mgr.save(1, state)
    want = step(batch, 10.0)

    other = mgr.restore(fresh(5))  # another seed: everything is loaded
    assert other.step == 1
    assert other.scheduler.last_epoch == 1
    got = make_train_step(other.model, other.optimizer, other.scheduler,
                          DMIN, DMAX)(batch, 10.0)
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])
    for (k, a), (_, b) in zip(other.model.state_dict().items(),
                              state.model.state_dict().items()):
        assert torch.equal(a, b), k

    for n in (2, 3):
        mgr.save(n, state)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    # a checkpoint directory is a --loadckpt source
    loaded = load_weights_for_finetune(str(tmp_path / "ckpt"))
    assert set(loaded) == set(state.model.state_dict())


def test_partial_restore_merges_by_name_and_shape(tmp_path):
    target = _model(seed=6).state_dict()
    donor = _model(seed=7).state_dict()
    loaded = {k: v for k, v in donor.items()
              if k.split(".")[0] in train_tool.ENCODERS}
    wrong = "semanticFeature.encoder.conv1.weight"
    loaded[wrong] = torch.zeros(3, 3)  # a shape that does not fit
    loaded["not.in.the.model"] = torch.zeros(1)
    merged = partial_restore(target, loaded, verbose=False)
    assert set(merged) == set(target)
    for k, v in merged.items():
        from_donor = k in loaded and k != wrong
        assert torch.equal(v, donor[k] if from_donor else target[k]), k
    model = _model(seed=6)
    model.load_state_dict(merged)
    # a bare state_dict file and one under "model" are both sources
    torch.save(donor, tmp_path / "bare.ckpt")
    torch.save({"model": donor, "epoch": 3}, tmp_path / "wrapped.ckpt")
    for name in ("bare.ckpt", "wrapped.ckpt"):
        got = load_weights_for_finetune(str(tmp_path / name))
        assert all(torch.equal(got[k], donor[k]) for k in donor)


def test_train_tool_runs_and_resumes(tmp_path, capsys):
    argv = ["--synthetic", "--device", "cpu", "--height", "64", "--width",
            "96", "--ndepths", "8", "--resnet", "18", "--n-frames", "3",
            "--summary-freq", "1", "--logdir", str(tmp_path)]
    first = train_tool.run(train_tool.parse_args(argv + ["--steps", "2"]))
    assert [r["step"] for r in first["records"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in first["records"])
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    assert "epoch 0 step 2 loss" in capsys.readouterr().out
    second = train_tool.run(train_tool.parse_args(
        argv + ["--steps", "1", "--resume", "--two-pass-warp"]))
    assert [r["step"] for r in second["records"]] == [3]
    assert "resumed from step 2" in capsys.readouterr().out
    lines = (tmp_path / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 3
    assert train_tool.parse_args(argv + ["--bf16"]).bf16
    with pytest.raises(SystemExit):  # flags that are not ported are refused
        train_tool.parse_args(argv + ["--fast-frustum"])
    assert train_tool.parse_args(argv + ["--multihost"]).multihost
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_tool.run(train_tool.parse_args(
                ["--synthetic", "--logdir", str(tmp_path)]))


def test_meter_and_logger(tmp_path):
    meter = DictAverageMeter()
    meter.update({"a": 1.0, "b": 2.0})
    meter.update({"a": 3.0, "b": 2.0})
    assert meter.mean() == {"a": 2.0, "b": 2.0}
    meter.reset()
    assert meter.mean() == {}
    logger = ScalarLogger(str(tmp_path), use_tensorboard=False)
    logger.log(7, {"loss": torch.tensor(0.5)})
    logger.close()
    assert '"train/loss": 0.5' in (tmp_path / "scalars.jsonl").read_text()
