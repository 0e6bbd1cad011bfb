"""The port's spans and counters (estdepth_tpu_torch/utils/trace.py) on the
CPU, at the tiny configuration (ndepths 8, 64x96, ResNet-18).

With no profiler a span is the shared no-op and no profiler range opens.
Under torch.profiler one runner request or training step opens one
`estdepth::step`, with the cost volume and EST fusion inside it where they
run. The counters count the matching encoder's frames and the forward's
targets, and the encoder calls at a new shape; the kernels' launch counts
read the same registry, and the serving export traces no profiler op into
its programs. The matching encoder runs with cuDNN's measured plan choice
on and every other flag as its caller set it, also when it raises.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading

import pytest
import torch

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream, synthetic_window,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models import estdepth
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.ops.cuda import plane_warp
from estdepth_tpu_torch.tools.eval_joint import JointRunner
from estdepth_tpu_torch.train.trainer import make_train_step
from estdepth_tpu_torch.utils import trace
from test_torch_port_common import (  # noqa: F401
    one_torch_thread, training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")

H, W, DMIN, DMAX = 64, 96, 0.5, 8.0
SCENE = SyntheticSceneConfig(height=H, width=W, focal=80.0)


@pytest.fixture(scope="module")
def model():
    return DepthNetHybrid(ModelConfig(ndepths=8, depth_min=DMIN,
                                      depth_max=DMAX, resnet=18), seed=0)


@pytest.fixture(scope="module")
def frames():
    return list(synthetic_stream(SCENE, n_frames=5, depth_min=DMIN,
                                 depth_max=DMAX))


def _stream_runner(model, frames):
    """An ESTMRunner past its first window and one EST frame, and the
    frame that comes next: a steady frame, EST on."""
    runner = ESTMRunner(model, H, W, device="cpu")
    for f in frames[:4]:
        runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
    return runner, frames[4]


def _window(n_frames=5):
    return {k: torch.from_numpy(v) for k, v in synthetic_window(
        SCENE, n_frames=n_frames, depth_min=DMIN, depth_max=DMAX).items()}


def _train_step(model):
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    return make_train_step(model, opt, sched, DMIN, DMAX)


def _profiled(fn):
    """The profiler's events of fn(): {name: [(start, end) ...]} of the
    `estdepth::` ranges."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_is_the_shared_no_op(model, frames,
                                                     monkeypatch):
    assert trace.span("step") is trace.OFF
    with trace.span("step") as opened:
        assert opened is None
    wrapped = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        if name.startswith(trace.PREFIX):
            raise AssertionError(f"{name} opened with no profiler")
        return wrapped(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    runner, frame = _stream_runner(model, frames)
    assert runner.push_frame(frame["img"], frame["cam_pose"],
                             frame["cam_intr"]) is not None
    scalars = _train_step(model)(_window(3), clip_norm=10.0)
    assert torch.isfinite(scalars["loss"])


def test_a_stream_frame_opens_one_step_with_cost_volume_and_est_fusion(
        model, frames):
    runner, frame = _stream_runner(model, frames)
    spans = _profiled(lambda: runner.push_frame(
        frame["img"], frame["cam_pose"], frame["cam_intr"]))
    (step,) = spans["estdepth::step"]
    (cost,) = spans["estdepth::cost_volume"]
    (fusion,) = spans["estdepth::est_fusion"]
    assert _inside(cost, step) and _inside(fusion, step)


def test_a_joint_window_opens_one_step_with_one_cost_volume(model):
    runner = JointRunner(model, device="cpu")
    w = _window()
    spans = _profiled(lambda: runner.run_window(
        w["imgs"], w["cam_poses"], w["cam_intr"]))
    (step,) = spans["estdepth::step"]
    (cost,) = spans["estdepth::cost_volume"]
    assert _inside(cost, step)
    assert "estdepth::est_fusion" not in spans  # no memory yet


def test_a_training_step_opens_one_step_and_the_warp_gradients(model):
    step = _train_step(model)
    batch = _window(4)  # two targets: EST fusion runs in training
    spans = _profiled(lambda: step(batch, clip_norm=10.0))
    (outer,) = spans["estdepth::step"]
    (cost,) = spans["estdepth::cost_volume"]
    assert _inside(cost, outer)
    assert len(spans["estdepth::est_fusion"]) == 1
    backward = {name for name in spans if name.endswith("_backward")}
    assert backward == {"estdepth::plane_sweep_warp_backward",
                        "estdepth::frustum_warp_exact_z_backward"}
    assert all(_inside(s, outer) for name in backward for s in spans[name])


def _grown(fn) -> dict:
    before = trace.counts()
    fn()
    after = trace.counts()
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def test_counters_of_a_joint_window_and_a_steady_stream_frame(model,
                                                              frames,
                                                              monkeypatch):
    monkeypatch.setattr(trace, "_seen", collections.defaultdict(set))
    runner = JointRunner(model, device="cpu")
    w = _window()
    assert _grown(lambda: runner.run_window(
        w["imgs"], w["cam_poses"], w["cam_intr"])) == {
        "matching.frames": 5, "model.targets": 3,
        "matching.plan_searches": 1}
    stream, frame = _stream_runner(model, frames)
    assert _grown(lambda: stream.push_frame(
        frame["img"], frame["cam_pose"], frame["cam_intr"])) == {
        "matching.frames": 1, "model.targets": 1}


def test_plan_searches_count_each_new_matching_shape_once(model, frames,
                                                         monkeypatch):
    """A Joint window's 5 frames are one new key and a second window of
    that shape none; the stream's first window (3 frames) and its first
    frame after it (1 frame) one each, the next frame none."""
    monkeypatch.setattr(trace, "_seen", collections.defaultdict(set))
    runner = JointRunner(model, device="cpu")
    w = _window()

    def searches(fn):
        return _grown(fn).get("matching.plan_searches", 0)

    window = lambda: runner.run_window(w["imgs"], w["cam_poses"],  # noqa
                                       w["cam_intr"])
    assert [searches(window), searches(window)] == [1, 0]
    stream = ESTMRunner(model, H, W, device="cpu")
    pushes = [searches(lambda f=f: stream.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) for f in frames]
    assert pushes == [0, 0, 1, 1, 0]


# a caller's cuDNN flags, none of them the default
CALLER_FLAGS = {"benchmark": False, "allow_tf32": False,
                "deterministic": True, "enabled": False,
                "benchmark_limit": 3}


def _cudnn_flags() -> dict:
    return {k: getattr(torch.backends.cudnn, k) for k in CALLER_FLAGS}


@pytest.fixture
def caller_flags(monkeypatch):
    for k, v in CALLER_FLAGS.items():
        monkeypatch.setattr(torch.backends.cudnn, k, v)
    return dict(CALLER_FLAGS)


def test_matching_encoder_runs_with_measured_plans_and_the_callers_flags(
        model, frames, caller_flags):
    seen = []
    hook = model.matchingFeature.register_forward_pre_hook(
        lambda mod, args: seen.append(_cudnn_flags()))
    try:
        model.compute_matching(torch.from_numpy(frames[0]["img"])[None])
    finally:
        hook.remove()
    assert seen == [dict(caller_flags, benchmark=True)]
    assert _cudnn_flags() == caller_flags


def test_cudnn_flags_come_back_when_the_matching_encoder_raises(
        model, frames, caller_flags, monkeypatch):
    def fail(x):
        assert torch.backends.cudnn.benchmark
        raise RuntimeError("encoder failed")

    monkeypatch.setattr(model.matchingFeature, "forward", fail)
    with pytest.raises(RuntimeError, match="encoder failed"):
        model.compute_matching(torch.from_numpy(frames[0]["img"])[None])
    assert _cudnn_flags() == caller_flags


def test_measured_plans_leave_the_cpu_features_equal(model, frames,
                                                     monkeypatch):
    imgs = torch.stack([torch.from_numpy(f["img"]) for f in frames])
    scoped = model.compute_matching(imgs)
    monkeypatch.setattr(estdepth, "measured_conv_plans",
                        contextlib.nullcontext)
    assert torch.equal(scoped, model.compute_matching(imgs))


def test_kernel_launch_counts_read_the_registry():
    kernel = plane_warp.KERNEL
    before = (kernel.launches, kernel.launches_bf16)
    trace.count(f"launches.{kernel.stem}", 2)
    trace.count(f"launches_bf16.{kernel.stem}")
    assert (kernel.launches, kernel.launches_bf16) == (before[0] + 2,
                                                       before[1] + 1)
    with pytest.raises(AttributeError):
        kernel.launches = 0
    counts = trace.counts()
    counts["matching.frames"] = -1  # a copy: the registry is unchanged
    assert trace.counts().get("matching.frames") != -1


def test_counting_from_many_threads_loses_no_add():
    name, threads, adds = "test.threads", 16, 2000
    start = trace.counts().get(name, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [trace.count(name) for _ in range(adds)])
            for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counts()[name] == start + threads * adds


def test_count_new_counts_each_key_once_across_threads(monkeypatch):
    monkeypatch.setattr(trace, "_seen", collections.defaultdict(set))
    name, threads, keys = "test.new_keys", 16, 500
    start = trace.counts().get(name, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [trace.count_new(name, k) for k in range(keys)])
            for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counts()[name] == start + keys


def test_the_stream_artifact_holds_no_profiler_op(model):
    art = serving.export_stream(model, height=H, width=W, device="cpu")
    targets = {str(n.target) for program in (art.first, art.steady)
               for n in program.graph.nodes}
    assert not [t for t in targets if "profiler" in t]
    assert "estdepth.plane_sweep_sample.default" in targets
