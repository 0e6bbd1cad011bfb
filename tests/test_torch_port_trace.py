"""The port's spans and counters (estdepth_tpu_torch/utils/trace.py) on the
CPU, at the tiny configuration (ndepths 8, 64x96, ResNet-18).

With no profiler a span, and a host wait, is the shared no-op and no
profiler range opens. Under torch.profiler one runner request or training
step opens one `estdepth::step`, with the cost volume and EST fusion
inside it where they run, and each call at which the host waits on the
device (on CUDA) inside an `estdepth::host_wait.<kind>` range within the
step; the outputs are the same, bit for bit, with the profiler on. The
counters count the matching encoder's frames, the forward's targets and
its folded conv_bn blocks, and the encoder calls at a new shape; the
kernels' launch counts read the same registry, and the serving export
traces no profiler op into its programs. The matching encoder runs with
cuDNN's measured plan choice on and every other flag as its caller set
it, also when it raises.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import sys
import threading

import pytest
import torch

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.config import CascadeConfig, ModelConfig
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream, synthetic_window,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.eval.mvs import MVSRunner
from estdepth_tpu_torch.models import estdepth, layers
from estdepth_tpu_torch.models.casmvsnet import CascadeMVSNet
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


def _stream_runner(model, frames, **options):
    """An ESTMRunner past its first window and one EST frame, and the
    frame that comes next: a steady frame, EST on."""
    runner = ESTMRunner(model, H, W, device="cpu", **options)
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


def test_host_wait_without_a_profiler_is_the_shared_no_op():
    assert trace.host_wait("upload") is trace.OFF
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.host_wait("upload") as opened:
            assert opened is not None
    assert [e.name for e in prof.events()] == ["estdepth::host_wait.upload"]


def _mvs_view():
    """A CasMVSNet request at the tiny size: 3 views at 64x96, 16/8/8
    planes, from a synthetic scan."""
    from portbench.harness.scenes import Path, make_scenes

    path = Path(height=H, width=W, frames=3, step_x=0.03, step_z=-0.0045,
                yaw_per_frame=0.002, plane_offset=(0.6, 0.75),
                focal=2892.33 * W / 1600)
    scene = make_scenes(path, 1, 5, torch.device("cpu"))[0]
    return (torch.from_numpy(scene.frames)[None],
            torch.from_numpy(scene.poses)[None],
            torch.from_numpy(scene.intr)[None])


def _request(case, model, frames):
    """(set-up, request) of one runner's steady request on fresh state:
    set-up runs what comes before it, the request returns its outputs."""
    if case == "stream":  # a steady frame, the benchmark's two scales
        def setup():
            return _stream_runner(model, frames, output_scales=(0, 2))

        return setup, lambda s: (s[0].push_frame(
            s[1]["img"], s[1]["cam_pose"], s[1]["cam_intr"]),)
    if case == "joint":  # the second window, EST on the first's memory
        w = _window()
        args = (w["imgs"], w["cam_poses"], w["cam_intr"])

        def setup():
            runner = JointRunner(model, device="cpu")
            runner.run_window(*args)
            return runner

        return setup, lambda runner: runner.run_window(*args)[:1]
    if case == "casmvsnet":
        net, views = CascadeMVSNet(CascadeConfig(stage_planes=(16, 8, 8)),
                                   seed=3), _mvs_view()
        return (lambda: MVSRunner(net, device="cpu"),
                lambda runner: runner.run_view(*views))
    batch = _window()  # a training step: three targets, EST on

    def setup():
        copied = copy.deepcopy(model)
        return copied, _train_step(copied)

    def train(s):
        scalars = s[1](batch, clip_norm=10.0)
        return (scalars["loss"], *s[0].parameters())

    return setup, train


# host_wait ranges of one steady request, by kind
HOST_WAITS = {
    # the frame and pose (one range); the projections, the fusion's pose
    # inverse, the frustum warp's pose and K^-1 and the zi field's K^-1;
    # the zi field's normals; the intrinsics' scale and the scales' index
    "stream": {"upload": 1, "inverse": 6, "solve": 1, "constant": 2},
    # the window; 2 projections and 4 inverses for each of 3 targets
    "joint": {"upload": 1, "inverse": 14, "solve": 3, "constant": 1},
    # the request; a projection a stage and one for each of 2 sources a
    # stage; each stage's intrinsics and stage 1's depth range
    "casmvsnet": {"upload": 1, "inverse": 9, "constant": 4},
    "train": {"inverse": 14, "solve": 3, "constant": 1},
}


@pytest.mark.parametrize("case", list(HOST_WAITS))
def test_host_waits_of_a_request_lie_inside_its_step(model, frames, case):
    setup, request = _request(case, model, frames)
    state = setup()
    spans = _profiled(lambda: request(state))
    (step,) = spans["estdepth::step"]
    prefix = "estdepth::host_wait."
    waits = {name[len(prefix):]: len(spans[name]) for name in spans
             if name.startswith(prefix)}
    assert waits == HOST_WAITS[case]
    assert all(_inside(s, step) for name in spans if name.startswith(prefix)
               for s in spans[name])


@pytest.mark.parametrize("case", list(HOST_WAITS))
def test_outputs_are_the_same_with_the_profiler_on(model, frames, case):
    setup, request = _request(case, model, frames)
    plain = request(setup())
    state = setup()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = request(state)
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


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
    # each conv_bn block of the model runs once, folded
    blocks = sum(isinstance(m, layers.ConvBN) for m in model.modules())
    assert _grown(lambda: runner.run_window(
        w["imgs"], w["cam_poses"], w["cam_intr"])) == {
        "matching.frames": 5, "model.targets": 3,
        "matching.plan_searches": 1, "layers.bn_folded": blocks}
    stream, frame = _stream_runner(model, frames)
    assert _grown(lambda: stream.push_frame(
        frame["img"], frame["cam_pose"], frame["cam_intr"])) == {
        "matching.frames": 1, "model.targets": 1,
        "layers.bn_folded": blocks}


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
