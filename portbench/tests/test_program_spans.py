"""The readers of the port's own spans and counters on hand-built readings:
each metric's arithmetic, and None where its spans or counters are absent
(a port that opens none, as before they existed)."""

from __future__ import annotations

import sys

import pytest

from portbench.harness.cell import load_module
from portbench.harness.loop import Rec
from portbench.harness.readings import Readings
from portbench.harness.trace import Span, Trace
from portbench.tests.conftest import ROOT


def reader(name: str):
    return load_module(ROOT / "portbench" / "layer_metrics" / f"{name}.py")


def span(name: str, device_ms: float, start: float = 0.0,
         nested: bool = False) -> Span:
    return Span(name, start, start + 1.0, 1e3 * device_ms, (), nested)


def recs(delivered: list, kind: str = "steady") -> list:
    return [Rec(kind, d, 0.0, 0.0, 0.0) for d in delivered]


def readings(protocol: str, spans: list, traced: list, host: list = (),
             host_window_s: float = 1.0, device=(), busy=()) -> Readings:
    trace = Trace(window_s=1.0, records=recs(traced), spans=spans,
                  device=list(device), busy=list(busy))
    return Readings(protocol, recs(host), host_window_s, trace, {})


STREAM_SPANS = [span("estdepth::step", 2.0),  # a fill frame: the upload
                *(span("estdepth::step", 29.5, start=i) for i in range(4)),
                span("portbench::issue", 200.0)]


@pytest.mark.parametrize("name, protocol, delivered", [
    ("device_idle_untraced.stream", "estm_stream", [0, 1, 1, 1, 1]),
    ("device_idle_untraced.joint", "joint_window", [0, 3, 3, 3, 3]),
])
@pytest.mark.parametrize("overlap", [1.0, 1.25])
def test_untraced_idle_share(name, protocol, delivered, overlap):
    # 120 ms of device work inside the steps for 4 delivered requests of
    # the traced half and 5 ms of fetch copies outside them, laid end to
    # end or overlapping (a summed time 1.25x the union); 10 delivered
    # requests in the untraced 0.5 s
    device = [("kernel", 0.0, 1e3 * 120.0), ("copy", 2e5, 2e5 + 5e3)]
    busy = [(0.0, 1e3 * 120.0 / overlap), (2e5, 2e5 + 5e3 / overlap)]
    r = readings(protocol, STREAM_SPANS, delivered,
                 host=[0, *([delivered[1]] * 10)], host_window_s=0.5,
                 device=device, busy=busy)
    want = 100 * (1 - 30.0 / overlap / 50.0)
    assert reader(name).read(r) == pytest.approx(want)
    r.protocol = "train_step"
    assert reader(name).read(r) is None
    no_step = readings(protocol, STREAM_SPANS[-1:], delivered,
                       host=[1] * 10, host_window_s=0.5, device=device,
                       busy=busy)
    assert reader(name).read(no_step) is None
    no_device = readings(protocol, STREAM_SPANS, delivered, host=[1] * 10,
                         host_window_s=0.5)
    assert reader(name).read(no_device) is None


@pytest.mark.parametrize("name, protocol, span_name", [
    ("est_fusion_whole_ms.stream", "estm_stream", "estdepth::est_fusion"),
    ("cost_volume_ms.joint", "joint_window", "estdepth::cost_volume"),
])
def test_device_ms_of_a_program_span(name, protocol, span_name):
    spans = [span(span_name, 12.0, start=i) for i in range(3)]
    spans += [span(span_name, 5.0, nested=True),  # inside another: counted
              span("estdepth::step", 40.0),  # once, by the outer one
              span("estdepth::exact_z_resample", 0.5)]
    r = readings(protocol, spans, [1, 1, 1, 0])
    assert reader(name).read(r) == pytest.approx(12.0)
    assert reader(name).read(readings(protocol, spans[4:], [1, 1])) is None
    r.protocol = "train_step"
    assert reader(name).read(r) is None


def test_warp_backward_ms_per_step():
    spans = [span("estdepth::plane_sweep_warp_backward", 6.5),
             *(span("estdepth::frustum_warp_exact_z_backward", 8.5, start=i)
               for i in range(3)),
             span("estdepth::step", 500.0),
             span("estdepth::plane_sweep_sample", 0.1)]
    r = readings("train_step", spans * 2, [1, 1])
    assert reader("warp_backward_ms.train").read(r) == pytest.approx(32.0)
    assert reader("warp_backward_ms.train").read(
        readings("train_step", spans[4:], [1])) is None
    r.protocol = "estm_stream"
    assert reader("warp_backward_ms.train").read(r) is None


def test_matching_frames_per_target(monkeypatch):
    from estdepth_tpu_torch.utils import trace

    r = readings("joint_window", [], [3])
    read = reader("matching_frames_per_target.joint").read
    monkeypatch.setattr(trace, "counts", lambda: {
        "matching.frames": 50, "model.targets": 30, "launches.x": 7})
    assert read(r) == pytest.approx(5 / 3, abs=1e-12)
    r.protocol = "estm_stream"
    assert read(r) is None
    r.protocol = "joint_window"
    monkeypatch.setattr(trace, "counts", lambda: {"launches.x": 7})
    assert read(r) is None
    # a port without the trace module (the counters' absence)
    monkeypatch.setitem(sys.modules, "estdepth_tpu_torch.utils.trace", None)
    assert read(r) is None
