"""The readers of the port's host waits (`estdepth::host_wait.*` spans,
harness/host_waits.py) on hand-built traces: the host ms inside the
outermost waits, the device idle of the gaps that began inside them, and
None where no wait ran or the protocol is another's."""

from __future__ import annotations

import pytest

from portbench.harness.cell import load_module
from portbench.harness.host_waits import Wait, waits
from portbench.harness.loop import Rec
from portbench.harness.readings import Readings
from portbench.harness.trace import Span, Trace
from portbench.tests.conftest import ROOT


def reader(name: str):
    return load_module(ROOT / "portbench" / "layer_metrics" / f"{name}.py")


def span(name: str, start: float, end: float) -> Span:
    return Span(name, start, end, 0.0, (), False)


# one request's host timeline, us: a step holding an upload, a cost volume
# with a pose inverse inside, and an inverse with another wait nested in it
SPANS = [span("estdepth::step", 0, 1000),
         span("estdepth::host_wait.upload", 10, 25),
         span("estdepth::cost_volume", 100, 400),
         span("estdepth::plane_sweep_sample", 110, 140),
         span("estdepth::host_wait.inverse", 150, 200),
         span("estdepth::host_wait.inverse", 500, 600),
         span("estdepth::host_wait.constant", 520, 540),
         span("portbench::issue", 0, 1000)]
# device busy intervals: gaps 20-30 (begins in the upload, runs past its
# end), 120-160 (begins before the inverse: the queue had drained), 180-190
# (in the inverse), 300-505 (outside every wait), 525-560 (in the nested
# wait, counted once, for the outer)
BUSY = [(0, 20), (30, 120), (160, 180), (190, 300), (505, 525), (560, 700)]
HOST_US = 15 + 50 + 100
IDLE_US = 10 + 10 + 35


def readings(protocol: str, spans=SPANS, busy=BUSY,
             delivered=(1, 0, 1)) -> Readings:
    records = [Rec("steady", d, 0.0, 0.0, 0.0) for d in delivered]
    trace = Trace(window_s=1.0, records=records, spans=list(spans),
                  device=[("kernel", s, e) for s, e in busy],
                  busy=list(busy))
    return Readings(protocol, records, 1.0, trace, {})


def test_each_outermost_wait_its_kind_span_host_and_idle():
    assert waits(readings("estm_stream").trace) == [
        Wait("upload", "estdepth::step", 15, 10),
        Wait("inverse", "estdepth::cost_volume", 50, 10),
        Wait("inverse", "estdepth::step", 100, 35)]


def test_a_gap_is_credited_only_where_it_begins_inside_a_wait():
    # the inverse entered at 150 after the gap from 120 began: not its
    early = readings("estm_stream", busy=[(0, 120), (160, 170)])
    assert [w.idle_us for w in waits(early.trace)] == [0, 0, 0]
    # a gap from 170 inside it counts whole, past the wait's end at 200
    inside = readings("estm_stream", busy=[(0, 170), (260, 270)])
    assert [w.idle_us for w in waits(inside.trace)] == [0, 90, 0]


def test_nested_waits_count_once():
    outer_only = [s for s in SPANS if s.name != "estdepth::host_wait.constant"]
    assert waits(readings("joint_window").trace) == waits(
        readings("joint_window", spans=outer_only).trace)


READERS = [
    ("stream", ["estm_stream"]),
    ("joint", ["joint_window"]),
    ("train", ["train_step"]),
    ("mvs", ["mvs_views", "mvs_views_wta", "mvs_scan"]),
]


@pytest.mark.parametrize("key, protocols", READERS)
def test_readers_per_delivering_request(key, protocols):
    host = reader(f"host_wait_ms.{key}").read
    idle = reader(f"wait_idle_ms.{key}").read
    for protocol in protocols:
        r = readings(protocol)  # 2 requests delivered of 3
        assert host(r) == pytest.approx(HOST_US / 1e3 / 2)
        assert idle(r) == pytest.approx(IDLE_US / 1e3 / 2)


@pytest.mark.parametrize("key, protocols", READERS)
def test_readers_give_none_without_waits_or_for_another_protocol(
        key, protocols):
    host = reader(f"host_wait_ms.{key}").read
    idle = reader(f"wait_idle_ms.{key}").read
    others = {p for _, ps in READERS for p in ps} - set(protocols)
    for protocol in others:
        assert host(readings(protocol)) is None
        assert idle(readings(protocol)) is None
    # a port that opens no host_wait span, as before they existed
    no_waits = [s for s in SPANS if "host_wait" not in s.name]
    r = readings(protocols[0], spans=no_waits)
    assert host(r) is None and idle(r) is None
    # no delivered request in the traced half
    r = readings(protocols[0], delivered=(0, 0))
    assert host(r) is None and idle(r) is None
    # no device activity: a run on the CPU, with no queue to wait on
    r = readings(protocols[0], busy=[])
    assert host(r) is None and idle(r) is None


def test_a_traced_cpu_run_holds_the_ports_waits(tiny_root, run_cell,
                                                monkeypatch):
    """A traced run of the stream on the port's plain paths: the traced
    half's Trace holds the port's host waits, inside its steps, and the
    readers leave their metrics out, since nothing ran on a device."""
    from portbench.harness import trace

    traces = []
    reduce = trace.reduce
    monkeypatch.setattr(trace, "reduce",
                        lambda *a: traces.append(reduce(*a)) or traces[-1])
    res = run_cell(tiny_root, "psm.estm_stream", trace=1)
    assert res["correct"] is True
    (tr,) = traces
    found = waits(tr)
    assert {w.kind for w in found} == {"upload", "inverse", "solve",
                                       "constant"}
    assert {w.within for w in found} <= {"estdepth::step",
                                         "estdepth::cost_volume",
                                         "estdepth::est_fusion"}
    assert not any(k.startswith(("host_wait_ms", "wait_idle_ms"))
                   for k in res["metrics"])
