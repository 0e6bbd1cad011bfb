"""The reader of `view_correlation_roofline.tmvs` on hand-built readings:
a view of TransMVSNet's three DTU stages, each with 4 correlation calls
whose two argument shapes the profiler records, gives the share of the
calls' byte bound in their device time; None outside the cell's
protocol, with no spans, and for a port without the op."""

from __future__ import annotations

import pytest

from portbench.harness.trace import Span
from portbench.tests.test_program_spans import reader, readings

METRIC = "view_correlation_roofline.tmvs"
# TransMVSNet's stages at the DTU setting: h, w, C, D; 4 source views
STAGES = [(288, 400, 32, 48), (576, 800, 16, 32), (1152, 1600, 8, 8)]
SOURCES = 4
DEVICE_MS = [0.26, 0.36, 0.21]  # a correlation call's device time a stage


def _calls(start: float, h: int, w: int, c: int, d: int,
           device_ms: float) -> list:
    """A stage's 4 correlation calls from `start` (us), each after a
    sweep of kernel 1."""
    spans = []
    for i in range(SOURCES):
        at = start + 20.0 * i
        spans.append(Span("estdepth::plane_sweep_sample", at, at + 5.0,
                          500.0, ((1, h, w, c), (1, d * h * w),
                                  (1, d * h * w)), False))
        spans.append(Span("estdepth::view_correlation", at + 10.0,
                          at + 15.0, 1e3 * device_ms,
                          ((1, h, w, c), (1, d, h, w, c)), False))
    return spans


def _view() -> list:
    return [s for k, (stage, ms) in enumerate(zip(STAGES, DEVICE_MS))
            for s in _calls(1000.0 * k, *stage, ms)]


def test_share_at_the_three_dtu_stages():
    """Bytes: the reference and the volume read once, the correlation
    written once: 4 h w (C + D C + D) a call, 9.47 GB a view of 4
    sources."""
    nbytes = SOURCES * sum(4 * h * w * (c + d * c + d)
                           for h, w, c, d in STAGES)
    assert nbytes == pytest.approx(9.47e9, rel=1e-3)
    want = 100 * (nbytes / 3.35e12) / (SOURCES * sum(DEVICE_MS) / 1e3)
    r = readings("mvs_views_wta", _view(), [1])
    assert reader(METRIC).read(r) == pytest.approx(want)
    assert 0 < want < 100
    # one stage alone: its own bytes over its own time
    h, w, c, d = STAGES[1]
    r = readings("mvs_views_wta", _calls(0.0, *STAGES[1], DEVICE_MS[1]),
                 [1])
    assert reader(METRIC).read(r) == pytest.approx(
        100 * 4 * h * w * (c + d * c + d) / 3.35e12 / (DEVICE_MS[1] / 1e3))


def test_a_range_nested_in_its_own_counts_once():
    """The dispatcher's inner range of the same op adds neither bytes nor
    time: only the outer range is read."""
    spans = _view()
    inner = [Span(s.name, s.start_us + 1.0, s.end_us - 1.0, s.device_us,
                  s.shapes, True)
             for s in spans if s.name == "estdepth::view_correlation"]
    want = reader(METRIC).read(readings("mvs_views_wta", spans, [1]))
    got = reader(METRIC).read(readings("mvs_views_wta", [*spans, *inner],
                                       [1]))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("protocol, spans", [
    ("mvs_views", _view()),
    ("joint_window", _view()),
    ("mvs_views_wta", []),
    # the parent: sweeps in the cost volumes, no correlation op
    ("mvs_views_wta", [s for s in _view()
                       if s.name != "estdepth::view_correlation"]),
])
def test_none_without_the_op_or_outside_the_cell(protocol, spans):
    assert reader(METRIC).read(readings(protocol, spans, [1])) is None
