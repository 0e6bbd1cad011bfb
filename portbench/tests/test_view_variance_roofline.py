"""The reader of `view_variance_roofline.mvs` on hand-built readings: a
view of CasMVSNet's three DTU stages, each a cost-volume span holding 4
sweeps of kernel 1 and one variance call whose list of volumes the
profiler records with no shapes (as it does on the card), gives the
share of the calls' byte bound in their device time; None outside the
cell's protocol, with no spans, and for a port without the op."""

from __future__ import annotations

import pytest

from portbench.harness.trace import Span
from portbench.tests.test_program_spans import reader, readings

METRIC = "view_variance_roofline.mvs"
# CasMVSNet's stages at the DTU setting: h, w, C, D; 5 views
STAGES = [(288, 400, 32, 48), (576, 800, 16, 32), (1152, 1600, 8, 8)]
VIEWS = 5
DEVICE_MS = [1.3, 1.8, 0.9]  # the variance call's device time a stage


def _stage_spans(start: float, h: int, w: int, c: int, d: int,
                 device_ms: float) -> list:
    """A stage's cost-volume span from `start` (us): 4 sweeps, then the
    variance call."""
    ref = (1, h, w, c)
    coords = (1, d * h * w)
    spans = [Span("estdepth::mvs_cost_volume", start, start + 100.0, 0.0,
                  (), False)]
    for i in range(VIEWS - 1):
        at = start + 10.0 + 10.0 * i
        spans.append(Span("estdepth::plane_sweep_sample", at, at + 5.0,
                          500.0, (ref, coords, coords), False))
    spans.append(Span("estdepth::view_variance", start + 60.0, start + 65.0,
                      1e3 * device_ms, (ref, ()), False))
    return spans


def _view() -> list:
    return [s for k, (stage, ms) in enumerate(zip(STAGES, DEVICE_MS))
            for s in _stage_spans(1000.0 * k, *stage, ms)]


def test_share_at_the_three_dtu_stages():
    """Bytes: the reference and the 4 volumes read once, the variance
    written once: 4 h w C (1 + V D) a stage, 10.72 GB a view."""
    nbytes = sum(4 * h * w * c * (1 + VIEWS * d) for h, w, c, d in STAGES)
    assert nbytes == pytest.approx(10.72e9, rel=1e-3)
    want = 100 * (nbytes / 3.35e12) / (sum(DEVICE_MS) / 1e3)
    r = readings("mvs_views", _view(), [1])
    assert reader(METRIC).read(r) == pytest.approx(want)
    assert 0 < want < 100
    # one stage alone: its own bytes over its own time
    h, w, c, d = STAGES[1]
    r = readings("mvs_views", _stage_spans(0.0, *STAGES[1], DEVICE_MS[1]),
                 [1])
    assert reader(METRIC).read(r) == pytest.approx(
        100 * 4 * h * w * c * (1 + VIEWS * d) / 3.35e12
        / (DEVICE_MS[1] / 1e3))


def test_calls_without_their_sweeps_count_for_nothing():
    """A call outside any cost-volume span, or after sweeps of another
    map, adds neither bytes nor time."""
    spans = _view()
    stray = Span("estdepth::view_variance", 5000.0, 5001.0, 7e3,
                 ((1, 288, 400, 32), ()), False)
    other = _stage_spans(6000.0, 288, 400, 32, 48, 5.0)
    other[-1] = Span("estdepth::view_variance", 6060.0, 6065.0, 5e3,
                     ((1, 288, 400, 16), ()), False)
    r = readings("mvs_views", [*spans, stray, *other], [1])
    want = reader(METRIC).read(readings("mvs_views", _view(), [1]))
    assert reader(METRIC).read(r) == pytest.approx(want)


@pytest.mark.parametrize("protocol, spans", [
    ("joint_window", _view()),
    ("mvs_views", []),
    # the parent: sweeps in the cost volumes, no variance op
    ("mvs_views", [s for s in _view()
                   if s.name != "estdepth::view_variance"]),
])
def test_none_without_the_op_or_outside_the_cell(protocol, spans):
    assert reader(METRIC).read(readings(protocol, spans, [1])) is None
