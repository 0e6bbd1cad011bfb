"""The readers of `group_norm_act_roofline.stream` and `.joint` on
hand-built readings: the EST GRU's two calls a target (the gates
[1, 32, 64, 64, 80] in 2 groups, the output [1, 16, 64, 64, 80]) give the
share of the calls' byte bound in their device time; None outside each
cell's protocol, with no spans, and for a port without the op; and a
traced run of `psm.estm_stream` on the CPU, where the GRU keeps its
modules, reads None."""

from __future__ import annotations

import pytest

from portbench.harness.trace import Span
from portbench.tests.test_program_spans import reader, readings

VOLUME = (64, 64, 80)  # D, h, w of the flagship cost volume
DEVICE_US = {32: 45.0, 16: 20.0}  # a call's device time by its channels


def _gru(start: float) -> list:
    """One GRU call's two op ranges from `start` (us)."""
    return [Span("estdepth::group_norm_act", start + 10.0 * i,
                 start + 10.0 * i + 5.0, DEVICE_US[c],
                 ((1, c, *VOLUME), (c,), (c,), (), (), ()), False)
            for i, c in enumerate((32, 16))]


def _bytes(c: int) -> int:
    return 4 * (2 * c * 64 * 64 * 80 + 2 * c)


@pytest.mark.parametrize("name, protocol, targets", [
    ("group_norm_act_roofline.stream", "estm_stream", 1),
    ("group_norm_act_roofline.joint", "joint_window", 3)])
def test_share_of_the_gru_calls(name, protocol, targets):
    """Bytes: x read once and the output written once in float32, and the
    weight and bias: 8 (C D h w + C) a call, 83.9 and 41.9 MB."""
    assert _bytes(32) == pytest.approx(83.89e6, rel=1e-3)
    spans = [s for t in range(targets) for s in _gru(100.0 * t)]
    want = 100 * (_bytes(32) + _bytes(16)) / 3.35e12 / (
        (DEVICE_US[32] + DEVICE_US[16]) / 1e6)
    r = readings(protocol, spans, [targets])
    assert reader(name).read(r) == pytest.approx(want)
    assert 0 < want < 100


@pytest.mark.parametrize("name, protocol", [
    ("group_norm_act_roofline.stream", "estm_stream"),
    ("group_norm_act_roofline.joint", "joint_window")])
def test_a_range_nested_in_its_own_counts_once(name, protocol):
    spans = _gru(0.0)
    inner = [Span(s.name, s.start_us + 1.0, s.end_us - 1.0, s.device_us,
                  s.shapes, True) for s in spans]
    want = reader(name).read(readings(protocol, spans, [1]))
    got = reader(name).read(readings(protocol, [*spans, *inner], [1]))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["group_norm_act_roofline.stream",
                                  "group_norm_act_roofline.joint"])
@pytest.mark.parametrize("protocol, spans", [
    ("train_step", _gru(0.0)),
    ("mvs_views", _gru(0.0)),
    ("estm_stream", []),
    ("joint_window", []),
    # the parent: the GRU's norms as ATen kernels, no op range
    ("estm_stream", [Span("portbench::epipolar_transformer", 0.0, 50.0,
                          9e3, (), False)]),
])
def test_none_without_the_op_or_outside_the_cell(name, protocol, spans):
    assert reader(name).read(readings(protocol, spans, [1])) is None


def test_a_traced_cpu_run_of_the_stream_reads_none(tiny_root, run_cell):
    res = run_cell(tiny_root, "psm.estm_stream", trace=1)
    assert res["correct"] is True
    assert "group_norm_act_roofline.stream" not in res["metrics"]
    assert "est_fusion_ms.stream" in res["metrics"]


@pytest.mark.parametrize("name, other", [
    ("group_norm_act_roofline.stream", "joint_window"),
    ("group_norm_act_roofline.joint", "estm_stream")])
def test_each_reads_none_in_the_others_cell(name, other):
    assert reader(name).read(readings(other, _gru(0.0), [1])) is None
