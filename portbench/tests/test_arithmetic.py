"""The benchmark's own arithmetic on hand-worked inputs: kernel bytes and
operations, roofline and peak shares, the idle share, the closed loop's
clock and the weights' init scheme."""

from __future__ import annotations

import math

import pytest
import torch

from portbench.harness import rooflines, trace
from portbench.harness.loop import Rec, process_age_s
from portbench.harness.readings import (
    Readings, device_ms_per, host_issue_ms, idle_percent, mfu_percent,
)


def test_plane_sweep_counts_the_estm_step():
    # the ESTM step sweeps 2 maps [64, 80, 32] over 64 planes
    nbytes, flops = rooflines.plane_sweep([(2, 64, 80, 32),
                                           (2, 64 * 64 * 80),
                                           (2, 64 * 64 * 80)])
    voxels = 2 * 64 * 64 * 80
    assert nbytes == 4 * (2 * 64 * 80 * 32 + 2 * voxels + 32 * voxels)
    assert flops == 32 * voxels * 9 + voxels * 20
    # chip_smoke.py's bound of this case: 0.0270 ms at 3.35 TB/s
    assert rooflines.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0270,
                                                                   abs=5e-5)


def test_exact_z_counts_an_output_window():
    vol = (2, 64, 64, 80, 32)
    nbytes, flops = rooflines.exact_z([vol, (2, 64, 64 * 80),
                                       (2, 64, 64, 40), (2, 64, 64, 40),
                                       (2, 64, 64, 40), (), ()])
    voxels = 2 * 64 * 64 * 40
    assert nbytes == 4 * (math.prod(vol) + 2 * 64 * 64 * 80 + 3 * voxels
                          + 32 * voxels)
    assert flops == 32 * voxels * 32 + voxels * 30


def test_bound_takes_the_larger_side():
    assert rooflines.bound_s(3.35e12, 0) == 1.0
    assert rooflines.bound_s(0, 67e12) == 1.0
    assert rooflines.bound_s(3.35e12, 2 * 67e12) == 2.0


def _span(name, device_us, shapes=(), nested=False, start=0.0, end=1.0):
    return trace.Span(name, start, end, device_us, shapes, nested)


def test_roofline_share_over_device_time():
    shapes = ((1, 4, 4, 16), (1, 8 * 4 * 4), (1, 8 * 4 * 4))
    nbytes, flops = rooflines.plane_sweep(shapes)
    bound_us = rooflines.bound_s(nbytes, flops) * 1e6
    spans = [_span("k", 2 * bound_us, shapes), _span("k", 2 * bound_us,
                                                      shapes)]
    assert rooflines.roofline_percent(spans, rooflines.plane_sweep) == (
        pytest.approx(50.0))
    assert rooflines.roofline_percent([], rooflines.plane_sweep) is None


def _trace(busy, window_s, spans=(), records=()):
    return trace.Trace(window_s, list(records), list(spans),
                       [("k", s, e) for s, e in busy],
                       trace._merge(busy))


def test_idle_share_and_merged_intervals():
    t = _trace([(0, 100), (50, 150), (300, 400)], 1e-3)
    assert t.busy == [(0, 150), (300, 400)]
    assert t.busy_s == pytest.approx(250e-6)
    r = Readings("p", [], 0.0, t, {})
    assert idle_percent(r, "p") == pytest.approx(75.0)
    assert idle_percent(r, "other") is None


def test_host_issue_and_mfu_from_records():
    recs = [Rec("steady", 1, 0.0, 0.010, 0.040),
            Rec("steady", 1, 0.040, 0.060, 0.080)]
    r = Readings("p", recs, 0.08, _trace([], 1.0), {"steady": 67e9})
    assert host_issue_ms(r, "p") == pytest.approx(15.0)
    # 2 x 67 GFLOP in 0.08 s against 67 TFLOP/s
    assert mfu_percent(r, "p") == pytest.approx(2.5)


def test_device_ms_per_request_and_nesting():
    spans = [_span("a", 3000.0), _span("a", 1000.0, nested=True),
             _span("b", 1000.0)]
    recs = [Rec("x", 1, 0, 0, 0), Rec("x", 0, 0, 0, 0), Rec("x", 1, 0, 0, 0)]
    r = Readings("p", [], 0.0, _trace([], 1.0, spans, recs), {})
    assert device_ms_per(r, "p", {"a", "b"}) == pytest.approx(2.0)
    assert device_ms_per(r, "p", {"c"}) is None


def test_breakdown_labels_gaps_by_the_open_span():
    spans = [_span("portbench::issue", 0, start=0, end=500),
             _span("portbench::fetch", 0, start=500, end=2000),
             _span("portbench::matchingFeature", 0, start=10, end=90)]
    t = _trace([(0, 100), (200, 600), (1600, 1700)], 2e-3, spans)
    b = trace.breakdown(t)
    assert dict(b["idle_gaps"]) == pytest.approx({
        "portbench::issue": 100e-6, "portbench::fetch": 1000e-6})
    assert b["device_ops"] == [["other", pytest.approx(600e-6)]]


def test_process_age_is_positive():
    assert 0 < process_age_s() < 1e6


def test_weights_follow_the_init_scheme():
    from portbench.harness.weights import TRUNC_STD, make_state_dict
    from portbench.reference.model import DepthNetHybrid

    with torch.device("meta"):
        ref = DepthNetHybrid("psm", ndepths=8, resnet=18)
    a = make_state_dict(ref, 2**31 + 5, "cpu")
    b = make_state_dict(ref, 2**31 + 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["semanticFeature.encoder.conv1.weight"]  # he-normal, fan-in 147
    std = math.sqrt(2.0 / w[0].numel()) / TRUNC_STD
    assert w.abs().max() <= 2 * std + 1e-6
    assert w.std().item() == pytest.approx(std * TRUNC_STD, rel=0.1)
    assert float(a["CostRegNet.dispconv_0.bias"].abs().max()) == 0.0
    assert float(a["pre2.1.weight"].abs().max()) == 0.0  # zero_bn_scale
    assert float(a["pre1.1.weight"].min()) == 1.0
    assert set(a) == set(ref.state_dict())


@pytest.mark.parametrize("make", [
    lambda: torch.nn.ConvTranspose3d(16, 4, 4, stride=2),
    lambda: torch.nn.ConvTranspose2d(16, 8, 3, groups=2),
    lambda: torch.nn.Conv3d(16, 8, 3)])
def test_weights_take_torch_fan_in_for_every_convolution(make):
    from torch.nn.init import _calculate_fan_in_and_fan_out

    from portbench.harness.weights import TRUNC_STD, make_state_dict

    with torch.device("meta"):
        conv = make()
    state = make_state_dict(conv, 2**31 + 9, "cpu")
    w = state["weight"]
    fan_in = _calculate_fan_in_and_fan_out(w)[0]
    assert fan_in == w[0].numel()
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD  # lecun-normal, unmarked
    assert w.abs().max() <= 2 * std + 1e-6
    assert w.std().item() == pytest.approx(std * TRUNC_STD, rel=0.15)
    assert float(state["bias"].abs().max()) == 0.0
