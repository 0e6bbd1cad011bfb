"""The cell `casmvsnet.dtu_views` on the CPU at a tiny size of its own:
whole runs at --trace 0 and 1 through the port's plain paths, the output
check failing on a port whose depth or confidence is altered, the
family's refusals, and the new readers on hand-built readings. On the
card (marked `cuda`): the TF32 control fails the cell's limits where the
program passes them.

    python -m pytest portbench/tests/test_casmvsnet.py -m cuda -q
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import pytest
import torch

from portbench.harness import models
from portbench.harness.rooflines import plane_sweep, roofline_percent
from portbench.harness.trace import Span
from portbench.tests.conftest import ROOT, SEED, load_run, tiny_checkout
from portbench.tests.test_program_spans import reader, readings, span

CELL = "casmvsnet.dtu_views"
NEW_METRICS = {"mvs_cost_volume_ms.mvs", "mvs_regularization_ms.mvs",
               "plane_sweep_roofline.mvs", "mfu.mvs",
               "feature_views_per_target.mvs", "device_idle_untraced.mvs"}
# of these, the ones a CPU run reads (the others need device time)
CPU_METRICS = {"mvs_cost_volume_ms.mvs", "mvs_regularization_ms.mvs",
               "mfu.mvs", "feature_views_per_target.mvs"}

# a port whose one output is altered at one pixel: the family's files
# as a model_config change would add them, a new family beside them
FAULT_FAMILY = '''
from pathlib import Path

from portbench.harness.cell import load_module

_base = load_module(Path(__file__).with_name("casmvsnet.py"))
structure, reference = _base.structure, _base.reference


def port(config, state, device):
    model = _base.port(config, state, device)
    forward = model.forward

    def altered(*args):
        out = forward(*args)
        out["{key}"][:, 0, 0] += {value}
        return out

    model.forward = altered
    return model
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout of the benchmark at 64x96, 16/8/8 planes, scans of 8
    views at DTU's field of view, 2 scenes."""
    root = tiny_checkout(tmp_path_factory.mktemp("mvs"))
    cfg_path = root / "portbench" / "configs" / "casmvsnet_dtu.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["model"].update(stage_planes=[16, 8, 8], ndepths=192)
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "portbench" / "traffic" / "mvs_views.json"
    mix = json.loads(mix_path.read_text())
    mix["scene"].update(frames=8, focal=2892.33 * 96 / 1600)
    mix_path.write_text(json.dumps(mix))
    return root


def test_cell_runs_and_is_correct(root, run_cell):
    res = run_cell(root, CELL, trace=0)
    assert res["correct"] is True, res["checked"]
    assert res["attempted"] > 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"joint_targets_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["checked"]) == {"depth_gap_m", "confidence_gap",
                                   "index_flip_share"}
    assert res["checked"]["depth_gap_m"]["value"] < 1e-5
    assert res["checked"]["index_flip_share"]["value"] < 1e-3
    res = run_cell(root, CELL, trace=1)
    assert res["correct"] is True, res["checked"]
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert CPU_METRICS <= set(got) <= NEW_METRICS
    assert got["feature_views_per_target.mvs"] == 5.0
    assert got["mfu.mvs"] > 0
    json.dumps(res)


@pytest.mark.parametrize("key, value, number", [
    ("depth", 0.01, "depth_gap_m"), ("confidence", 0.05, "confidence_gap")])
def test_output_check_fails_on_an_altered_port(root, run_cell, key, value,
                                               number):
    pb = root / "portbench"
    (pb / "families" / "casmvsnet_fault.py").write_text(
        FAULT_FAMILY.replace("{key}", key).replace("{value}", str(value)))
    cfg_path = pb / "configs" / "casmvsnet_dtu.json"
    cfg = json.loads(cfg_path.read_text())
    try:
        cfg_path.write_text(json.dumps(dict(cfg, family="casmvsnet_fault")))
        res = run_cell(root, CELL, trace=0, seconds=1.0)
    finally:
        cfg_path.write_text(json.dumps(cfg))
    assert res["correct"] is False
    assert res["checked"][number]["value"] == pytest.approx(value, rel=1e-3)


@pytest.mark.parametrize("model, match", [
    ({"compute_dtype": "bfloat16"}, "compute_dtype"),
    ({"stage_planes": [48, 32, 4]}, "stage_planes"),
    ({"feature_net": "psm"}, "feature_net")])
def test_family_refuses_what_the_reference_does_not_compute(root, model,
                                                            match):
    cfg = json.loads((root / "portbench" / "configs"
                      / "casmvsnet_dtu.json").read_text())
    cfg["model"].update(model)
    with pytest.raises(ValueError, match=match):
        models.weights(cfg, 1, torch.device("cpu"))


def test_readers_of_device_time():
    """The two readers that need the card's time, on hand-built readings:
    kernel 1's roofline share at a stage-1 sweep's shapes, and the idle
    share of 80 ms of device work in each of 2 steps against 100 ms a view
    on the host clock."""
    shapes = ((1, 288, 400, 32), (1, 48, 288, 400), (1, 48, 288, 400))
    sweep = [Span("estdepth::plane_sweep_sample", 0.0, 1.0, 500.0, shapes,
                  False)]
    r = readings("mvs_views", sweep, [1])
    want = roofline_percent(sweep, plane_sweep)
    assert 0 < want < 100
    assert reader("plane_sweep_roofline.mvs").read(r) == pytest.approx(want)
    steps = [span("estdepth::step", 80.0, start=i) for i in range(2)]
    r = readings("mvs_views", steps, [1, 1], host=[1] * 5,
                 host_window_s=0.5, device=[("k", 0.0, 1.6e5)],
                 busy=[(0.0, 1.6e5)])
    assert reader("device_idle_untraced.mvs").read(r) == pytest.approx(20.0)
    for name in NEW_METRICS - {"feature_views_per_target.mvs"}:
        r.protocol = "joint_window"
        assert reader(name).read(r) is None, name


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(cuda_device):
    """At the cell's own size, on scans of 12 views: the reference with
    TF32 in the program's place (the protocol's `control_numbers`, which
    portbench/calibrate.py cannot run) fails a limit; a run of the
    program on the same seed passes them."""
    from portbench.harness import cell as cells
    from portbench.harness.cell import load_module

    cell = cells.load(ROOT, CELL)
    cell = dataclasses.replace(cell, mix=dict(
        cell.mix, scene=dict(cell.mix["scene"], frames=12)))
    proto = load_module(ROOT / "portbench" / "protocols"
                        / f"{cell.mix['protocol']}.py")
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    control = proto.control_numbers(cell, SEED, cuda_device)
    assert any(control[k] > limits[k] for k in limits), control
    res = load_run().run(argparse.Namespace(workload=CELL, seed=SEED,
                                            seconds=3.0, trace=0))
    assert res["correct"], res["checked"]
