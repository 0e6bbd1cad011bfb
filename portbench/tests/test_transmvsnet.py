"""The cell `transmvsnet.dtu_views` on the CPU at a tiny size of its own:
whole runs at --trace 0 and 1 through the port's plain paths, the output
check failing on a port whose depth or confidence is altered, the
family's refusals, the argmax protocol's comparison on planted maps, and
the new readers on hand-built readings. On the card (marked `cuda`): the
TF32 control fails the cell's limits where the program passes them.

    python -m pytest portbench/tests/test_transmvsnet.py -m cuda -q
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import pytest
import torch

from estdepth_tpu_torch.utils.trace import counts
from portbench.harness import models
from portbench.harness.cell import load_module
from portbench.harness.rooflines import plane_sweep, roofline_percent
from portbench.harness.trace import Span
from portbench.tests.conftest import ROOT, SEED, load_run, tiny_checkout
from portbench.tests.test_program_spans import reader, readings, span

CELL = "transmvsnet.dtu_views"
NEW_METRICS = {"fmt_ms.tmvs", "arf_ms.tmvs", "mvs_cost_volume_ms.tmvs",
               "mvs_regularization_ms.tmvs", "fmt_tokens_per_target.tmvs",
               "mfu.tmvs", "plane_sweep_roofline.tmvs"}
# of these, the ones a CPU run reads (the roofline needs device time)
CPU_METRICS = NEW_METRICS - {"plane_sweep_roofline.tmvs"}

# a port whose one output is altered at one pixel: a family beside the
# others, as a model_config change would add it
FAULT_FAMILY = '''
from pathlib import Path

from portbench.harness.cell import load_module

_base = load_module(Path(__file__).with_name("transmvsnet.py"))
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


def _protocol():
    return load_module(ROOT / "portbench" / "protocols"
                       / "mvs_views_wta.py")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout of the benchmark at 64x96, 16/8/8 planes, scans of 8
    views at DTU's field of view, 2 scenes."""
    root = tiny_checkout(tmp_path_factory.mktemp("tmvs"))
    cfg_path = root / "portbench" / "configs" / "transmvsnet_dtu.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["model"].update(stage_planes=[16, 8, 8], ndepths=192)
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "portbench" / "traffic" / "mvs_views_wta.json"
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
    assert res["checked"]["depth_gap_m"]["value"] < 1e-6
    assert res["checked"]["index_flip_share"]["value"] < 1e-3
    before = counts()
    res = run_cell(root, CELL, trace=1)
    after = counts()
    assert res["correct"] is True, res["checked"]
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert CPU_METRICS <= set(got) <= NEW_METRICS
    # the counters are the process's: other cells' runs in this process
    # add targets without FMT tokens
    grow = {k: after[k] - before.get(k, 0)
            for k in ("mvs.fmt_tokens", "mvs.targets")}
    assert grow["mvs.fmt_tokens"] == 16 * 24 * 36 * grow["mvs.targets"]
    assert got["fmt_tokens_per_target.tmvs"] == (
        after["mvs.fmt_tokens"] / after["mvs.targets"])
    assert got["mfu.tmvs"] > 0
    json.dumps(res)


@pytest.mark.parametrize("key, value, number", [
    ("depth", 1e-4, "depth_gap_m"), ("confidence", 0.05, "confidence_gap")])
def test_output_check_fails_on_an_altered_port(root, run_cell, key, value,
                                               number):
    """A final depth moved by 0.1 mm (far under one hypothesis interval,
    so the argmax agrees) or a confidence by 0.05 at one pixel."""
    pb = root / "portbench"
    (pb / "families" / "transmvsnet_fault.py").write_text(
        FAULT_FAMILY.replace("{key}", key).replace("{value}", str(value)))
    cfg_path = pb / "configs" / "transmvsnet_dtu.json"
    cfg = json.loads(cfg_path.read_text())
    try:
        cfg_path.write_text(json.dumps(dict(cfg,
                                            family="transmvsnet_fault")))
        res = run_cell(root, CELL, trace=0, seconds=1.0)
    finally:
        cfg_path.write_text(json.dumps(cfg))
    assert res["correct"] is False
    assert res["checked"][number]["value"] == pytest.approx(value, rel=1e-2)


@pytest.mark.parametrize("model, match", [
    ({"compute_dtype": "bfloat16"}, "compute_dtype"),
    ({"stage_planes": [48, 32, 4]}, "stage_planes"),
    ({"feature_net": "psm"}, "feature_net"),
    ({"d_model": 64}, "d_model")])
def test_family_refuses_what_the_reference_does_not_compute(root, model,
                                                            match):
    cfg = json.loads((root / "portbench" / "configs"
                      / "transmvsnet_dtu.json").read_text())
    cfg["model"].update(model)
    cfg["family_file"] = str(ROOT / "portbench" / "families"
                             / "transmvsnet.py")
    with pytest.raises(ValueError, match=match):
        models.weights(cfg, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        models.reference(cfg, {}, torch.device("cpu"))


def test_family_gives_port_and_reference_one_state():
    """The norms the seed's state_dict leaves out (LayerNorm, BatchNorm1d)
    at scale 1 and bias 0 in both models, every other tensor the seed's."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "transmvsnet_dtu.json").read_text())
    cpu = torch.device("cpu")
    state = models.weights(cfg, SEED, cpu)
    ref = models.reference(cfg, state, cpu).state_dict()
    port = models.port(cfg, state, cpu).state_dict()
    assert set(ref) == set(port) > set(state)
    assert all(torch.equal(ref[k], port[k]) for k in ref)
    assert all(torch.equal(ref[k], state[k]) for k in state)
    assert torch.equal(ref["fmt.layers.3.norm2.weight"], torch.ones(32))
    assert torch.equal(ref["fmt.pos_encoding.kenc.encoder.4.running_var"],
                       torch.ones(64))
    assert sum(t.numel() for k, t in ref.items()
               if "running" not in k and "num_batches" not in k) == cfg[
        "parameters"]


def _maps(depths, indices, confidence):
    return {"depth": depths[-1], "confidence": confidence,
            "stage_depths": depths, "stage_indices": indices}


def test_compare_counts_flips_per_stage_and_leaves_them_out_of_the_gaps():
    """Planted maps of two requests: a flipped pixel moves its depth by a
    whole interval and its confidence by 0.5, and counts as a flip, not
    in either gap; agreeing pixels give the gaps."""
    compare = _protocol().compare
    gen = torch.Generator().manual_seed(0)
    sizes = [(2, 3), (4, 6), (8, 12)]
    limits = {k: {"limit": 1.0} for k in ("depth_gap_m", "confidence_gap",
                                          "index_flip_share")}
    got, want = [], []
    for n in range(2):
        depths = [0.6 + torch.rand(s, generator=gen) for s in sizes]
        indices = [torch.randint(0, 8, s, generator=gen, dtype=torch.uint8)
                   for s in sizes]
        conf = torch.rand(sizes[-1], generator=gen)
        got.append(_maps(depths, indices, conf))
        want.append(_maps([d.clone() for d in depths],
                          [i.clone() for i in indices], conf.clone()))
    for stage, (y, x) in ((0, (1, 2)), (2, (5, 7)), (2, (0, 0))):
        r = want[1]
        r["stage_indices"][stage][y, x] += 1
        r["stage_depths"][stage][y, x] += 0.0106
    want[1]["confidence"][5, 7] -= 0.5
    want[0]["stage_depths"][1][3, 4] += 5e-6
    want[1]["confidence"][1, 1] += 3e-5
    numbers = {k: v for k, v, _ in compare(got, want, limits)}
    pixels = 2 * sum(h * w for h, w in sizes)
    assert numbers["index_flip_share"] == pytest.approx(3 / pixels)
    assert numbers["depth_gap_m"] == pytest.approx(5e-6, rel=5e-2)
    assert numbers["confidence_gap"] == pytest.approx(3e-5, rel=5e-2)
    numbers = {k: v for k, v, _ in compare(got, got, limits)}
    assert numbers == {"depth_gap_m": 0.0, "confidence_gap": 0.0,
                       "index_flip_share": 0.0}


def test_readers_of_device_time_and_other_protocols():
    """Kernel 1's share at a stage-1 sweep's shapes and the span readers on
    hand-built readings; every new reader reads None on another
    protocol."""
    shapes = ((1, 288, 400, 32), (1, 48, 288, 400), (1, 48, 288, 400))
    sweep = [Span("estdepth::plane_sweep_sample", 0.0, 1.0, 500.0, shapes,
                  False)]
    r = readings("mvs_views_wta", sweep, [1])
    want = roofline_percent(sweep, plane_sweep)
    assert 0 < want < 100
    assert reader("plane_sweep_roofline.tmvs").read(r) == pytest.approx(
        want)
    spans = [span(f"estdepth::mvs_{s}", ms, start=i)
             for i, (s, ms) in enumerate([("fmt", 12.0), ("arf", 6.0),
                                          ("cost_volume", 9.0),
                                          ("regularization", 30.0)])]
    r = readings("mvs_views_wta", spans, [1, 1])
    for name, ms in (("fmt_ms", 6.0), ("arf_ms", 3.0),
                     ("mvs_cost_volume_ms", 4.5),
                     ("mvs_regularization_ms", 15.0)):
        assert reader(f"{name}.tmvs").read(r) == pytest.approx(ms), name
    for protocol in ("mvs_views", "joint_window"):
        r = readings(protocol, sweep + spans, [1], host=[1],
                     host_window_s=0.5)
        r.flops = {"view": 1e12, "steady": 1e12}
        for name in NEW_METRICS:
            assert reader(name).read(r) is None, (name, protocol)


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(cuda_device):
    """At the cell's own size, on scans of 12 views: the reference with
    TF32 in the program's place (the protocol's `control_numbers`) fails a
    limit; a run of the program on the same seed passes them."""
    from portbench.harness import cell as cells

    cell = cells.load(ROOT, CELL)
    cell = dataclasses.replace(cell, mix=dict(
        cell.mix, scene=dict(cell.mix["scene"], frames=12)))
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    control = _protocol().control_numbers(cell, SEED, cuda_device)
    assert any(control[k] > limits[k] for k in limits), control
    res = load_run().run(argparse.Namespace(workload=CELL, seed=SEED,
                                            seconds=3.0, trace=0))
    assert res["correct"], res["checked"]
