"""The cell `vggt.dtu_scan` on the CPU at a tiny size of its own: whole
runs at --trace 0 and 1 through the port's plain paths (bf16 autocast on
the CPU), the output check failing on a port whose global blocks attend
within each frame only, the family's refusals and state, the whole-scan
protocol's requests, counts and comparison, the control, the operation
counts, and the new readers on hand-built readings. On the card (marked
`cuda`): the bf16 control fails the cell's limits where the program
passes them.

    python -m pytest portbench/tests/test_vggt.py -m cuda -q
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json

import pytest
import torch

from estdepth_tpu_torch.utils.trace import counts
from portbench.harness import attention, models
from portbench.harness import cell as cells
from portbench.harness.cell import load_module
from portbench.harness.loop import Rec
from portbench.harness.trace import Span
from portbench.tests.conftest import ROOT, SEED, load_run, tiny_checkout
from portbench.tests.test_program_spans import reader, readings, span

CELL = "vggt.dtu_scan"
NEW_METRICS = {"vggt_global_ms.vggt", "vggt_frame_ms.vggt",
               "vggt_patch_embed_ms.vggt", "vggt_depth_head_ms.vggt",
               "global_attention_roofline.vggt", "mfu.vggt",
               "global_tokens_per_request.vggt"}
# of these, the ones a CPU run reads (the roofline needs device time)
CPU_METRICS = NEW_METRICS - {"global_attention_roofline.vggt"}
CHECKED = {"log_depth_gap", "log_depth_gap_median", "log_confidence_gap",
           "pose_gap", "bf16_gap_ratio"}
TINY = dict(img_height=56, img_width=84, embed_dim=64, num_heads=4,
            dino_depth=2, aa_depth=2, pos_embed_grid=5, camera_trunk_depth=2,
            dpt_features=32, dpt_out_channels=[16, 32, 64, 64],
            dpt_layers=[0, 1, 1, 1])
FRAMES = 4
TOKENS = 5 + 4 * 6  # a frame's tokens at 56x84

# a port whose global blocks attend within each frame: a family beside
# the others, as a model_config change would add it
WITHIN_FRAMES = '''
import copy
from pathlib import Path

from portbench.harness.cell import load_module

_base = load_module(Path(__file__).with_name("vggt.py"))
structure, reference = _base.structure, _base.reference


def port(config, state, device):
    model = _base.port(config, state, device)
    p = {tokens}
    for blk in model.aggregator.global_blocks:
        def within(x, rope, forward=blk.forward):
            b, n, c = x.shape
            frame = copy.copy(rope)
            frame.cos, frame.sin = rope.cos[:p], rope.sin[:p]
            return forward(x.reshape(b * n // p, p, c), frame).reshape(
                b, n, c)
        blk.forward = within
    return model
'''


def _protocol():
    return load_module(ROOT / "portbench" / "protocols" / "mvs_scan.py")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout of the benchmark with VGGT at width 64 (2 + 2 blocks),
    frames resized to 56x84, scans of 4 views of 64x96, 2 scans."""
    root = tiny_checkout(tmp_path_factory.mktemp("vggt"))
    cfg_path = root / "portbench" / "configs" / "vggt_1b_dtu.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["model"].update(TINY)
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "portbench" / "traffic" / "mvs_scan.json"
    mix = json.loads(mix_path.read_text())
    mix["scene"].update(frames=FRAMES, focal=2892.33 * 96 / 1600)
    mix_path.write_text(json.dumps(mix))
    return root


def test_cell_runs_and_is_correct(root, run_cell):
    res = run_cell(root, CELL, trace=0)
    assert res["correct"] is True, res["checked"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"joint_targets_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["checked"]) == CHECKED
    # bf16 autocast against float32: a gap, and one under its limit
    assert 0 < res["checked"]["log_depth_gap"]["value"]
    before = counts()
    res = run_cell(root, CELL, trace=1)
    after = counts()
    assert res["correct"] is True, res["checked"]
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert CPU_METRICS <= set(got) <= NEW_METRICS
    grow = {k: after[k] - before.get(k, 0)
            for k in ("vggt.frames", "vggt.scans", "vggt.global_tokens")}
    assert grow["vggt.frames"] == FRAMES * grow["vggt.scans"] > 0
    assert grow["vggt.global_tokens"] == FRAMES * TOKENS * grow["vggt.scans"]
    # the counters are the process's: other files' VGGT runs in this
    # process add scans of other sizes
    assert got["global_tokens_per_request.vggt"] == (
        after["vggt.global_tokens"] / after["vggt.scans"])
    assert got["mfu.vggt"] > 0
    json.dumps(res)


def test_output_check_fails_on_global_blocks_within_frames(root, run_cell):
    pb = root / "portbench"
    (pb / "families" / "vggt_within_frames.py").write_text(
        WITHIN_FRAMES.replace("{tokens}", str(TOKENS)))
    cfg_path = pb / "configs" / "vggt_1b_dtu.json"
    cfg = json.loads(cfg_path.read_text())
    try:
        cfg_path.write_text(json.dumps(dict(cfg,
                                            family="vggt_within_frames")))
        res = run_cell(root, CELL, trace=0, seconds=1.0)
    finally:
        cfg_path.write_text(json.dumps(cfg))
    assert res["correct"] is False
    failed = {k for k, c in res["checked"].items()
              if not c["value"] <= c["limit"]}
    assert {"log_depth_gap", "pose_gap", "bf16_gap_ratio"} <= failed, res[
        "checked"]


def _config(root=None, **model) -> dict:
    base = ROOT if root is None else root
    cfg = json.loads((base / "portbench" / "configs"
                      / "vggt_1b_dtu.json").read_text())
    cfg["model"].update(model)
    cfg["family_file"] = str(ROOT / "portbench" / "families" / "vggt.py")
    return cfg


@pytest.mark.parametrize("model, match", [
    ({"compute_dtype": "float16"}, "compute_dtype"),
    ({"mlp_ratio": 2.0}, "mlp_ratio"),
    ({"stage_planes": [48, 32, 8]}, "stage_planes")])
def test_family_refuses_what_the_reference_does_not_compute(model, match):
    cfg = _config(**model)
    with pytest.raises(ValueError, match=match):
        models.weights(cfg, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        models.reference(cfg, {}, torch.device("cpu"))


def test_family_gives_port_and_reference_one_state(root):
    """LayerNorms at 1 and 0, every LayerScale at 1.0, the tokens from the
    seed: the same in both models, other tokens for another seed."""
    cfg = _config(root)
    cpu = torch.device("cpu")
    state = models.weights(cfg, SEED, cpu)
    ref = models.reference(cfg, state, cpu).state_dict()
    port = models.port(cfg, state, cpu).state_dict()
    assert set(ref) == set(port) > set(state)
    assert all(torch.equal(ref[k], port[k]) for k in ref)
    assert all(torch.equal(ref[k], state[k]) for k in state)
    assert torch.equal(ref["aggregator.global_blocks.1.ls2.gamma"],
                       torch.ones(64))
    assert torch.equal(ref["aggregator.frame_blocks.0.attn.k_norm.weight"],
                       torch.ones(16))
    token = "aggregator.camera_token"
    assert 0.3 < float(ref[token].std()) < 3.0
    other = models.reference(cfg, models.weights(cfg, SEED + 1, cpu),
                             cpu).state_dict()
    assert not torch.equal(other[token], ref[token])
    full = json.loads((ROOT / "portbench" / "configs"
                       / "vggt_1b_dtu.json").read_text())
    with torch.device("meta"):
        tree = models.family(_config()).structure(full)
    assert sum(p.numel() for p in tree.parameters()) == full["parameters"]


def test_protocol_requests_whole_scans_and_counts_their_views(root):
    cell = cells.load(root, CELL)
    proto = _protocol()
    scans = proto.Scans(cell, SEED, torch.device("cpu"))
    imgs, poses, intr = scans.request(proto.Request(3))
    assert imgs.shape == (1, FRAMES, 64, 96, 3) and imgs.dtype.name == "uint8"
    assert poses.shape == (1, FRAMES, 4, 4) and intr.shape == (1, 3, 3)
    assert (imgs == scans.request(proto.Request(1))[0]).all()
    assert not (imgs == scans.request(proto.Request(0))[0]).all()
    recs = [Rec("scan", FRAMES, 0.0, 0.0, 0.0)] * 3
    assert proto.Session.end_to_end(recs, 2.0) == {
        "joint_targets_per_s": 3 * FRAMES / 2.0}


def _outs(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"depth_logit": torch.randn(FRAMES, 6, 8, generator=gen),
            "confidence_logit": torch.randn(FRAMES, 6, 8, generator=gen),
            "pose_enc": torch.randn(FRAMES, 9, generator=gen)}


def test_compare_takes_the_largest_gaps_the_median_and_the_ratio():
    compare = _protocol().compare
    limits = {k: {"limit": 1.0} for k in CHECKED}
    got = [_outs(0), _outs(1)]
    want = [{k: v.clone() for k, v in o.items()} for o in got]
    want[1]["depth_logit"] += 1e-3
    want[1]["depth_logit"][2, 3, 4] += 0.5
    want[0]["confidence_logit"][0, 0, 0] -= 0.25
    want[0]["pose_enc"][3, 8] += 0.125
    # the bf16 reference's gaps: 1.0 in the depth, 0.5 in the confidence,
    # 0.25 in the pose
    low = [{k: v.clone() for k, v in o.items()} for o in want]
    low[0]["depth_logit"][0, 0, 0] += 1.0
    low[1]["confidence_logit"][1, 1, 1] += 0.5
    low[1]["pose_enc"][0, 0] -= 0.25
    numbers = {k: v for k, v, _ in compare(got, want, low, limits)}
    assert numbers["log_depth_gap"] == pytest.approx(0.501, rel=1e-4)
    # half the pixels (the first request's) read 0, the other half 1e-3
    assert numbers["log_depth_gap_median"] in (0.0, pytest.approx(1e-3))
    assert numbers["log_confidence_gap"] == pytest.approx(0.25)
    assert numbers["pose_gap"] == pytest.approx(0.125)
    assert numbers["bf16_gap_ratio"] == pytest.approx(
        (0.501 / 1.0 + 0.25 / 0.5 + 0.125 / 0.25) / 3, rel=1e-4)
    same = {k: v for k, v, _ in compare(got, got, low, limits)}
    assert same == dict.fromkeys(CHECKED, 0.0)
    # the control in the program's place reads 1 by construction
    assert {k: v for k, v, _ in compare(low, want, low, limits)}[
        "bf16_gap_ratio"] == pytest.approx(1.0)


def test_control_reads_every_number(root):
    """The bf16 control against the float32 reference at the tiny size:
    every number above 0 and finite."""
    cell = cells.load(root, CELL)
    control = _protocol().control_numbers(cell, SEED, torch.device("cpu"))
    assert set(control) == CHECKED
    assert all(0 < v < 10 for v in control.values()), control
    assert control["bf16_gap_ratio"] == pytest.approx(1.0)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    assert control["bf16_gap_ratio"] > limits["bf16_gap_ratio"]


def test_flops_count_the_reference_on_the_meta_device(root):
    """Session.flops counts the reference's matmuls and convolutions on
    the meta device: the count FlopCounterMode gives on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    cell = cells.load(root, CELL)
    proto = _protocol()
    session = object.__new__(proto.Session)
    session.cell = cell
    session.scans = proto.Scans(cell, SEED, torch.device("cpu"))
    got = session.flops(None)
    cpu = torch.device("cpu")
    ref = models.reference(cell.config, models.weights(cell.config, 1, cpu),
                           cpu)
    with FlopCounterMode(display=False) as fc:
        ref(torch.as_tensor(session.scans.request(proto.Request(0))[0]))
    assert got == {"scan": fc.get_total_flops()} and got["scan"] > 0


def test_attention_count_and_containment():
    """4 B heads N^2 64 a self-attention of 64-wide heads; only the
    attention ranges inside a global block's span count."""
    q = (1, 16, 49196, 64)
    assert attention.attention_ops((q, q, q)) == 4 * 16 * 49196 ** 2 * 64
    assert attention.attention_ops(((2, 4, 10, 32), (2, 4, 30, 32),
                                    (2, 4, 30, 16))) == 2 * 8 * 10 * 30 * 48
    op = attention.OP
    spans = [Span("estdepth::vggt_global", 10.0, 20.0, 900.0, (), False),
             Span(op, 12.0, 15.0, 100.0, (q, q, q), False),
             Span("estdepth::vggt_frame", 0.0, 9.0, 300.0, (), False),
             Span(op, 2.0, 4.0, 50.0, ((49, 16, 1004, 64),) * 3, False),
             Span("estdepth::vggt_global", 30.0, 40.0, 900.0, (), False),
             Span(op, 31.0, 35.0, 100.0, (q, q, q), False)]
    inside = attention.inside(spans, op, "estdepth::vggt_global")
    assert [s.start_us for s in inside] == [12.0, 31.0]
    r = readings("mvs_scan", spans, [FRAMES])
    want = 100 * 2 * attention.attention_ops((q, q, q)) / 989e12 / 200e-6
    assert reader("global_attention_roofline.vggt").read(r) == (
        pytest.approx(want))


def test_readers_of_the_new_spans_and_other_protocols():
    spans = [span(f"estdepth::vggt_{s}", ms, start=i)
             for i, (s, ms) in enumerate([("global", 800.0), ("frame", 80.0),
                                          ("patch_embed", 60.0),
                                          ("depth_head", 300.0)])]
    r = readings("mvs_scan", spans, [FRAMES, FRAMES], host=[FRAMES] * 3,
                 host_window_s=3.0)
    for name, ms in (("vggt_global_ms", 400.0), ("vggt_frame_ms", 40.0),
                     ("vggt_patch_embed_ms", 30.0),
                     ("vggt_depth_head_ms", 150.0)):
        assert reader(f"{name}.vggt").read(r) == pytest.approx(ms), name
    assert reader("global_attention_roofline.vggt").read(r) is None
    r.flops = {"steady": 347.6e12}
    r.host = [dataclasses.replace(x, kind="steady") for x in r.host]
    assert reader("mfu.vggt").read(r) == pytest.approx(
        100 * 3 * 347.6e12 / 3.0 / 989e12)
    for protocol in ("mvs_views", "mvs_views_wta", "joint_window"):
        r = readings(protocol, spans, [1], host=[1], host_window_s=0.5)
        r.flops = {"view": 1e12, "steady": 1e12}
        for name in NEW_METRICS:
            assert reader(name).read(r) is None, (name, protocol)


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(cuda_device):
    """At the cell's own size, on scans of 12 views: the reference cast
    to bfloat16 (the protocol's `control_numbers`) fails a limit; a run of
    the program on the same seed passes them."""
    cell = cells.load(ROOT, CELL)
    cell = dataclasses.replace(cell, mix=dict(
        cell.mix, scene=dict(cell.mix["scene"], frames=12)))
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    control = _protocol().control_numbers(cell, SEED, cuda_device)
    assert any(control[k] > limits[k] for k in limits), control
    res = load_run().run(argparse.Namespace(workload=CELL, seed=SEED,
                                            seconds=3.0, trace=0))
    assert res["correct"], res["checked"]


def test_within_frames_fault_family_is_a_copy_of_the_block():
    """The fault family's rope cut keeps a frame's positions: the first
    P rows of the global tables are frame 0's, as every frame's."""
    from estdepth_tpu_torch.models import vggt

    pos = vggt.positions(4, 6, 5, torch.device("cpu"))
    rope = vggt.Rope2D(pos.repeat(FRAMES, 1), 7, 16, 100.0)
    frame = copy.copy(rope)
    frame.cos = rope.cos[:TOKENS]
    assert torch.equal(frame.cos, vggt.Rope2D(pos, 7, 16, 100.0).cos)
    assert rope.cos.shape[0] == FRAMES * TOKENS
