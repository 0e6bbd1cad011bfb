"""Whole runs of every cell on the CPU at tiny sizes, on the port's plain
paths (the look for a card skipped), the reference against the port at a
small size, a configuration, mix and metric added by new files alone, and
the output check failing on each fault a cell can have."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

CELLS = ["psm.estm_stream", "psm.joint_window", "senet.joint_window",
         "psm.train_step"]
E2E = {"psm.estm_stream": {"stream_frame_ms", "stream_frame_ms_p95"},
       "psm.joint_window": {"joint_targets_per_s"},
       "senet.joint_window": {"joint_targets_per_s"},
       "psm.train_step": {"train_step_ms"}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, run_cell, cell, trace):
    res = run_cell(tiny_root, cell, trace=trace)
    assert res["correct"] is True, res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checked"
    names = set(res["metrics"])
    if trace:
        assert names and not names & (E2E[cell] | {"setup_s"})
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == E2E[cell] | {"setup_s"}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    json.dumps(res)


@pytest.mark.parametrize("feature_net", ["psm", "senet"])
def test_reference_follows_the_port(feature_net):
    """Four streamed windows (the first without EST, three with the
    memory) and a two-window Joint chain of the reference against the
    port's runners on the same weights, at 64x96 with 8 planes."""
    from estdepth_tpu_torch.eval.estm import ESTMRunner
    from estdepth_tpu_torch.tools.eval_joint import JointRunner
    from portbench.harness import models
    from portbench.harness.scenes import Path, make_scenes
    from portbench.reference.runners import joint_maps, stream_maps

    cpu = torch.device("cpu")
    cfg = {"model": {"ndepths": 8, "depth_min": 0.01, "depth_max": 10.0,
                     "resnet": 18, "feature_net": feature_net}}
    state = models.weights(cfg, 3, cpu)
    port, ref = models.port(cfg, state, cpu), models.reference(cfg, state,
                                                                cpu)
    scene = make_scenes(Path(height=64, width=96, frames=8), 1, 5, cpu)[0]
    runner = ESTMRunner(port, 64, 96, device="cpu")
    got = [runner.push_frame(f, p, scene.intr)
           for f, p in zip(scene.frames[:6], scene.poses[:6])][2:]
    want = stream_maps(ref, scene.frames[:6], scene.poses[:6], scene.intr,
                       (0, 1, 2, 3))
    for g, w in zip(got, want):
        torch.testing.assert_close(g[0], w, atol=1e-4, rtol=0)
    joint = JointRunner(port, device="cpu")
    wins = [(scene.frames[lo:lo + 5], scene.poses[lo:lo + 5])
            for lo in (0, 3)]
    got = [joint.run_window(f[None], p[None], scene.intr[None])[0][0]
           for f, p in wins]
    want = joint_maps(ref, wins, scene.intr, [0, 1, 2, 3])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


def test_reference_training_follows_the_port(tiny_root, run_cell):
    res = run_cell(tiny_root, "psm.train_step")
    assert res["checked"]["loss_gap"]["value"] < 1e-5
    assert res["checked"]["grad_gap"]["value"] < 1e-3


def test_new_configuration_mix_and_metric_are_files_alone(tmp_path,
                                                          run_cell):
    from portbench.tests.conftest import tiny_checkout

    root = tiny_checkout(tmp_path)
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pb / "configs" / "estdepth_psm_r50.json").read_text())
    cfg["model"]["ndepths"] = 6
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "estm_stream.json").read_text())
    mix["scene"]["frames"] = 9
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "layer_metrics" / "dummy_frames.stream.py").write_text(
        "def read(r):\n    return float(sum(x.delivered for x in r.host))\n")
    (pb / "limits" / "dummy.cell.json").write_text(
        (pb / "limits" / "psm.estm_stream.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "x",
                             "file": "portbench/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("stream_frame_ms"):
            m["workloads"].append("dummy.cell")
    bench["per_layer"].append({
        "name": "dummy_frames.stream", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "step driver",
        "moves": "stream_frame_ms", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "dummy.cell", trace=0)
    assert res["correct"] and "stream_frame_ms" in res["metrics"]
    res = run_cell(root, "dummy.cell", trace=1)
    assert res["metrics"]["dummy_frames.stream"]["value"] > 0
    assert "host_issue_ms.stream" not in res["metrics"]


def _altered(fn, where):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return where(out)
    return wrapped


def test_stream_faults_are_caught(tiny_root, run_cell, monkeypatch):
    from estdepth_tpu_torch.eval import estm
    from estdepth_tpu_torch.models.memory import ESTMemory

    with monkeypatch.context() as m:  # the memory never takes a frame
        m.setattr(ESTMemory, "push", lambda self, *a, **k: self)
        assert run_cell(tiny_root, "psm.estm_stream")["correct"] is False
    with monkeypatch.context() as m:  # a map altered where it is made
        m.setattr(estm, "trim_depth", _altered(
            estm.trim_depth, lambda d: d + (d > 5.0).float() * 0.05))
        assert run_cell(tiny_root, "psm.estm_stream")["correct"] is False


@pytest.mark.parametrize("cell", ["psm.joint_window", "senet.joint_window"])
def test_joint_faults_are_caught(tiny_root, run_cell, monkeypatch, cell):
    from estdepth_tpu_torch.tools import eval_joint

    with monkeypatch.context() as m:  # the window's state is never kept
        m.setattr(eval_joint, "ESTMemory", lambda **kw: None)
        assert run_cell(tiny_root, cell)["correct"] is False
    with monkeypatch.context() as m:  # one target's maps altered
        def alter(out):
            depth, probs = out
            depth = depth.clone()
            depth[:, 1] += 0.05
            return depth, probs
        m.setattr(eval_joint.JointRunner, "run_window", _altered(
            eval_joint.JointRunner.run_window, alter))
        assert run_cell(tiny_root, cell)["correct"] is False


def test_train_faults_are_caught(tiny_root, run_cell, monkeypatch):
    from estdepth_tpu_torch.train import trainer

    make = trainer.make_optimizer

    def frozen(*args, **kwargs):  # the optimizer never moves the state
        opt, sched = make(*args, **kwargs)
        opt.step = lambda *a, **k: None
        return opt, sched

    with monkeypatch.context() as m:
        m.setattr(trainer, "make_optimizer", frozen)
        res = run_cell(tiny_root, "psm.train_step")
        assert res["correct"] is False
        assert res["checked"]["change_gap"]["value"] == pytest.approx(1.0)
    with monkeypatch.context() as m:  # the loss altered where it is made
        m.setattr(trainer, "multi_scale_loss", _altered(
            trainer.multi_scale_loss,
            lambda out: (out[0] * 1.1, {**out[1], "loss": out[1]["loss"]
                                        * 1.1})))
        assert run_cell(tiny_root, "psm.train_step")["correct"] is False


def test_runs_of_one_seed_see_the_same_inputs():
    from portbench.harness.scenes import Path, make_scenes

    a = make_scenes(Path(height=64, width=96, frames=5), 2, 2**32 + 3, "cpu")
    b = make_scenes(Path(height=64, width=96, frames=5), 2, 2**32 + 3, "cpu")
    assert all(np.array_equal(x.frames, y.frames) for x, y in zip(a, b))
    c = make_scenes(Path(height=64, width=96, frames=5), 2, 7, "cpu")
    assert not np.array_equal(a[0].frames, c[0].frames)
