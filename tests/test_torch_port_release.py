"""The release tools of the port, on CPU: tools/export_torch.py (a
tools/train.py checkpoint as a reference .ckpt) and
tools/rehearse_release_ckpt.py (ckpt -> convert -> eval -> score).

At the tiny configuration (ResNet-18, D = 8, 64x96): a 2-step `train.py
--synthetic` run is exported; its .ckpt loads with
load_reference_checkpoint(strict=True) into the trained tensors, and
through the JAX package's load_torch_checkpoint into a JAX model whose
forward matches the port's at the full-forward tolerance 5e-3
(PARITY.md). The rehearsal runs end to end with a generated stand-in and
with that checkpoint on a written ScanNet scene, and its score_offline
means match the eval tool's within 2e-3 relative (float16 dumps).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, pose, write_scannet_scene,
)
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.tools import export_torch, rehearse_release_ckpt
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.tools.eval_estm import METRIC_KEYS
from estdepth_tpu_torch.utils.checkpoint import CheckpointManager
from estdepth_tpu_torch.utils.convert import load_reference_checkpoint
from test_torch_port_common import (  # noqa: F401
    H, W, ND, JAX_WARP_FLAGS, scene_arrays, one_torch_thread,
    training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")

TINY = ["--height", str(H), "--width", str(W), "--ndepths", str(ND),
        "--resnet", "18"]
DEPTH_MIN, DEPTH_MAX = 0.01, 10.0  # the train tool's defaults


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint directory of a 2-step train.py run that saved both
    steps, the .ckpt export_torch wrote of its latest step)."""
    logdir = tmp_path_factory.mktemp("train")
    train_tool.run(train_tool.parse_args([
        "--synthetic", "--device", "cpu", "--n-frames", "3", "--steps", "2",
        "--ckpt-steps", "1", "--summary-freq", "1", "--logdir", str(logdir),
        *TINY]))
    out = str(logdir / "model.ckpt")
    res = export_torch.main(["--ckpt", str(logdir / "ckpt"), "--out", out])
    assert res == {"step": 2, "tensors": len(_train_state(logdir / "ckpt",
                                                          2))}
    return str(logdir / "ckpt"), out


def _train_state(ckpt_dir, step) -> dict:
    return torch.load(CheckpointManager(str(ckpt_dir)).path(step),
                      weights_only=True)["model"]


def _port_model(state) -> DepthNetHybrid:
    model = DepthNetHybrid(ModelConfig(ndepths=ND, depth_min=DEPTH_MIN,
                                       depth_max=DEPTH_MAX, resnet=18))
    model.load_state_dict(state, strict=True)
    return model


def test_export_torch_writes_the_reference_layout(trained):
    ckpt_dir, out = trained
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {"epoch", "model"} and blob["epoch"] == 2
    state, unmatched = load_reference_checkpoint(out, strict=True)
    assert unmatched == []
    trained_state = _train_state(ckpt_dir, 2)
    assert set(state) == {k for k in trained_state
                          if not k.endswith("num_batches_tracked")}
    for k, v in state.items():
        assert torch.equal(v, trained_state[k]), k
    _port_model(state)  # loads strictly


def test_export_torch_takes_a_step(trained, tmp_path):
    ckpt_dir, _ = trained
    out = str(tmp_path / "step1.ckpt")
    assert export_torch.main(["--ckpt", ckpt_dir, "--out", out, "--step",
                              "1"])["step"] == 1
    state = load_reference_checkpoint(out)[0]
    step1, step2 = _train_state(ckpt_dir, 1), _train_state(ckpt_dir, 2)
    assert all(torch.equal(v, step1[k]) for k, v in state.items())
    assert any(not torch.equal(v, step2[k]) for k, v in state.items())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_torch.export(str(tmp_path / "empty"), out)


def test_exported_checkpoint_runs_in_the_jax_model(trained):
    """The .ckpt through the JAX package's converter: the first window
    without EST, then a window fusing the first one's state, against the
    port's model with the same file's weights."""
    from estdepth_tpu.models import DepthNetHybrid as JaxModel
    from estdepth_tpu.models import ESTMemory as JaxMemory
    from estdepth_tpu.utils.convert import load_torch_checkpoint

    _, out = trained
    variables, unmatched = load_torch_checkpoint(out, strict=True)
    assert unmatched == []
    jm = JaxModel(ndepths=ND, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
                  resnet=18, est_transformer=True,
                  **JAX_WARP_FLAGS["plane_mix_exact_z"])
    tm = _port_model(load_reference_checkpoint(out)[0])
    imgs, poses, intr = scene_arrays(4)
    windows = [(imgs[None, s:s + 3], poses[None, s:s + 3], intr[None])
               for s in (0, 1)]
    jmem = JaxMemory.create(1, 2, ND, H // 4, W // 4)
    tmem = ESTMemory.create(1, 2, ND, H // 4, W // 4)
    for wi, window in enumerate(windows):
        want, (jk, jv, jp) = jm.apply(
            variables, *map(jnp.asarray, window),
            memory=jmem if wi else None, use_est=bool(wi), train=False)
        with torch.inference_mode():
            got, (tk, tv, tp) = tm(*map(torch.from_numpy, window),
                                   memory=tmem if wi else None,
                                   use_est=bool(wi))
        for k in ("depth", "init_prob", "fused_prob"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=5e-3, rtol=0.0, err_msg=k)
        jmem, tmem = jmem.push(jk, jv, jp), tmem.push(tk, tv, tp)


def _check_scores(summary):
    """score_offline's means against the eval tool's, over the float16
    dumps."""
    for k in METRIC_KEYS:
        assert summary["score"][k] == pytest.approx(
            summary["eval"]["metrics"][k], rel=2e-3), k


def test_rehearsal_with_a_generated_stand_in(tmp_path, capsys):
    outdir = str(tmp_path / "rehearsal")
    summary = rehearse_release_ckpt.main([
        "--outdir", outdir, "--max-frames", "6", "--device", "cpu", *TINY])
    assert "RELEASE REHEARSAL: PASS" in capsys.readouterr().out
    blob = torch.load(summary["ckpt"]["path"], weights_only=True)
    assert set(blob) == {"epoch", "model", "optimizer"}
    assert all(k.startswith("module.") for k in blob["model"])
    assert summary["ckpt"]["generated"]
    assert summary["convert"]["torch_keys_unmatched"] == 0
    assert summary["convert"]["model_tensors_missing"] == []
    assert summary["eval"]["frames"] == 12  # 2 synthetic scenes of 6
    _check_scores(summary)
    # the stand-in is the seeded model, written unchanged
    state = load_reference_checkpoint(summary["ckpt"]["path"])[0]
    seeded = DepthNetHybrid(ModelConfig(ndepths=ND, resnet=18), seed=0)
    assert all(torch.equal(v, state[k])
               for k, v in seeded.state_dict().items() if k in state)


def test_rehearsal_with_the_trained_checkpoint_on_a_scannet_scene(
        trained, tmp_path):
    """The flow of a release: the exported training checkpoint through
    the eval tool on a scene in ScanNet's layout (every second frame, one
    pose not finite), then score_offline."""
    cfg = SyntheticSceneConfig(height=96, width=128, focal=86.7)
    poses = [pose(cfg, i) for i in range(14)]
    poses[4][:3, 3] = np.nan
    write_scannet_scene(str(tmp_path / "data" / "scene0000_00"), cfg, poses)
    summary = rehearse_release_ckpt.main([
        "--ckpt", trained[1], "--datapath", str(tmp_path / "data"),
        "--frame-interval", "2", "--depth-min", str(DEPTH_MIN),
        "--depth-max", str(DEPTH_MAX), "--outdir", str(tmp_path / "out"),
        "--device", "cpu", *TINY])
    assert not summary["ckpt"]["generated"]
    assert summary["convert"]["tensors"] > 0
    # 6 of the 7 sampled frames have a finite pose: 4 windows of 3
    assert summary["eval"]["frames"] == 4
    assert sorted(os.listdir(tmp_path / "out" / "maps"))[0].startswith(
        "scene0000_00_000001_")
    _check_scores(summary)


def test_rehearsal_fails_on_a_name_it_cannot_place(tmp_path, capsys):
    model = DepthNetHybrid(ModelConfig(ndepths=ND, resnet=18), seed=0)
    ckpt = str(tmp_path / "bad.ckpt")
    torch.save({"epoch": 0, "model": {**model.state_dict(),
                                      "module.extra.weight": torch.ones(1)}},
               ckpt)
    with pytest.raises(SystemExit) as exc:
        rehearse_release_ckpt.main([
            "--ckpt", ckpt, "--outdir", str(tmp_path / "out"),
            "--max-frames", "1", "--device", "cpu", *TINY])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "module.extra.weight" in out and "RELEASE REHEARSAL: FAIL" in out
