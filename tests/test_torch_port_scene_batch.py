"""`--scan --scene-batch` on the port's two eval tools, on CPU.

Four scenes in ScanNet's layout, rendered at a small size from seeded
textures along the pitched camera path of tests/test_torch_port_common.py
(no warp coordinate on the image border) and cut to unequal lengths; the
first has a non-finite pose. The ESTM tool takes the three without the
gap, the Joint tool all four: the gap scene's window chain is not a
gapless grid, so it takes the window loop and stays out of the groups.
At --scene-batch 2 both tools make a full group of two scenes and a
partial last group of one.

Held: the maps at --scene-batch 2 equal --scene-batch 1's within 1e-5
(eval-mode BatchNorm never mixes the batch axis); and the JAX tools,
tools/eval_estm.py and tools/eval_joint.py at --scan --scene-batch 2, run
whole in this process on the same files and a reference checkpoint of
the same weights, give maps within the chain tolerance 8e-3.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.models import DepthNetHybrid as JaxModel
from estdepth_tpu.utils.convert import export_state_dict
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, pose, write_scannet_scene,
)
from estdepth_tpu_torch.tools import eval_estm, eval_joint
from test_torch_port_common import (  # noqa: F401
    DMAX, DMIN, H, JAX_WARP_FLAGS, ND, W, one_torch_thread, pitch,
    random_variables, scene_arrays,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# scene name -> frames; the first has a non-finite pose at frame 4
SCENES = {"scene0000_00": 12, "scene0001_00": 9, "scene0002_00": 12,
          "scene0003_00": 7}
GAP_SCENE, GAP_FRAME = "scene0000_00", 4
FLAGS = ["--eval-dataset", "scannet", "--height", str(H), "--width", str(W),
         "--ndepths", str(ND), "--resnet", "18", "--frame-interval", "1",
         "--depth-min", str(DMIN), "--depth-max", str(DMAX), "--scan"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The four scenes, a test list without the gap scene, and a
    reference-format checkpoint of random JAX weights."""
    root = tmp_path_factory.mktemp("scenes")
    for seed, (name, n) in enumerate(SCENES.items()):
        cfg = SyntheticSceneConfig(height=96, width=128, focal=115.574,
                                   seed=seed)
        poses = []
        for i in range(n):
            p = pose(cfg, i) @ pitch(0.013 * i + 0.002)
            p[1, 3] += 0.011 * i
            poses.append(p.astype(np.float32))
        if name == GAP_SCENE:
            poses[GAP_FRAME] = np.full((4, 4), np.inf, np.float32)
        write_scannet_scene(str(root / name), cfg, poses)
    testlist = root.parent / "no_gap.txt"
    testlist.write_text("".join(f"{s}\n" for s in SCENES if s != GAP_SCENE))
    jm = JaxModel(ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
                  est_transformer=True, **JAX_WARP_FLAGS["plane_mix_exact_z"])
    imgs, poses, intr = scene_arrays(3)
    variables = random_variables(lambda: jm.init(
        jax.random.key(0), jnp.asarray(imgs[None]), jnp.asarray(poses[None]),
        jnp.asarray(intr[None]), train=False))
    state = {f"module.{k}": torch.from_numpy(np.array(v))
             for k, v in export_state_dict(variables).items()}
    ckpt = str(root.parent / "model.ckpt")
    torch.save({"epoch": 1, "model": state}, ckpt)
    return {"root": str(root), "testlist": str(testlist), "ckpt": ckpt}


def _port(tool, argv, batch):
    """The tool's result at --scene-batch `batch`, and what it printed."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = tool.run(tool.parse_args(argv + ["--scene-batch", str(batch),
                                               "--device", "cpu"]),
                       keep_maps=True)
    return res, printed.getvalue()


def _jax_tool(name: str, argv: list, monkeypatch) -> np.ndarray:
    """tools/<name>.py's main in this process; the refined float32 maps it
    scored, in order."""
    monkeypatch.setenv("ESTDEPTH_NO_COMPILE_CACHE", "1")
    tool = importlib.import_module(f"tools.{name}")
    jax_estm = importlib.import_module("tools.eval_estm")
    scored, real = [], jax_estm.score

    def spy(pred, gt, mask):
        scored.append(np.array(pred, np.float32))
        return real(pred, gt, mask)

    monkeypatch.setattr(jax_estm, "score", spy)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    tool.main()
    return np.stack(scored)


@pytest.fixture(scope="module")
def estm_runs(data):
    """The ESTM tool over the three scenes at --scene-batch 1 and 2: each
    run's result and what it printed."""
    argv = ["--datapath", data["root"], "--testlist", data["testlist"],
            "--ckpt", data["ckpt"], *FLAGS]
    return {b: _port(eval_estm, argv, b) for b in (1, 2)}


def test_estm_scene_batch_equals_one_scene_at_a_time(estm_runs):
    """Scenes of 9, 12 and 7 frames: 7 + 10 + 5 windows, a group of two
    and a partial group of one; the group's time is spread over its
    frames."""
    one, two = estm_runs[1][0], estm_runs[2][0]
    n = sum(SCENES[s] - 2 for s in SCENES if s != GAP_SCENE)
    assert len(one["maps"]) == len(two["maps"]) == n
    np.testing.assert_allclose(np.stack(two["maps"]), np.stack(one["maps"]),
                               atol=1e-5, rtol=0)
    assert len(two["errors"]) == n
    assert len(set(two["times"][:17])) == 1  # one group: its mean time


def test_estm_scene_batch_prints_the_groups(estm_runs):
    printed = estm_runs[2][1]
    assert "scene0001_00: 7 windows (scan batch of 2)" in printed
    assert "scene0002_00: 10 windows (scan batch of 2)" in printed
    assert "scene0003_00: 5 windows (scan batch of 1)" in printed


def test_estm_scene_batch_matches_jax(data, estm_runs, monkeypatch):
    want = _jax_tool("eval_estm", [
        "--datapath", data["root"], "--testlist", data["testlist"],
        "--ckpt", data["ckpt"], *FLAGS, "--scene-batch", "2"], monkeypatch)
    got = np.stack([m[0] for m in estm_runs[2][0]["maps"]])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)


@pytest.fixture(scope="module")
def joint_runs(data):
    argv = ["--datapath", data["root"], "--ckpt", data["ckpt"], *FLAGS]
    return {b: _port(eval_joint, argv, b) for b in (1, 2)}


def _windows(n):
    return len(range(0, n - 5, 3))


SCAN_WINDOWS = sum(_windows(SCENES[s]) for s in SCENES if s != GAP_SCENE)


def test_joint_scene_batch_equals_one_scene_at_a_time(joint_runs):
    """The gap scene through the loop (the windows holding the non-finite
    pose are skipped by the dataset), then 2 + 3 windows in a group of
    two and 1 in a partial group, 3 targets each. Within 1e-5 relative
    (and 1e-5 absolute): the CPU's 1x1 convolutions of the pyramid
    branches ([N, 128, 1, 1], one GEMM over the batch) round differently
    in the last bit when N changes, and the EST chain carries that to
    1.7e-5 absolute at a depth of 1.8 m (9.6e-6 relative) in 6 of 258048
    values."""
    one, two = joint_runs[1][0], joint_runs[2][0]
    assert len(one["maps"]) == len(two["maps"])
    np.testing.assert_allclose(np.stack(two["maps"]), np.stack(one["maps"]),
                               atol=1e-5, rtol=1e-5)
    assert len(two["maps"]) > SCAN_WINDOWS
    assert len(two["errors"]) == 3 * len(two["maps"])


def test_joint_gap_scene_takes_the_loop(joint_runs):
    """The gap scene runs through the window loop and joins no group: a
    group of two, then a partial group of one."""
    printed = joint_runs[2][1]
    assert (f"{GAP_SCENE}: window chain is not a gapless grid; loop "
            "fallback") in printed
    n2 = 3 * (_windows(SCENES["scene0001_00"])
              + _windows(SCENES["scene0002_00"]))
    assert f"scan group of 2: {n2} target frames" in printed
    assert (f"scan group of 1: {3 * _windows(SCENES['scene0003_00'])} "
            "target frames") in printed
    assert "scan group of 3" not in printed


def test_joint_scene_batch_matches_jax(data, joint_runs, monkeypatch):
    """The three gapless scenes (the gap scene's loop is the port's and
    JAX's window step, held by tests/test_torch_port_joint.py): the
    port's groups are the last windows of its run."""
    want = _jax_tool("eval_joint", [
        "--datapath", data["root"], "--testlist", data["testlist"],
        "--ckpt", data["ckpt"], *FLAGS, "--scene-batch", "2"], monkeypatch)
    got = np.concatenate([m[:, 0] for m in
                          joint_runs[2][0]["maps"][-SCAN_WINDOWS:]])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)
