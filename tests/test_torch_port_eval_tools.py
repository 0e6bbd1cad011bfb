"""The port's eval tools against the JAX package's, at the tiny size.

  * eval/metric_offline.py equals the JAX module to 1e-12 and
    eval/metrics.depth_metrics the jnp one to 1e-6;
  * utils/convert.load_reference_checkpoint loads a reference-format
    checkpoint (a JAX model's export_state_dict under `module.`, with a
    ResNet `fc.` head and BatchNorm's num_batches_tracked) strictly, and
    the model it gives matches the JAX package's load_torch_checkpoint +
    model on the same frames at the full-forward tolerance 5e-3;
  * tools/eval_estm.py and tools/eval_joint.py on a fake ScanNet scene
    with that checkpoint: the port's float32 maps lie within the chain
    tolerance 8e-3 of the JAX tools' (run whole, in this process, their
    maps read where they score them) and the saved float16 files within
    1e-2; --keyframe-list, --reference-layout and --scan run, and --ckpt
    takes a checkpoint directory of tools/train.py;
  * tools/score_offline.py --json and tools/export_pointcloud.py equal
    the JAX tools' on the same dumps (1e-6).
"""

from __future__ import annotations

import glob
import importlib
import json
import math
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.eval import metric_offline as jax_metric_offline
from estdepth_tpu.eval.metrics import depth_metrics as jax_depth_metrics
from estdepth_tpu.models import DepthNetHybrid as JaxModel
from estdepth_tpu.utils.convert import export_state_dict, load_torch_checkpoint
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, pose, render,
)
from estdepth_tpu_torch.eval import metric_offline
from estdepth_tpu_torch.eval.metrics import depth_metrics
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.tools import (
    eval_estm, eval_joint, export_pointcloud, score_offline,
)
from estdepth_tpu_torch.utils.convert import load_reference_checkpoint
from test_torch_port_common import (
    DMAX, DMIN, H, ND, W, JAX_WARP_FLAGS, pitch, random_variables,
    scene_arrays,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCENE, FRAMES = "scene0000_00", 9
FLAGS = ["--eval-dataset", "scannet", "--save-maps", "--height", str(H),
         "--width", str(W), "--ndepths", str(ND), "--resnet", "18",
         "--frame-interval", "1", "--depth-min", str(DMIN), "--depth-max",
         str(DMAX)]


def _scene_poses(n):
    """The synthetic camera path with a small pitch and lift (see
    test_torch_port_common: no warp coordinate lands on the border)."""
    cfg = SyntheticSceneConfig(height=480, width=640, focal=577.87)
    out = []
    for i in range(n):
        p = pose(cfg, i) @ pitch(0.013 * i + 0.002)
        p[1, 3] += 0.011 * i
        out.append(p.astype(np.float32))
    return cfg, out


def _write_scene(folder, n, ext=".png", cfg=None):
    """A ScanNet-layout scene written with OpenCV (frames rendered at
    ScanNet's 640x480 and focal unless `cfg` is smaller)."""
    base_cfg, poses = _scene_poses(n)
    cfg = cfg or base_cfg
    for sub in ("rgb", "depth", "pose"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i, p in enumerate(poses):
        rgb, depth = render(cfg, p)
        cv2.imwrite(os.path.join(folder, "rgb", f"{i}{ext}"),
                    rgb.astype(np.uint8)[..., ::-1])
        cv2.imwrite(os.path.join(folder, "depth", f"{i}.png"),
                    np.rint(depth * 1000).astype(np.uint16))
        np.savetxt(os.path.join(folder, "pose", f"{i}.txt"), p)


def _jax_model():
    return JaxModel(ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
                    est_transformer=True,
                    **JAX_WARP_FLAGS["plane_mix_exact_z"])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 9-frame ScanNet scene, a 46-frame JPEG scene for keyframe
    windows, and a reference-format checkpoint of random JAX weights."""
    root = tmp_path_factory.mktemp("scannet")
    _write_scene(str(root / SCENE), FRAMES)
    small = SyntheticSceneConfig(height=96, width=128, focal=115.574)
    keyframes = tmp_path_factory.mktemp("keyframes")
    _write_scene(str(keyframes / "scene_kf"), 46, ".jpg", small)
    keyframe_list = keyframes / "list.txt"
    keyframe_list.write_text("scene_kf 5\n")
    jm = _jax_model()
    imgs, poses, intr = scene_arrays(3)
    variables = random_variables(lambda: jm.init(
        jax.random.key(0), jnp.asarray(imgs[None]), jnp.asarray(poses[None]),
        jnp.asarray(intr[None]), train=False))
    state = {f"module.{k}": torch.from_numpy(np.array(v))
             for k, v in export_state_dict(variables).items()}
    for k in list(state):
        if k.endswith("running_var"):
            state[k[:-len("running_var")] + "num_batches_tracked"] = (
                torch.tensor(7))
    state["module.semanticFeature.encoder.fc.weight"] = torch.zeros(10, 512)
    state["module.semanticFeature.encoder.fc.bias"] = torch.zeros(10)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    torch.save({"epoch": 3, "model": state}, ckpt)
    return {"root": str(root), "ckpt": ckpt, "variables": variables,
            "keyframes": (str(keyframes), str(keyframe_list))}


# ---------------------------------------------------------------- metrics

def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
    elif isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, tol)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == pytest.approx(want, rel=tol, abs=tol)


def _metric_inputs():
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.1, 7.0, (48, 64)).astype(np.float32)
    gt[:5] = 0.0
    gt[-2:, :7] = np.nan
    pred = (gt * rng.uniform(0.7, 1.3, gt.shape)).astype(np.float32)
    pred[10:12] = -1.0
    return pred, gt


METRIC_CASES = {
    "compute_errors": lambda m, p, g: m.compute_errors(p, g),
    "compute_errors_range": lambda m, p, g: m.compute_errors(
        p, g, ("rmse", "ratio_threshold_1.25"), 0.5, 4.0),
    "compute_errors_empty": lambda m, p, g: m.compute_errors(p, g * 100),
    "valid_depth_mask": lambda m, p, g: m.valid_depth_mask(g, p).tolist(),
    "scale_abs": lambda m, p, g: m.evaluate_depth_metric(g, p, None, "abs"),
    "scale_log": lambda m, p, g: m.evaluate_depth_metric(g, p, None, "log"),
    "scale_inv": lambda m, p, g: m.evaluate_depth_metric(g, p, None, "inv"),
    "evaluate_depth": lambda m, p, g: m.evaluate_depth(
        np.array([0.3, 0.1, 0.2]), g, p),
    "evaluate_depth_metric_log": lambda m, p, g: m.evaluate_depth(
        np.array([1.0, 0.0, 0.0]), g, p, inverse_gt=False,
        inverse_pred=False, depth_scaling="log"),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_offline_matches_jax(case):
    pred, gt = _metric_inputs()
    fn = METRIC_CASES[case]
    _close(fn(metric_offline, pred, gt), fn(jax_metric_offline, pred, gt),
           1e-12)


def test_depth_metrics_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.uniform(0.2, 6.0, (2, 3, 4, 8, 10)).astype(np.float32)
    pred[0, 1, :, 2] = -0.5  # non-positive predictions are masked
    gt = rng.uniform(0.3, 5.0, (2, 3, 8, 10)).astype(np.float32)
    mask = rng.uniform(size=gt.shape) > 0.3
    mask[1, 2] = False  # a target with no valid pixel
    want = jax_depth_metrics(jnp.asarray(pred), jnp.asarray(gt),
                             jnp.asarray(mask), scales=(0, 1, 3))
    got = depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                        torch.from_numpy(mask), scales=(0, 1, 3))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------- checkpoint

def test_load_reference_checkpoint_matches_jax(data, tmp_path):
    state, unmatched = load_reference_checkpoint(data["ckpt"])
    assert unmatched == []
    assert not any(k.startswith("module.") or "fc." in k
                   or k.endswith("num_batches_tracked") for k in state)
    model = DepthNetHybrid(ModelConfig(ndepths=ND, depth_min=DMIN,
                                       depth_max=DMAX, resnet=18))
    model.load_state_dict(state, strict=True)
    variables, _ = load_torch_checkpoint(data["ckpt"])
    imgs, poses, intr = scene_arrays(3)
    want = jax.jit(lambda v, *a: _jax_model().apply(v, *a, train=False))(
        variables, *(jnp.asarray(a[None]) for a in (imgs, poses, intr)))[0]
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a[None])
                      for a in (imgs, poses, intr)))[0]
    for k in ("depth", "init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-3, rtol=0, err_msg=k)

    bad = str(tmp_path / "bad.ckpt")
    torch.save({"model": {**state, "module.decoder.extra.weight":
                          torch.zeros(1)}}, bad)
    with pytest.raises(KeyError, match=r"unmatched torch keys \(1\)"):
        load_reference_checkpoint(bad)
    assert load_reference_checkpoint(bad, strict=False)[1] == [
        "module.decoder.extra.weight"]


# --------------------------------------------------------------- eval tools

def _jax_tool(name: str, argv: list, monkeypatch) -> np.ndarray:
    """Run tools/<name>.py's main in this process; returns the refined
    float32 maps it scored, in order."""
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


def _same_dumps(got_dir, want_dir, n):
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(want_dir, "*.npy")))
    assert len(names) == n
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(got_dir, "*.npy")))
    for name in names:
        got = np.load(os.path.join(got_dir, name))
        want = np.load(os.path.join(want_dir, name))
        assert got.dtype == want.dtype == np.float16, name
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=1e-2,
                                   rtol=0, err_msg=name)


def test_eval_estm_dataset_matches_jax(data, tmp_path, monkeypatch, capsys):
    argv = ["--datapath", data["root"], "--ckpt", data["ckpt"], *FLAGS]
    want = _jax_tool("eval_estm", argv + ["--outdir", str(tmp_path / "jax"),
                                          "--testlist", _testlist(tmp_path)],
                     monkeypatch)
    res = eval_estm.run(eval_estm.parse_args(
        argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]),
        keep_maps=True)
    got = np.stack([m[0] for m in res["maps"]])
    assert got.shape == want.shape == (FRAMES - 2, H, W)
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)
    _same_dumps(str(tmp_path / "port"), str(tmp_path / "jax"),
                2 * (FRAMES - 2))
    assert len(glob.glob(str(tmp_path / "port" / "*_depth.jpg"))) == 7

    # the dump rescored offline agrees with the tool's own means within
    # the float16 rounding of the saved maps
    scores = score_offline.main([
        "--preddir", str(tmp_path / "port"), "--datapath", data["root"],
        "--height", str(H), "--width", str(W), "--frame-interval", "1",
        "--json", str(tmp_path / "scores.json")])
    assert scores["overall"]["frames"] == FRAMES - 2
    for k in ("abs_relative", "rmse"):
        tool_mean = np.mean([e[k] for e in res["errors"]])
        assert scores["overall"][k] == pytest.approx(tool_mean, rel=2e-3)

    # resume: a second run skips the scene
    capsys.readouterr()
    eval_estm.main(argv + ["--outdir", str(tmp_path / "port"), "--device",
                           "cpu"])
    assert "outputs exist, skipping" in capsys.readouterr().out


def _testlist(tmp_path):
    path = tmp_path / "test.txt"
    path.write_text(f"{SCENE}\n")
    return str(path)


def test_eval_estm_reference_layout_and_scan(data, tmp_path, capsys):
    """--reference-layout writes the reference's tree, whose refined maps
    equal the flat dump's; --scan gives the streaming maps."""
    argv = ["--datapath", data["root"], "--ckpt", data["ckpt"], *FLAGS,
            "--testlist", _testlist(tmp_path), "--device", "cpu"]
    stream = eval_estm.run(eval_estm.parse_args(
        argv + ["--outdir", str(tmp_path / "flat")]), keep_maps=True)
    scan = eval_estm.run(eval_estm.parse_args(argv + ["--scan", "--chunk",
                                                      "4"]), keep_maps=True)
    np.testing.assert_allclose(np.stack(scan["maps"]),
                               np.stack(stream["maps"]), atol=1e-5)
    eval_estm.main([a for a in argv if a != "--save-maps"] + [
        "--reference-layout", "--outdir", str(tmp_path / "ref")])
    assert "metrics:" in capsys.readouterr().out
    for kind in ("init_depth", "refined_depth", "init_prob",
                 "refined_prob"):
        assert len(glob.glob(str(tmp_path / "ref" / SCENE / kind /
                                 "*.npy"))) == FRAMES - 2
    for idx in range(1, FRAMES - 1):
        ref = np.load(tmp_path / "ref" / SCENE / "refined_depth"
                      / f"{idx:06d}.npy")
        flat = np.load(tmp_path / "flat" / f"{SCENE}_{idx:06d}_depth.npy")
        np.testing.assert_array_equal(ref, flat)


def test_eval_estm_takes_a_train_checkpoint_directory(data, tmp_path):
    """--ckpt as a checkpoint directory of tools/train.py: its latest
    step's weights give the maps of the reference file holding them."""
    from estdepth_tpu_torch.tools import train as train_tool
    from estdepth_tpu_torch.utils.checkpoint import CheckpointManager

    targs = train_tool.parse_args([
        "--synthetic", "--height", str(H), "--width", str(W), "--ndepths",
        str(ND), "--resnet", "18", "--depth-min", str(DMIN), "--depth-max",
        str(DMAX)])
    state = train_tool.build(targs, "cpu")[0]
    state.model.load_state_dict(load_reference_checkpoint(data["ckpt"])[0])
    CheckpointManager(str(tmp_path / "ckpt")).save(3, state)
    argv = ["--datapath", data["root"], *FLAGS, "--device", "cpu",
            "--max-frames", "3"]
    want = eval_estm.run(eval_estm.parse_args(
        argv + ["--ckpt", data["ckpt"]]), keep_maps=True)
    got = eval_estm.run(eval_estm.parse_args(
        argv + ["--ckpt", str(tmp_path / "ckpt")]), keep_maps=True)
    assert len(got["maps"]) == 3
    np.testing.assert_array_equal(np.stack(got["maps"]),
                                  np.stack(want["maps"]))


def test_eval_joint_dataset_matches_jax(data, tmp_path, monkeypatch):
    argv = ["--datapath", data["root"], "--ckpt", data["ckpt"], *FLAGS,
            "--save-probs"]
    want = _jax_tool("eval_joint", argv + ["--outdir", str(tmp_path / "jax")],
                     monkeypatch)
    res = eval_joint.run(eval_joint.parse_args(
        argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]),
        keep_maps=True)
    got = np.concatenate([m[:, 0] for m in res["maps"]])
    windows = len(range(0, FRAMES - 5, 3))
    assert got.shape == want.shape == (3 * windows, H, W)
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)
    # per target: depth, init, init_prob, refined_prob
    _same_dumps(str(tmp_path / "port"), str(tmp_path / "jax"),
                4 * 3 * windows)


def test_eval_joint_keyframe_list_and_scan(data, tmp_path, capsys):
    root, keyframe_list = data["keyframes"]
    eval_joint.main(["--datapath", root, "--keyframe-list", keyframe_list,
                     "--ckpt", data["ckpt"], *FLAGS, "--save-probs",
                     "--outdir", str(tmp_path / "kf"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "keyframes: 1 windows" in out and "metrics:" in out
    assert len(glob.glob(str(tmp_path / "kf" / "scene_kf_5_0000_*.npy"))
               ) == 3 * 4
    argv = ["--datapath", data["root"], "--ckpt", data["ckpt"], *FLAGS,
            "--device", "cpu"]
    loop = eval_joint.run(eval_joint.parse_args(argv), keep_maps=True)
    scan = eval_joint.run(eval_joint.parse_args(argv + ["--scan"]),
                          keep_maps=True)
    np.testing.assert_allclose(np.stack(scan["maps"]),
                               np.stack(loop["maps"]), atol=1e-5)


# --------------------------------------------------------- offline tools

@pytest.fixture(scope="module")
def dumps(data, tmp_path_factory):
    """Perturbed ground truth at the model's resolution as float16 dumps
    of the ESTM stream, in the flat and the reference layout."""
    out = {}
    rng = np.random.default_rng(5)
    for layout in ("flat", "reference"):
        d = tmp_path_factory.mktemp(layout)
        for idx in range(FRAMES):
            gt = cv2.imread(os.path.join(data["root"], SCENE, "depth",
                                         f"{idx}.png"), cv2.IMREAD_ANYDEPTH)
            pred = cv2.resize(gt.astype(np.float32) / 1000.0, (W, H))
            pred *= rng.uniform(0.9, 1.1, pred.shape).astype(np.float32)
            for which, p in (("refined", pred), ("init", pred * 1.02)):
                if layout == "flat":
                    tag = "depth" if which == "refined" else "init"
                    path = d / f"{SCENE}_{idx:06d}_{tag}.npy"
                else:
                    path = d / SCENE / f"{which}_depth" / f"{idx:06d}.npy"
                    path.parent.mkdir(parents=True, exist_ok=True)
                np.save(path, p.astype(np.float16))
        out[layout] = str(d)
    return out


@pytest.mark.parametrize("layout", ["flat", "reference"])
@pytest.mark.parametrize("extra", [[], ["--scale-align", "log"],
                                   ["--inverse"],
                                   ["--inverse", "--scale-align", "log",
                                    "--which", "init"]])
def test_score_offline_matches_jax(data, dumps, tmp_path, monkeypatch,
                                   layout, extra):
    argv = ["--preddir", dumps[layout], "--datapath", data["root"],
            "--height", str(H), "--width", str(W), "--frame-interval", "1",
            *extra]
    score_offline.main(argv + ["--json", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["score_offline.py", *argv, "--json",
                                      str(tmp_path / "jax.json")])
    importlib.import_module("tools.score_offline").main()
    got, want = (json.loads((tmp_path / f"{n}.json").read_text())
                 for n in ("port", "jax"))
    assert want["overall"]["frames"] > 0
    _close(got["overall"], want["overall"], 1e-6)
    _close(got["per_scene"], want["per_scene"], 1e-6)


def test_export_pointcloud_matches_jax(data, dumps, tmp_path, monkeypatch):
    argv = ["--preddir", dumps["flat"], "--datapath", data["root"],
            "--scene", SCENE, "--height", str(H), "--width", str(W),
            "--frame-interval", "1", "--stride", "2"]
    export_pointcloud.main(argv + ["--out", str(tmp_path / "port.ply")])
    monkeypatch.setattr(sys, "argv", ["export_pointcloud.py", *argv,
                                      "--out", str(tmp_path / "jax.ply")])
    importlib.import_module("tools.export_pointcloud").main()
    got, want = (np.loadtxt(tmp_path / f"{n}.ply", skiprows=10)
                 for n in ("port", "jax"))
    assert got.shape == want.shape and len(want) > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
