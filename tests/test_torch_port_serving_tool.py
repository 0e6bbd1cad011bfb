"""The port's serving artifacts beyond their numbers, on CPU: what the
exported graphs hold, what the loaders refuse and import, and the export
tool (estdepth_tpu_torch/tools/export_serving.py).

At the tiny configuration of tests/test_torch_port_common.py (ResNet-18,
D = 8, 64x96), random weights from a seed:

  * the exported graphs hold one node of each kernel op the configuration
    runs (the default warps, --no-exact-z, --fused-attention, the two-pass
    plane sweep), no plain-version sampling in their place, and eval-mode
    BatchNorm only;
  * the loaders refuse a quarantined artifact, the other protocol and
    another format version, each with its message; a process that loads
    and runs an artifact imports no model code;
  * `export_serving --verify 3 --output-bf16` passes its oracle check,
    writes the manifest and returns bfloat16 maps; a failed check writes
    VERIFY_FAILED and exits non-zero.

tests/test_torch_port_serving.py holds the artifacts' maps against the
live runners of the port and of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models import memory as memory_module
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.tools import export_serving
from test_torch_port_common import DMAX, DMIN, ND, H, W, pitched_frames
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tool_artifact(tmp_path_factory):
    """export_serving --verify 3 --output-bf16: (argv, the tool's result);
    argv[1] is the artifact's directory."""
    out = str(tmp_path_factory.mktemp("tool") / "estm")
    argv = ["--out", out, "--height", str(H), "--width", str(W),
            "--ndepths", str(ND), "--depth-min", str(DMIN), "--depth-max",
            str(DMAX), "--resnet", "18", "--output-bf16", "--verify", "3",
            "--device", "cpu"]
    return argv, export_serving.main(argv)


# plain-version sampling that must not stand in for a kernel op
PLAIN_SAMPLING = {"aten.gather.default", "aten.floor.default",
                  "aten.grid_sampler_2d.default",
                  "aten.grid_sampler_3d.default"}


def _kernel_ops(program) -> dict:
    """{op name: nodes} of the graph's estdepth ops, after checking that
    the graph holds no plain sampling and no training BatchNorm."""
    ops = {}
    for node in program.graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        ops[name] = ops.get(name, 0) + 1
        if name == "aten.batch_norm.default":
            assert node.args[5] is False, "training BatchNorm"
        if name == "aten.index.Tensor":  # only the output scales' trim
            assert tuple(node.args[0].meta["val"].shape) == (1, 4, H, W)
    assert not [n for n in ops if "native_batch_norm_legit" in n
                and "no_training" not in n], ops
    assert not PLAIN_SAMPLING & set(ops), ops
    return {name.split(".")[1]: n for name, n in ops.items()
            if name.startswith("estdepth.")}


@pytest.mark.parametrize("config", ["default", "no_exact_z",
                                    "fused_attention", "two_pass_warp"])
def test_exported_graph_holds_the_kernel_ops(tool_artifact, config):
    """The first program sweeps once; the steady program sweeps once and
    fuses its one target against the 2 memory entries with one frustum
    warp (and one attention call with the attention kernel). The default
    configuration's programs are the export tool's, read back from disk."""
    if config == "default":
        first, steady = (torch.export.load(os.path.join(tool_artifact[0][1],
                                                        name))
                         for name in (serving.FIRST, serving.STEADY))
    else:
        options = {"no_exact_z": dict(frustum_mode="plane_mix"),
                   "fused_attention": dict(use_fused_attention=True),
                   "two_pass_warp": dict(two_pass_warp=True)}[config]
        model = DepthNetHybrid(ModelConfig(ndepths=ND, depth_min=DMIN,
                                           depth_max=DMAX, resnet=18,
                                           **options))
        art = serving.export_stream(model, height=H, width=W,
                                    output_scales=(0, 2), device="cpu")
        first, steady = art.first, art.steady
    sweep = ("two_pass_resample" if config == "two_pass_warp"
             else "plane_sweep_sample")
    frustum = ("plane_mix_resample" if config == "no_exact_z"
               else "exact_z_resample")
    want = {sweep: 1, frustum: 1}
    if config == "fused_attention":
        want["epipolar_attention"] = 1
    assert _kernel_ops(first) == {sweep: 1}
    assert _kernel_ops(steady) == want
    if config == "fused_attention":
        # the warped K and V halves reach the kernel as slices of one
        # volume, which it reads in place: no copy in between
        (node,) = [n for n in steady.graph.nodes
                   if str(n.target) == "estdepth.epipolar_attention.default"]
        assert [str(a.target) for a in node.args[1:3]] == [
            "aten.slice.Tensor"] * 2


def _manifest(directory: str) -> dict:
    with open(os.path.join(directory, serving.MANIFEST)) as f:
        return json.load(f)


def _with_manifest(directory: Path, manifest: dict) -> str:
    directory.mkdir()
    (directory / serving.MANIFEST).write_text(json.dumps(manifest))
    return str(directory)


@pytest.mark.parametrize("case", ["verify_failed", "protocol",
                                  "format_version"])
def test_loaders_refuse(tool_artifact, tmp_path, case):
    """Each refusal comes before a program is read."""
    out = tool_artifact[0][1]
    if case == "verify_failed":
        bad = tmp_path / "bad"
        bad.mkdir()
        (bad / "VERIFY_FAILED").write_text("max |depth delta| 1e-1 > 1e-3")
        with pytest.raises(ValueError, match=r"artifact .*bad failed "
                           r"export-time verification \(max \|depth delta\| "
                           r"1e-1 > 1e-3\); re-export it"):
            serving.load_stream(str(bad), device="cpu")
    elif case == "protocol":
        with pytest.raises(ValueError, match=r"is protocol 'stream'; load it "
                           r"with load_stream \(not load_joint\)"):
            serving.load_joint(out, device="cpu")
        joint = _with_manifest(tmp_path / "joint",
                               dict(_manifest(out), protocol="joint"))
        with pytest.raises(ValueError, match=r"is protocol 'joint'; load it "
                           r"with load_joint \(not load_stream\)"):
            serving.load_stream(joint, device="cpu")
    else:
        old = _with_manifest(tmp_path / "old",
                             dict(_manifest(out), format_version=0))
        with pytest.raises(ValueError, match="artifact format 0 != 1"):
            serving.load_stream(old, device="cpu")


def test_memory_registration_is_idempotent(recwarn):
    """ESTMemory crosses the programs' boundary as a pytree of its four
    tensors; registering it again changes nothing and warns nothing."""
    memory_module.register_serialization()
    memory_module.register_serialization()
    assert not [w for w in recwarn if "registered" in str(w.message)]
    mem = memory_module.ESTMemory.create(1, 2, 3, 4, 5)
    leaves, spec = torch.utils._pytree.tree_flatten(mem)
    assert len(leaves) == 4
    assert torch.utils._pytree.tree_unflatten(leaves, spec) is not mem
    assert all(a is b for a, b in zip(
        leaves, torch.utils._pytree.tree_flatten(
            torch.utils._pytree.tree_unflatten(leaves, spec))[0]))


def test_loaded_artifact_imports_no_model_code(tool_artifact):
    """A fresh process that loads and runs an artifact imports, of
    models/, only ESTMemory: the counterpart of the JAX package's
    test_models_reexports_are_lazy."""
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from estdepth_tpu_torch.serving import load_stream
runner = load_stream({tool_artifact[0][1]!r}, device="cpu")
rng = np.random.default_rng(0)
k = np.array([[80.0, 0, 47.5], [0, 80.0, 31.5], [0, 0, 1]], np.float32)
outs = [runner.push_frame(rng.uniform(0, 255, ({H}, {W}, 3)).astype(
    np.uint8), np.eye(4, dtype=np.float32), k) for _ in range(4)]
assert outs[-1].shape == (1, 1, {H}, {W})
assert bool(torch.isfinite(outs[-1].float()).all())
print(" ".join(sorted(m for m in sys.modules
                      if m.startswith("estdepth_tpu_torch.models"))))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1].split() == [
        "estdepth_tpu_torch.models", "estdepth_tpu_torch.models.memory"]


def test_export_tool_verifies_and_writes_the_manifest(tool_artifact):
    argv, res = tool_artifact
    out = argv[1]
    assert res["max_abs_delta"] == 0.0  # the same ops on the same device
    assert not os.path.exists(os.path.join(out, "VERIFY_FAILED"))
    assert sorted(os.listdir(out)) == sorted(
        [serving.MANIFEST, serving.FIRST, serving.STEADY])
    assert res["bytes"] == sum(os.path.getsize(os.path.join(out, f))
                               for f in os.listdir(out))
    assert _manifest(out) == {
        "format_version": 1, "protocol": "stream",
        "torch_version": torch.__version__, "device": "cpu", "height": H,
        "width": W, "batch": 1, "lwindow": 3, "memory_size": 2,
        "ndepths": ND, "memory_channels": 16, "memory_dtype": "float32",
        "output_scales": [0], "output_dtype": "bfloat16"}


def test_bf16_artifact_returns_bfloat16_maps(tool_artifact):
    runner = serving.load_stream(tool_artifact[0][1], device="cpu")
    maps = [out for f in pitched_frames(4) if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    assert len(maps) == 2
    for depth in maps:
        assert depth.dtype == torch.bfloat16
        assert depth.shape == (1, 1, H, W)
        assert bool(torch.isfinite(depth.float()).all())


def test_export_tool_quarantines_a_failed_artifact(tool_artifact, tmp_path,
                                                   monkeypatch):
    """The oracle check's failure branch at the tool's tolerance: a delta
    of 2e-3 (the artifact's own is 0) writes VERIFY_FAILED and exits
    non-zero, and the loader then refuses the directory."""
    argv, _ = tool_artifact
    out = str(tmp_path / "copy")
    shutil.copytree(argv[1], out)
    args = export_serving.parse_args(["--out", out, *argv[2:]])
    monkeypatch.setattr(export_serving, "verify",
                        lambda args, model, n: 2e-3)
    with pytest.raises(SystemExit) as exc:
        export_serving.verify_or_quarantine(args, model=None)
    assert "verification FAILED (delta 2.000e-03 > 0.001)" in str(
        exc.value.code)
    with open(os.path.join(out, "VERIFY_FAILED")) as f:
        assert f.read() == "max |depth delta| 2.000000e-03 > 0.001\n"
    with pytest.raises(ValueError, match="failed export-time verification"):
        serving.load_stream(out, device="cpu")
