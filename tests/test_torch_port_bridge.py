"""The port's weight bridge, its import purity, and its device rules.

  * state_dict_from_jax equals the JAX package's export_state_dict key for
    key and value for value, and loads strictly into the port's model;
  * no module of estdepth_tpu_torch, and not chip_smoke.py, imports jax,
    flax or estdepth_tpu (an AST walk);
  * the JAX package's config dataclasses' fields and defaults are in the
    port's config;
  * entry points run on the CUDA device unless asked for the CPU: without
    a GPU they raise, and the kernels neither build without nvcc nor fall
    back to the plain version for a tensor that is not on the CPU;
  * a library's name changes with its source and with every csrc header,
    and tools/kernel_report.py reads ptxas's and cuobjdump's reports.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu import config as jax_config
from estdepth_tpu.models import DepthNetHybrid as JaxModel
from estdepth_tpu.utils.convert import export_state_dict
from estdepth_tpu_torch import config as port_config
from estdepth_tpu_torch.config import ModelConfig, resolve_device, tiny_config
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.ops.cuda import (
    build, epipolar_attention, plane_mix, plane_warp, plane_warp_exact_z,
    two_pass,
)
from estdepth_tpu_torch.tools import kernel_report
from estdepth_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "estdepth_tpu", "optax", "orbax")


@pytest.mark.parametrize("resnet", [18, 50])
def test_state_dict_from_jax_equals_export_and_loads(resnet):
    model_cfg, eval_cfg = tiny_config()
    jm = JaxModel(ndepths=model_cfg.ndepths, resnet=resnet)
    h, w = eval_cfg.height, eval_cfg.width
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 3, h, w, 3)),
        jnp.tile(jnp.eye(4)[None, None], (1, 3, 1, 1)),
        jnp.eye(3)[None], train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    want = export_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    port = DepthNetHybrid(ModelConfig(ndepths=model_cfg.ndepths,
                                      resnet=resnet))
    port_keys = {k for k in port.state_dict()
                 if not k.endswith("num_batches_tracked")}
    assert port_keys == set(want)
    port.load_state_dict(got, strict=True)
    for k, v in port.state_dict().items():
        if k in want:
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "estdepth_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for walked in ("parallel/mesh.py", "models/senet.py", "ops/se3.py",
                   "ops/image_warp.py", "parallel/spatial.py",
                   "ops/shard_context.py"):
        assert ROOT / "estdepth_tpu_torch" / walked in files, walked
    bad = [(f.relative_to(ROOT).as_posix(), name)
           for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig",
                                  "TrainConfig", "EvalConfig", "Config"])
def test_config_fields_and_defaults_are_the_jax_packages(name):
    """Each JAX config dataclass's fields exist in the port's with the
    same defaults (the port's add its own: the warp and dtype options,
    the eval tools' frame size)."""
    want_cls = getattr(jax_config, name)
    got_cls = getattr(port_config, name)
    got = {f.name: f for f in dataclasses.fields(got_cls)}
    for f in dataclasses.fields(want_cls):
        assert f.name in got, f.name
    want_obj, got_obj = want_cls(), got_cls()
    for f in dataclasses.fields(want_cls):
        w, g = getattr(want_obj, f.name), getattr(got_obj, f.name)
        if dataclasses.is_dataclass(w):
            w = {k.name: getattr(w, k.name) for k in dataclasses.fields(w)}
            g = {k: getattr(g, k) for k in w}
        assert g == w, (name, f.name)


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = DepthNetHybrid(ModelConfig(ndepths=4, resnet=18))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ESTMRunner(model, 64, 96)
    from estdepth_tpu_torch.tools.eval_estm import run_synthetic

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_synthetic(height=64, width=96, ndepths=4, resnet=18, n_frames=3)
    assert ESTMRunner(model, 64, 96, device="cpu").device.type == "cpu"

    from estdepth_tpu_torch.eval import sequence
    from estdepth_tpu_torch.tools import eval_joint

    for make in (lambda: eval_joint.JointRunner(model),
                 lambda: sequence.make_joint_processor(model),
                 lambda: sequence.make_sequence_processor(model),
                 lambda: sequence.SequenceProcessor(model),
                 lambda: eval_joint.run_synthetic(
                     height=64, width=96, ndepths=4, resnet=18, windows=1),
                 lambda: eval_joint.main(["--synthetic"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert eval_joint.JointRunner(model, device="cpu").device.type == "cpu"


def test_kernels_do_not_fall_back(monkeypatch, tmp_path):
    """Off the CPU a wrapper launches its kernel or raises: tensors on
    another device are refused, and the build raises without nvcc."""
    meta = torch.empty(1, 4, 5, 4, device="meta")
    coords = torch.empty(1, 2 * 4 * 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        plane_warp.plane_sweep_sample(meta, coords, coords)
    with pytest.raises(ValueError, match="unsupported device"):
        plane_warp_exact_z.exact_z_resample(
            torch.empty(1, 2, 4, 5, 4, device="meta"),
            torch.empty(1, 2, 20, device="meta"), coords, coords, coords,
            0.5, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        plane_mix.plane_mix_resample(
            torch.empty(1, 2, 4, 5, 4, device="meta"),
            torch.empty(1, 2, 20, device="meta"), coords, coords)
    with pytest.raises(ValueError, match="unsupported device"):
        epipolar_attention.epipolar_attention(
            torch.empty(1, 2, 4, 5, 16, device="meta"),
            torch.empty(3, 1, 2, 4, 5, 16, device="meta"),
            torch.empty(3, 1, 2, 4, 5, 16, device="meta"),
            torch.ones(3, 1, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        two_pass.two_pass_resample(
            meta, torch.empty(2, 2, 5, device="meta"), coords.reshape(2, 20),
            coords.reshape(2, 20), 2)
    assert set(build.sources()) == {
        "plane_sweep_warp", "frustum_warp_exact_z", "two_pass_resample",
        "frustum_warp_plane_mix", "epipolar_attention"}
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME",
                        str(ROOT / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_wrapper_input_checks():
    """The checks a wrapper runs before a launch, on CPU tensors. The
    kernels have float32 and bfloat16 instances: both pass, every other
    dtype raises, and a tensor held to one dtype (a coordinate: float32)
    raises in the other."""
    dev = torch.device("cpu")
    ok = torch.zeros(2, 8)
    build.require(ok, "x", (2, 8), dev)
    build.require(ok.bfloat16(), "x", (2, 8), dev)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            build.require(ok.to(dtype), "x", (2, 8), dev)
    with pytest.raises(TypeError, match="expected torch.float32"):
        build.require(ok.bfloat16(), "x", (2, 8), dev, dtype=torch.float32)
    # a voxel's channels must be whole 16-byte vectors: 4 float32, 8 bf16
    build.require_channels("src", (2, 4), torch.float32)
    build.require_channels("src", (2, 8), torch.bfloat16)
    for c, dtype in ((6, torch.float32), (4, torch.bfloat16)):
        with pytest.raises(ValueError, match="C %"):
            build.require_channels("src", (2, c), dtype)
    with pytest.raises(ValueError, match="shape"):
        build.require(ok, "x", (2, 4), dev)
    with pytest.raises(ValueError, match="contiguous"):
        build.require(ok.t(), "x", (8, 2), dev)
    with pytest.raises(ValueError, match="requires grad"):
        build.require(ok.clone().requires_grad_(), "x", (2, 8), dev)
    # only a warp's sampled volume may require grad
    build.require(ok.clone().requires_grad_(), "x", (2, 8), dev,
                  allow_grad=True)


def test_strided_voxel_rows_check():
    """The strided form of the check: the K and V halves of a warped
    [B, N, D, H, W, 2C] volume with the neighbour axis in front pass with
    their strides; a layout the kernel cannot address raises."""
    dev = torch.device("cpu")
    b, n, d, h, w, c = 2, 3, 4, 5, 6, 16
    warped = torch.zeros(b, n, d, h, w, 2 * c).transpose(0, 1)
    shape = (n, b, d, h, w, c)
    vox = d * h * w * 2 * c
    for half in (warped[..., :c], warped[..., c:]):
        assert build.require_voxel_rows(half, "wk", shape, dev) == (
            [vox, n * vox], 2 * c)
    tk = torch.zeros(b, 2, d, h, w, c)[:, 1]
    assert build.require_voxel_rows(tk, "tk", (b, d, h, w, c), dev) == (
        [2 * d * h * w * c], c)
    one = torch.zeros(1, 1, 1, 1, c)  # size-1 dims: any stride will do
    assert build.require_voxel_rows(one, "tk", (1, 1, 1, 1, c), dev) == (
        [0], c)
    with pytest.raises(ValueError, match="channel stride"):
        build.require_voxel_rows(
            torch.zeros(b, d, h, c, w).transpose(-1, -2), "tk",
            (b, d, h, w, c), dev)
    with pytest.raises(ValueError, match="one voxel index"):
        build.require_voxel_rows(
            torch.zeros(b, h, d, w, c).transpose(1, 2), "tk",
            (b, d, h, w, c), dev)
    with pytest.raises(ValueError, match="16-byte"):
        build.require_voxel_rows(torch.zeros(b, d, h, w, c + 2)[..., 2:],
                                 "tk", (b, d, h, w, c), dev)
    # bfloat16 rows: the same strides, alignment counted in bytes
    half = warped.bfloat16()[..., c:]
    assert build.require_voxel_rows(half, "wv", shape, dev) == (
        [vox, n * vox], 2 * c)
    assert build.require_voxel_rows(tk.bfloat16(), "tk", (b, d, h, w, c),
                                    dev) == ([d * h * w * c], c)
    with pytest.raises(ValueError, match="16-byte"):  # 4 bf16 = 8 bytes
        build.require_voxel_rows(
            torch.zeros(b, d, h, w, c + 4, dtype=torch.bfloat16)[..., 4:],
            "tk", (b, d, h, w, c), dev)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            build.require_voxel_rows(tk.to(dtype), "tk", (b, d, h, w, c),
                                     dev)
    with pytest.raises(TypeError, match="expected torch.bfloat16"):
        build.require_voxel_rows(tk, "tk", (b, d, h, w, c), dev,
                                 dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        build.require_voxel_rows(tk, "tk", (b, d, h, w, 8), dev)


def test_library_path_follows_sources_and_headers(monkeypatch, tmp_path):
    """Kernels 1 and 3 include csrc/sweep_gather.cuh: an edited header, like
    an edited source, names a new library, so a stale one is never
    loaded."""
    for name in ("plane_sweep_warp", "two_pass_resample"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "sweep_gather.cuh"' in text
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert first == build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = build.library_path("k")
    assert len({first, second, third}) == 3
    assert build.sources() == ["k"]


def test_kernel_report_reads_ptxas_and_sass():
    ptxas = """\
ptxas info    : Compiling entry function '_Z1kILi8EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi8EEvPf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'
ptxas info    : Used 31 registers, 1024 bytes smem, 384 bytes cmem[0]
"""
    assert kernel_report.ptxas_report(ptxas) == {
        "_Z1kILi8EEvPf": {"spill_bytes": 12, "registers": 96,
                          "smem_bytes": 0},
        "_Z1gv": {"registers": 31, "smem_bytes": 1024}}
    sass = """\
\tcode for sm_90a
\t\tFunction : _Z1kILi8EEvPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   SHFL.IDX PT, R4, R2, R3, 0x1f ;
        /*0020*/              @!P0 LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*0030*/                   STG.E.EF.128 desc[UR4][R10.64], R12 ;
        /*0040*/                   EXIT ;
\t\tFunction : _Z1gv
        /*0000*/                   EXIT ;
"""
    counts = kernel_report.sass_counts(sass)
    assert counts["_Z1kILi8EEvPf"] == {"instructions": 5, "shuffles": 1,
                                       "global_loads": 1, "global_stores": 1}
    assert counts["_Z1gv"] == {"instructions": 1}
