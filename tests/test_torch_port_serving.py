"""The port's serving artifacts (estdepth_tpu_torch/serving.py) against the
live runners, and the five kernels as `estdepth::*` ops, on CPU.

At the tiny configuration of tests/test_torch_port_common.py (ResNet-18,
D = 8, 64x96, the pitched camera path), with weights drawn for the JAX
model and carried to the port through its weight bridge:

  * a stream artifact (first + steady programs), saved and loaded, against
    the port's ESTMRunner frame for frame at atol/rtol 1e-5, the JAX
    serving test's tolerance (tests/test_serving.py), and against the JAX
    ESTMRunner at the ESTM chain tolerance 8e-3 (PARITY.md); the Joint
    artifact the same way against both JointRunners;
  * each op on CPU tensors equals its plain function bit for bit, and its
    shape function gives the output's shape, dtype and strides
    (torch.library.opcheck).

tests/test_torch_port_serving_tool.py holds the graphs, the loaders and
the export tool. No JAX artifact is exported here: the JAX serving tests
are `slow`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.ops import warp
from estdepth_tpu_torch.ops.cuda import (
    epipolar_attention, group_norm_act, library, plane_mix, plane_warp,
    two_pass, view_correlation, view_variance,
)
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field
from estdepth_tpu_torch.tools.eval_joint import JointRunner
from test_torch_port_common import (
    DMAX, DMIN, H, W, model_pair, pitched_frames, scene_arrays,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCALES = (0, 2)
LW, STRIDE, WINDOWS = 5, 3, 3  # Joint: 3 windows of 5 frames


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """(JAX model, its variables, the port's model, the stream artifact
    saved and loaded again)."""
    jm, variables, tm = model_pair()
    out = str(tmp_path_factory.mktemp("stream"))
    serving.export_stream(tm, height=H, width=W, output_scales=SCALES,
                          device="cpu").save(out)
    return jm, variables, tm, serving.load_stream(out, device="cpu")


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    jm, variables, tm = model_pair(views=LW)
    out = str(tmp_path_factory.mktemp("joint"))
    serving.export_joint(tm, height=H, width=W, seq_length=LW,
                         output_scales=SCALES, device="cpu").save(out)
    return jm, variables, tm, serving.load_joint(out, device="cpu")


def _stream_maps(runner, frames):
    runner.reset()
    return [out for f in frames if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]


def test_stream_artifact_matches_the_live_runner(stream):
    _, _, tm, exported = stream
    frames = pitched_frames(7)
    live = ESTMRunner(tm, H, W, output_scales=SCALES, device="cpu")
    got, want = _stream_maps(exported, frames), _stream_maps(live, frames)
    assert len(got) == len(want) == 5  # the first window, then EST fused
    for g, w in zip(got, want):
        assert g.shape == (1, len(SCALES), H, W) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)
    # EST ran from the second window on: its fused head left the stereo
    # head's map
    assert (got[1][:, 1] - got[0][:, 1]).abs().max() > 1e-3
    # a new scene repeats the first map
    assert torch.equal(_stream_maps(exported, frames[:3])[0], got[0])
    # uint8 frames (uploaded as uint8, cast on the device) give the maps
    # of the same values in float32
    as_uint8 = [dict(f, img=f["img"].astype(np.uint8)) for f in frames[:3]]
    as_float = [dict(f, img=f["img"].astype(np.float32)) for f in as_uint8]
    assert torch.equal(_stream_maps(exported, as_uint8)[0],
                       _stream_maps(exported, as_float)[0])


def test_stream_artifact_matches_the_jax_runner(stream):
    from estdepth_tpu.eval.estm import ESTMRunner as JaxRunner

    jm, variables, _, exported = stream
    frames = pitched_frames(7)
    got = _stream_maps(exported, frames)
    want = _stream_maps(JaxRunner(jm, variables, H, W, output_scales=SCALES),
                        frames)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=8e-3,
                                   rtol=0.0)


def _joint_maps(runner):
    """The artifact fed the pitched scene frame by frame: one output per
    completed window."""
    imgs, poses, intr = scene_arrays((WINDOWS - 1) * STRIDE + LW)
    runner.reset()
    return [out for img, pose in zip(imgs, poses)
            if (out := runner.push_frame(img, pose, intr)) is not None]


def _windows():
    imgs, poses, intr = scene_arrays((WINDOWS - 1) * STRIDE + LW)
    for wi in range(WINDOWS):
        sl = slice(wi * STRIDE, wi * STRIDE + LW)
        yield imgs[None, sl], poses[None, sl], intr[None]


def test_joint_artifact_matches_the_live_runner(joint):
    _, _, tm, exported = joint
    got = _joint_maps(exported)
    live = JointRunner(tm, device="cpu")
    assert len(got) == WINDOWS
    for g, window in zip(got, _windows()):
        want = live.run_window(*window)[0][:, :, list(SCALES)]
        assert g.shape == (1, STRIDE, len(SCALES), H, W)
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
    # a new scene repeats the first window
    assert torch.equal(_joint_maps(exported)[0], got[0])


def test_joint_artifact_matches_the_jax_runner(joint):
    from tools.eval_joint import JointRunner as JaxJointRunner

    jm, variables, _, exported = joint
    got = _joint_maps(exported)
    live = JaxJointRunner(jm, variables, est_on=True)
    assert len(got) == WINDOWS
    for g, window in zip(got, _windows()):
        want = live.run_window(*map(jnp.asarray, window))[0]
        np.testing.assert_allclose(
            g.numpy(), np.asarray(want)[:, :, list(SCALES)], atol=8e-3,
            rtol=0.0)


def _op_cases():
    """(op, args, plain function) at the shapes of
    tests/test_torch_port_ops.py (12x16 maps, D = 8, C = 4), of the
    fusion's attention (3 neighbours, 16 channels, the K and V halves of
    one warped volume read in place), of a variance over 3 views, of a
    correlation of one swept view with the reference and of the GRU's
    gates' GroupNorm and sigmoid."""
    rng = np.random.default_rng(0)
    h, w, c, d = 12, 16, 4, 8

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    intr = torch.tensor([[[14.0, 0, 7.5], [0, 14.0, 5.5], [0, 0, 1]]])
    pose = torch.eye(4)[None]
    pose[0, :3, 3] = torch.tensor([0.04, -0.03, 0.06])
    dv = torch.linspace(DMIN, DMAX, d)[None]
    dint = (DMAX - DMIN) / (d - 1)
    proj = torch.cat([torch.cat([intr, torch.zeros(1, 3, 1)], 2),
                      torch.tensor([[[0.0, 0, 0, 1]]])], 1)
    x, y = warp.plane_sweep_coords(proj @ pose, proj, dv, h, w)
    tt, grid, fx, fy, fz = warp.frustum_coords(pose, intr, dv, h, w)
    zi = zi_field(tt, intr, dv, DMIN, dint, grid)
    src, vol = t(1, h, w, c), t(1, d, h, w, c)
    ab = warp.plane_sweep_line_coeffs(torch.eye(3)[None] + 0.01, 0.1 * t(1, 3),
                                      dv, w)
    warped = t(1, 3, d, h, w, 32).transpose(0, 1)
    valid = torch.tensor([[True], [False], [True]])
    tk = t(1, d, h, w, 16)
    return {
        "plane_sweep_sample": ((src, x, y),
                               plane_warp.plane_sweep_sample_plain),
        "exact_z_resample": ((vol, zi, fx, fy, fz, DMIN, dint),
                             resample_exact_z),
        "two_pass_resample": (
            (src, ab, x.reshape(d, -1), y.reshape(d, -1), d),
            two_pass.two_pass_resample_plain),
        "plane_mix_resample": ((vol, zi, fx, fy),
                               plane_mix.plane_mix_resample_plain),
        "epipolar_attention": (
            (tk, warped[..., :16], warped[..., 16:], valid),
            epipolar_attention.epipolar_attention_plain),
        "view_variance": ((src, [vol, t(1, d, h, w, c)]),
                          view_variance.view_variance_plain),
        "view_correlation": ((src, vol),
                             view_correlation.view_correlation_plain),
        "group_norm_act": ((t(1, 32, d, h, w), 1.0 + 0.1 * t(32),
                            0.1 * t(32), 2, 1e-5, "sigmoid"),
                           group_norm_act.group_norm_act_plain),
    }


@pytest.mark.parametrize("name", list(library.MODULES))
def test_op_equals_its_plain_version_on_cpu(name):
    args, plain = _op_cases()[name]
    op = library.load_ops()[name]
    assert str(op._opoverload) == f"estdepth.{name}.default"
    got, want = op(*args), plain(*args)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    # the shape function against the CPU implementation: shape, dtype and
    # strides (test_faketensor), and the schema (no argument mutated)
    torch.library.opcheck(op, args,
                          test_utils=("test_schema", "test_faketensor"))
    # the CUDA implementation allocates a new contiguous float32 tensor
    # of that shape; so does the shape function
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = op(*torch.utils._pytree.tree_map_only(
            torch.Tensor, mode.from_tensor, args))
    assert (fake.shape, fake.dtype) == (want.shape, torch.float32)
    assert fake.is_contiguous()


