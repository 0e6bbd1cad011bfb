"""The port's Joint window protocol against the JAX package on CPU.

Three 5-frame windows advancing by 3 frames (11 frames), 3 targets each,
the last target's state threaded as a 1-entry memory, the first window
without EST: the port's JointRunner against tools/eval_joint.py's, same
weights (carried by state_dict_from_jax, loaded strictly), all 4 depth
scales within the PARITY.md chain tolerance 8e-3, in each frustum mode,
with the reference's pose pairing, and with EST off.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu_torch.config import resolve_frustum_mode
from estdepth_tpu_torch.data import synthetic as tsynthetic
from estdepth_tpu_torch.tools.eval_joint import JointRunner, run_synthetic
from test_torch_port_common import H, W, model_pair, scene_arrays
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LW, STRIDE, WINDOWS = 5, 3, 3


def _chains(frustum_mode, est_on=True, reference_pose_pairing=False):
    from tools.eval_joint import JointRunner as JaxJointRunner

    jm, variables, tm = model_pair(views=LW, frustum_mode=frustum_mode)
    imgs, poses, intr = scene_arrays((WINDOWS - 1) * STRIDE + LW)
    jr = JaxJointRunner(jm, variables, est_on=est_on,
                        reference_pose_pairing=reference_pose_pairing)
    tr = JointRunner(tm, est_on=est_on,
                     reference_pose_pairing=reference_pose_pairing,
                     device="cpu")
    want, got = [], []
    for wi in range(WINDOWS):
        sl = slice(wi * STRIDE, wi * STRIDE + LW)
        window = (imgs[None, sl], poses[None, sl], intr[None])
        want.append(np.asarray(jr.run_window(*map(jnp.asarray, window))[0]))
        depth, probs = tr.run_window(*window)
        assert probs is None and depth.shape == (1, STRIDE, 4, H, W)
        got.append(depth.numpy())
    return np.stack(got), np.stack(want), tr


@pytest.mark.parametrize("frustum_mode",
                         ["plane_mix_exact_z", "plane_mix", "exact"])
def test_joint_chain_matches_jax(frustum_mode):
    got, want, tr = _chains(frustum_mode)
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0.0)
    assert tr.memory.size == 1 and bool(tr.memory.valid.all())
    # EST ran from the second window on: its fused head differs from the
    # pure stereo head
    assert np.abs(got[1:, :, :, 2] - got[1:, :, :, 3]).max() > 1e-3
    tr.reset()
    assert tr.memory is None


def test_joint_chain_reference_pose_pairing_matches_jax():
    got, want, tr = _chains("plane_mix_exact_z", reference_pose_pairing=True)
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0.0)
    plain, _, _ = _chains_port_only(reference_pose_pairing=False)
    # windows 0 and 1 see the same memory pose either way; window 2 pairs
    # window 1's volume with window 0's pose
    np.testing.assert_allclose(got[:2], plain[:2], atol=1e-6)
    assert np.abs(got[2] - plain[2]).max() > 1e-4


def _chains_port_only(**kwargs):
    _, _, tm = model_pair(views=LW)
    imgs, poses, intr = scene_arrays((WINDOWS - 1) * STRIDE + LW)
    tr = JointRunner(tm, device="cpu", **kwargs)
    out = []
    for wi in range(WINDOWS):
        sl = slice(wi * STRIDE, wi * STRIDE + LW)
        out.append(tr.run_window(imgs[None, sl], poses[None, sl], intr[None]))
    return (np.stack([d.numpy() for d, _ in out]), [p for _, p in out], tr)


def test_joint_chain_without_est_matches_jax():
    got, want, _ = _chains("plane_mix_exact_z", est_on=False)
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0.0)


def test_joint_runner_returns_probs():
    depths, probs, _ = _chains_port_only(return_probs=True)
    assert depths.shape == (WINDOWS, 1, STRIDE, 4, H, W)
    for p in probs:
        assert p.shape == (1, STRIDE, 2, H, W)
        assert 0.0 < float(p.min()) and float(p.max()) <= 1.0


def test_synthetic_window_matches_jax():
    from estdepth_tpu.data import synthetic as jsynthetic

    cfg = dict(height=24, width=32, focal=30.0, seed=3)
    want = jsynthetic.synthetic_window(
        jsynthetic.SyntheticSceneConfig(**cfg), 5, 4, 0.5, 8.0, batch=2)
    got = tsynthetic.synthetic_window(
        tsynthetic.SyntheticSceneConfig(**cfg), 5, 4, 0.5, 8.0, batch=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flags,mode", [
    ({}, "plane_mix_exact_z"), ({"exact_z": False}, "plane_mix"),
    ({"exact_warp": True}, "exact"),
    ({"exact_warp": True, "exact_z": False}, "exact")])
def test_resolve_frustum_mode(flags, mode):
    assert resolve_frustum_mode(**flags) == mode


def test_eval_joint_tool_loop_equals_scan(capsys):
    """The CLI's two routes over the synthetic scene: the window loop and
    --scan give the same maps, and main prints the five metrics."""
    from estdepth_tpu_torch.tools import eval_joint

    kw = dict(height=H, width=W, ndepths=8, depth_min=0.5, depth_max=8.0,
              resnet=18, frustum_mode="plane_mix", fused_attention=True,
              device="cpu")
    loop = run_synthetic(**kw)
    scan = run_synthetic(scan=True, **kw)
    assert loop["maps"].shape == (3, 3, 2, H, W)
    assert len(loop["times"]) == 3 and len(scan["times"]) == 1
    np.testing.assert_allclose(scan["maps"], loop["maps"], atol=1e-5)
    assert len(loop["errors"]) == 9
    eval_joint.main(["--synthetic", "--device", "cpu", "--height", str(H),
                     "--width", str(W), "--ndepths", "8", "--resnet", "18",
                     "--no-exact-z"])
    out = capsys.readouterr().out
    for key in ("abs_relative", "sq_relative", "rmse", "rmse_log",
                "ratio_threshold_1.25"):
        assert key in out
