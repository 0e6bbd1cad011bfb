"""The port's offline processors against its own window-by-window runners.

make_joint_processor is JointRunner's chain and make_sequence_processor /
SequenceProcessor are ESTMRunner's stream, with the scene uploaded once
and the matching features computed once per frame; the results must agree
to float noise (atol 1e-5; the JAX package pins its scan forms to its
loops the same way in tests/test_joint_scan.py and tests/test_sequence.py).
The processors are held against the JAX package's own in
tests/test_torch_port_sequence_jax.py, the runners in
tests/test_torch_port_models.py and tests/test_torch_port_joint.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.eval.sequence import (
    SequenceProcessor, make_joint_processor, make_sequence_processor,
)
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.tools.eval_joint import JointRunner
from test_torch_port_common import DMAX, DMIN, H, ND, W, scene_arrays
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def model():
    return DepthNetHybrid(ModelConfig(ndepths=ND, depth_min=DMIN,
                                      depth_max=DMAX, resnet=18), seed=1)


@pytest.fixture(scope="module")
def scene():
    return scene_arrays(12)


def _joint_loop(model, scene, n_windows, lw=5, **kwargs):
    imgs, poses, intr = scene
    runner = JointRunner(model, device="cpu", **kwargs)
    out = []
    for wi in range(n_windows):
        sl = slice(wi * (lw - 2), wi * (lw - 2) + lw)
        out.append(runner.run_window(imgs[None, sl], poses[None, sl],
                                     intr[None])[0][0])
    return torch.stack(out).numpy()  # [NW, T, 4, H, W]


def _stream(model, scene, n=None, **kwargs):
    imgs, poses, intr = scene
    runner = ESTMRunner(model, H, W, device="cpu", **kwargs)
    outs = [runner.push_frame(i, p, intr)
            for i, p in zip(imgs[:n], poses[:n])]
    return torch.cat([o for o in outs if o is not None]).numpy()


@pytest.mark.parametrize("kwargs", [
    {}, {"est_on": False}, {"reference_pose_pairing": True}],
    ids=["default", "no_est", "reference_pose_pairing"])
def test_joint_processor_equals_window_loop(model, scene, kwargs):
    """12 frames: windows at starts 0/3/6, frame 11 beyond the grid is
    ignored."""
    imgs, poses, intr = scene
    process = make_joint_processor(model, seq_length=5, device="cpu",
                                   **kwargs)
    got = process(imgs[None], poses[None], intr[None])
    assert got.shape == (1, 3, 3, 4, H, W)
    np.testing.assert_allclose(got[0].numpy(),
                               _joint_loop(model, scene, 3, **kwargs),
                               atol=1e-5, rtol=0.0)


def test_joint_processor_trims_scales_and_batches(model, scene):
    imgs, poses, intr = scene
    process = make_joint_processor(model, device="cpu", output_scales=(0, 2),
                                   output_dtype=torch.float16)
    two = process(np.stack([imgs[:8], imgs[:8]]),
                  np.stack([poses[:8], poses[:8]]), np.stack([intr, intr]))
    assert two.shape == (2, 2, 3, 2, H, W) and two.dtype == torch.float16
    want = _joint_loop(model, scene, 2)[:, :, [0, 2]]
    for b in range(2):
        np.testing.assert_allclose(two[b].float().numpy(), want, atol=5e-3)
    with pytest.raises(ValueError, match="seq_length"):
        make_joint_processor(model, seq_length=2, device="cpu")


@pytest.mark.parametrize("lwindow,memory_size", [(3, 2), (5, 1)])
def test_sequence_processor_fn_equals_stream(model, scene, lwindow,
                                             memory_size):
    imgs, poses, intr = scene
    process = make_sequence_processor(model, lwindow, memory_size,
                                      device="cpu")
    got = process(imgs[None, :9], poses[None, :9], intr[None])
    assert got.shape == (1, 9 - lwindow + 1, 4, H, W)
    want = _stream(model, scene, 9, lwindow=lwindow,
                   memory_size=memory_size)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0.0)


@pytest.mark.parametrize("chunk,n", [(4, 9), (5, 12), (16, 7)])
def test_chunked_scene_equals_stream(model, scene, chunk, n):
    """Chunk boundaries carry the memory and the shared frames' features:
    chunk 4 over 9 frames is four chunks, the last one short; chunk 16
    holds the whole scene."""
    imgs, poses, intr = scene
    proc = SequenceProcessor(model, chunk=chunk, device="cpu")
    got = proc.process_scene(imgs[:n], poses[:n], intr)
    assert got.shape == (n - 2, 4, H, W)
    np.testing.assert_allclose(got, _stream(model, scene, n), atol=1e-5,
                               rtol=0.0)


def test_process_scenes_of_different_lengths_equals_separate_runs(model,
                                                                  scene):
    imgs, poses, intr = scene
    proc = SequenceProcessor(model, chunk=5, output_scales=(0,),
                             device="cpu")
    # the second scene is shorter and moves the other way
    a = (imgs[:10], poses[:10], intr)
    b = (imgs[7:1:-1].copy(), poses[7:1:-1].copy(), intr)
    both = proc.process_scenes([a, b])
    assert [o.shape for o in both] == [(8, 1, H, W), (4, 1, H, W)]
    for got, one in zip(both, (a, b)):
        np.testing.assert_allclose(got, proc.process_scene(*one), atol=1e-5,
                                   rtol=0.0)


def test_processor_takes_uint8_frames_and_checks_lengths(model, scene):
    imgs, poses, intr = scene
    proc = SequenceProcessor(model, chunk=4, device="cpu")
    u8 = imgs[:5].astype(np.uint8)
    np.testing.assert_allclose(
        proc.process_scene(u8, poses[:5], intr),
        proc.process_scene(u8.astype(np.float32), poses[:5], intr),
        atol=1e-6)
    with pytest.raises(ValueError, match="at least 3"):
        proc.process_scene(imgs[:2], poses[:2], intr)
    with pytest.raises(ValueError, match="shorter than the window"):
        SequenceProcessor(model, lwindow=5, chunk=4, device="cpu")
