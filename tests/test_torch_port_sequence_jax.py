"""The port's offline processors against the JAX package's on CPU.

The same numpy scene goes through estdepth_tpu.eval.sequence (one lax.scan
program per call) and through estdepth_tpu_torch.eval.sequence (a Python
loop), with the weights carried by state_dict_from_jax and loaded strictly:
make_joint_processor, make_sequence_processor and SequenceProcessor, all 4
depth scales within the PARITY.md chain tolerance 8e-3. The cases cover
what only the processors do: features computed once per frame and sliced
per window, the memory carried across chunks, a padded tail, scenes of
different length in one batch, and the reference's pose pairing in the
chained form. tests/test_torch_port_sequence.py holds the same processors
to the port's own runners at float noise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from estdepth_tpu.eval import sequence as jsequence
from estdepth_tpu_torch.eval import sequence as tsequence
from test_torch_port_common import H, W, model_pair, scene_arrays
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 8e-3


@pytest.fixture(scope="module")
def pair():
    return model_pair(views=3)


@pytest.fixture(scope="module")
def scene():
    return scene_arrays(12)


@pytest.mark.parametrize("reference_pose_pairing", [False, True],
                         ids=["geometric", "reference_pose_pairing"])
def test_joint_processor_matches_jax(pair, scene, reference_pose_pairing):
    """12 frames: windows at starts 0/3/6; frame 11 lies beyond the window
    grid and both packages ignore it."""
    jm, variables, tm = pair
    imgs, poses, intr = scene
    want = jsequence.make_joint_processor(
        jm, seq_length=5, reference_pose_pairing=reference_pose_pairing)(
        variables, jnp.asarray(imgs[None]), jnp.asarray(poses[None]),
        jnp.asarray(intr[None]))
    got = tsequence.make_joint_processor(
        tm, seq_length=5, reference_pose_pairing=reference_pose_pairing,
        device="cpu")(imgs[None], poses[None], intr[None])
    assert got.shape == want.shape == (1, 3, 3, 4, H, W)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0.0)
    # EST ran from the second window on
    assert np.abs(got[0, 1:, :, 2] - got[0, 1:, :, 3]).max() > 1e-3


def test_joint_processor_without_est_matches_jax(pair, scene):
    jm, variables, tm = pair
    imgs, poses, intr = scene
    want = jsequence.make_joint_processor(
        jm, seq_length=5, est_on=False, output_scales=(0, 2))(
        variables, jnp.asarray(imgs[None, :8]), jnp.asarray(poses[None, :8]),
        jnp.asarray(intr[None]))
    got = tsequence.make_joint_processor(
        tm, seq_length=5, est_on=False, output_scales=(0, 2), device="cpu")(
        imgs[None, :8], poses[None, :8], intr[None])
    assert got.shape == want.shape == (1, 2, 3, 2, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0.0)


@pytest.mark.parametrize("reference_pose_pairing", [False, True],
                         ids=["geometric", "reference_pose_pairing"])
def test_sequence_processor_fn_matches_jax(pair, scene,
                                           reference_pose_pairing):
    """8 frames, lwindow 3, memory 2: six windows, the FIFO full and
    rolling from the fourth."""
    jm, variables, tm = pair
    imgs, poses, intr = scene
    want = jsequence.make_sequence_processor(
        jm, 3, 2, reference_pose_pairing=reference_pose_pairing)(
        variables, jnp.asarray(imgs[None, :8]), jnp.asarray(poses[None, :8]),
        jnp.asarray(intr[None]))
    got = tsequence.make_sequence_processor(
        tm, 3, 2, reference_pose_pairing=reference_pose_pairing,
        device="cpu")(imgs[None, :8], poses[None, :8], intr[None])
    assert got.shape == want.shape == (1, 6, 4, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0.0)


def test_process_scenes_of_different_lengths_matches_jax(pair, scene):
    """Two scenes of 9 and 6 frames in chunks of 4: the longer is four
    chunks with a padded tail on the JAX side and a short last chunk on the
    port's, the shorter ends inside the third chunk and its padded windows
    are dropped by both."""
    jm, variables, tm = pair
    imgs, poses, intr = scene
    # the second scene is shorter and moves the other way
    scenes = [(imgs[:9], poses[:9], intr),
              (imgs[7:1:-1].copy(), poses[7:1:-1].copy(), intr)]
    want = jsequence.SequenceProcessor(jm, variables, chunk=4).process_scenes(
        scenes)
    got = tsequence.SequenceProcessor(tm, chunk=4, device="cpu"
                                      ).process_scenes(scenes)
    assert [o.shape for o in got] == [(7, 4, H, W), (4, 4, H, W)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0.0)
