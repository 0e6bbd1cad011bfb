"""The port's native window reader (estdepth_tpu_torch/data/native/): its
build, its reads against cv2 at the JAX package's tolerances
(tests/test_native_loader.py), and against the JAX package's copy of the
same source, bit for bit.

Whether the library builds is decided inside a fixture: a test that needs
it skips with the build's error where g++ or the codec libraries are
missing. A build race cannot skip it: the build is locked and atomic.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import pytest

from estdepth_tpu_torch.data import io_utils, native, scannet
from test_torch_port_common import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.usefixtures("one_torch_thread")
N = 5


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip(f"the native reader did not build: "
                    f"{native.build_error()}")


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """N frames of smooth colour (JPEG quality 98), 16-bit depth and poses,
    as tests/test_native_loader.py writes one."""
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    paths = ([], [], [])
    for i in range(N):
        img = np.stack([127 + 100 * np.sin((xx + 3 * i) / 9.0),
                        127 + 100 * np.cos(yy / 7.0),
                        127 + 80 * np.sin((xx + yy) / 11.0)],
                       -1).astype(np.uint8)
        paths[0].append(str(d / f"{i}.jpg"))
        cv2.imwrite(paths[0][-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 98])
        paths[1].append(str(d / f"{i}.png"))
        cv2.imwrite(paths[1][-1],
                    rng.integers(500, 4500, (48, 64)).astype(np.uint16))
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * i, -0.2, 0.3]
        paths[2].append(str(d / f"{i}.txt"))
        np.savetxt(paths[2][-1], pose)
    return paths


def test_read_window_matches_cv2(built, window):
    imgs, depths, poses = native.read_window(*window, 40, 32)
    assert imgs.shape == (N, 32, 40, 3) and depths.shape == (N, 32, 40)
    for i in range(N):
        want = io_utils.read_image_rgb(window[0][i], 40, 32)
        # the same half-pixel bilinear; cv2 resizes in fixed point
        assert np.abs(imgs[i] - want).mean() < 1.0
        assert np.abs(imgs[i] - want).max() < 16.0
        want = io_utils.read_depth_mm(window[1][i], 40, 32)
        assert np.abs(depths[i] - want).max() < 0.02  # metres
        np.testing.assert_allclose(poses[i], io_utils.read_pose(
            window[2][i]), rtol=1e-6)


def test_read_window_equals_the_jax_packages(built, window):
    """Same source, same libjpeg and libpng: the same floats."""
    from estdepth_tpu.data import native as jax_native

    if not jax_native.available():
        pytest.skip(f"the JAX package's native reader did not build: "
                    f"{jax_native.build_error()}")
    got = native.read_window(*window, 40, 32)
    want = jax_native.read_window(*window, 40, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dataset_native_backend_against_cv2(built, window, tmp_path):
    scene = tmp_path / "scene0000_00"
    for sub in ("rgb", "depth", "pose"):
        os.makedirs(scene / sub)
    for i in range(0, 140, 2):
        for src, sub, ext in zip(window, ("rgb", "depth", "pose"),
                                 ("jpg", "png", "txt")):
            os.link(src[i // 2 % N], scene / sub / f"{i}.{ext}")
    kw = dict(height=32, width=40, n_frames=5, frame_interval=2)
    ds_native = scannet.ScanNetTrainDataset(str(tmp_path), backend="native",
                                            **kw)
    ds_auto = scannet.ScanNetTrainDataset(str(tmp_path), backend="auto",
                                          **kw)
    assert ds_auto.backend == "native"
    ds_cv2 = scannet.ScanNetTrainDataset(str(tmp_path), backend="cv2", **kw)
    a, b = ds_native[3], ds_cv2[3]
    assert np.abs(a["imgs"] - b["imgs"]).mean() < 1.0
    assert np.abs(a["dmaps"] - b["dmaps"]).max() < 0.02
    np.testing.assert_allclose(a["cam_poses"], b["cam_poses"], rtol=1e-6)
    assert (a["dmasks"] == b["dmasks"]).mean() > 0.99
    with pytest.raises(IOError, match="native window read failed"):
        native.read_window([window[1][0]], window[1][:1], window[2][:1],
                           40, 32)  # a PNG is not a JPEG


def test_concurrent_builds_make_one_library(built, tmp_path, monkeypatch):
    """Builds that start together (test workers, loader threads) wait on
    one lock: one compile, one library renamed into place, no temporary
    left behind, and the library loads."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out = native.library_path()
    assert out.parent == tmp_path
    errors = [None] * 4
    threads = [threading.Thread(
        target=lambda i=i: errors.__setitem__(i, native._build(out)))
        for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=native.BUILD_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert errors == [None] * 4
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [out.name, out.with_suffix(".lock").name])
    ctypes.CDLL(str(out)).est_load_window  # noqa: B018
