"""The port's dataset readers and image IO against the JAX package's.

  * on fake scenes written here with OpenCV (ScanNet layout with .jpg and
    with .png colour, the 7-Scenes frame-%06d layout), StreamEvalDataset,
    WindowEvalDataset (eval_all, sequence() gapless and pose-gapped) and
    KeyframeEvalDataset return arrays equal to the JAX modules';
  * with OpenCV hidden (the port module's HAVE_CV2 set to False, as on a
    machine without it), the numpy PNG decoder equals cv2.imread on 8-bit RGB and
    16-bit depth PNGs that cv2 wrote with each of the five row filters,
    the numpy INTER_LINEAR resize equals cv2.resize on uint8 (bit for
    bit), on float32 (1e-5 relative) and on uint16 (within 1), the readers equal the JAX package's on
    PNG scenes, and a JPEG raises;
  * the PNG encoder's files read back equal through cv2.
"""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest

from estdepth_tpu.data import eval_stream as jstream
from estdepth_tpu.data import eval_windows as jwindows
from estdepth_tpu.data import keyframe_eval as jkeyframe
from estdepth_tpu_torch.data import eval_stream, eval_windows, io_utils
from estdepth_tpu_torch.data import keyframe_eval, png
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, pose, render,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RAW_H, RAW_W, OUT_H, OUT_W = 48, 64, 32, 40
FRAMES, BAD_POSE = 46, 8  # frame 8 of the gapped scene has a NaN pose
FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


def _frame(i: int, seed: int = 0):
    cfg = SyntheticSceneConfig(height=RAW_H, width=RAW_W, focal=50.0,
                               seed=seed)
    p = pose(cfg, i)
    rgb, depth = render(cfg, p)
    # a band of invalid (0) and far depth, so the masks have work to do
    depth[:4] = 0.0
    depth[-3:] = 12.0
    return rgb.astype(np.uint8), np.rint(depth * 1000).astype(np.uint16), p


def _write_scannet(folder, ext: str, bad_pose: bool):
    for sub in ("rgb", "depth", "pose"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i in range(FRAMES):
        rgb, depth, p = _frame(i)
        if bad_pose and i == BAD_POSE:
            p = np.full((4, 4), np.nan, np.float32)
        cv2.imwrite(os.path.join(folder, "rgb", f"{i}{ext}"), rgb[..., ::-1])
        cv2.imwrite(os.path.join(folder, "depth", f"{i}.png"), depth)
        np.savetxt(os.path.join(folder, "pose", f"{i}.txt"), p)


def _write_7scenes(folder):
    os.makedirs(folder, exist_ok=True)
    for i in range(12):
        rgb, depth, p = _frame(i, seed=1)
        name = os.path.join(folder, f"frame-{i:06d}")
        cv2.imwrite(name + ".color.png", rgb[..., ::-1])
        cv2.imwrite(name + ".depth.png", depth)
        np.savetxt(name + ".pose.txt", p)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    scannet = tmp_path_factory.mktemp("scannet")
    _write_scannet(scannet / "scene_png", ".png", bad_pose=False)
    _write_scannet(scannet / "scene_jpg", ".jpg", bad_pose=True)
    seven = tmp_path_factory.mktemp("7scenes")
    _write_7scenes(seven / "chess" / "seq-03")
    keyframes = tmp_path_factory.mktemp("lists") / "keyframes.txt"
    keyframes.write_text("scene_jpg 5\nscene_jpg 40\n")
    return {"scannet": str(scannet), "7scenes": str(seven),
            "keyframes": str(keyframes)}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert got == want


# (layout, scene, sequence, dataset kwargs)
SCENES = {
    "scannet_png": ("scannet", "scene_png", None, {"scannet_layout": True}),
    "scannet_jpg": ("scannet", "scene_jpg", None, {"scannet_layout": True}),
    "7scenes": ("7scenes", "chess", "seq-03", {"scannet_layout": False}),
}


@pytest.mark.parametrize("case", sorted(SCENES))
@pytest.mark.parametrize("start_index", [0, 2])
def test_stream_dataset_matches_jax(roots, case, start_index):
    root, scene, seq, kw = SCENES[case]
    args = (roots[root], OUT_H, OUT_W)
    kw = dict(kw, frame_interval=3, start_index=start_index)
    got = eval_stream.StreamEvalDataset(*args, **kw)
    want = jstream.StreamEvalDataset(*args, **kw)
    got.reset(scene, seq)
    want.reset(scene, seq)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["img"].dtype == np.uint8
        _assert_same(g, w)


@pytest.mark.parametrize("case", sorted(SCENES))
@pytest.mark.parametrize("eval_all", [False, True])
def test_window_dataset_matches_jax(roots, case, eval_all):
    root, scene, seq, kw = SCENES[case]
    args = (roots[root], OUT_H, OUT_W)
    kw = dict(kw, frame_interval=2, eval_all=eval_all)
    got = eval_windows.WindowEvalDataset(*args, **kw)
    want = jwindows.WindowEvalDataset(*args, **kw)
    got.reset(scene, seq)
    want.reset(scene, seq)
    assert got.windows == want.windows and len(got) > 0
    for i in (0, len(got) - 1):
        _assert_same(got[i], want[i])


@pytest.mark.parametrize("scene", ["scene_png", "scene_jpg"])
def test_window_sequence_matches_jax(roots, scene):
    """The scan grid: the gapless scene's sequence() equals JAX's, and the
    scene with a NaN pose gives None (a gapped window chain) in both."""
    args = (roots["scannet"], OUT_H, OUT_W)
    got = eval_windows.WindowEvalDataset(*args, frame_interval=2,
                                         scannet_layout=True)
    want = jwindows.WindowEvalDataset(*args, frame_interval=2,
                                      scannet_layout=True)
    got.reset(scene)
    want.reset(scene)
    for max_windows in (None, 2):
        g, w = got.sequence(max_windows), want.sequence(max_windows)
        if scene == "scene_jpg":
            assert g is None and w is None
        else:
            assert g is not None
            _assert_same(g, w)
            gt, mask = got.read_gt(g["dmap_paths"][1])
            _assert_same((gt, mask), want.read_gt(w["dmap_paths"][1]))


def test_keyframe_dataset_matches_jax(roots):
    args = (roots["scannet"], roots["keyframes"], OUT_H, OUT_W)
    got = keyframe_eval.KeyframeEvalDataset(*args)
    want = jkeyframe.KeyframeEvalDataset(*args)
    assert got.entries == want.entries == [("scene_jpg", 5),
                                           ("scene_jpg", 40)]
    for i in range(len(want)):
        _assert_same(got[i], want[i])
    assert got.window_indices(5) == want.window_indices(5)


@pytest.fixture
def no_cv2(monkeypatch):
    """The port's readers as on a machine without OpenCV."""
    monkeypatch.setattr(io_utils, "HAVE_CV2", False)


def _cv2_rgb(path):
    return cv2.imread(path)[..., ::-1]


@pytest.mark.parametrize("flt", FILTERS)
def test_png_decoder_equals_cv2(tmp_path, no_cv2, flt):
    """8-bit RGB and 16-bit depth PNGs written by cv2 with one row filter
    throughout, read without OpenCV at their own size."""
    rgb, depth, _ = _frame(3)
    # a noisy patch, so that every filter meets large differences
    rng = np.random.default_rng(0)
    rgb[10:20, 10:30] = rng.integers(0, 256, (10, 20, 3), dtype=np.uint8)
    depth[20:30] = rng.integers(0, 65536, (10, RAW_W), dtype=np.uint16)
    flag = [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{flt}")]
    rgb_path, depth_path = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    cv2.imwrite(rgb_path, rgb[..., ::-1], flag)
    cv2.imwrite(depth_path, depth, flag)
    got = io_utils.read_image_rgb(rgb_path, RAW_W, RAW_H, np.uint8)
    assert got.dtype == np.uint8
    assert np.array_equal(got, _cv2_rgb(rgb_path))
    assert np.array_equal(got, rgb)
    raw = png.read(depth_path)
    assert raw.dtype == np.uint16
    assert np.array_equal(raw, cv2.imread(depth_path, cv2.IMREAD_ANYDEPTH))
    assert np.array_equal(io_utils.read_depth_mm(depth_path),
                          depth.astype(np.float32) / 1000.0)


def test_png_decoder_reads_cv2_adaptive_filters(tmp_path):
    """cv2's default writer picks a filter per row; grey and RGBA too."""
    rgb, depth, _ = _frame(5)
    rgba = np.concatenate([rgb, rgb[..., :1]], -1)
    for name, img in (("rgb", rgb[..., ::-1]), ("grey", rgb[..., 0]),
                      ("rgba", rgba), ("depth", depth)):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, np.ascontiguousarray(img))
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:  # BGR(A) -> the file's RGB(A) order
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        assert np.array_equal(png.read(path), want), name


def test_png_encoder_reads_back_through_cv2(tmp_path):
    rgb, depth, _ = _frame(2)
    for name, img in (("rgb", rgb), ("grey", rgb[..., 1]), ("depth", depth)):
        path = str(tmp_path / f"{name}.png")
        png.write(path, img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if back.ndim == 3:
            back = back[..., ::-1]
        assert back.dtype == img.dtype and np.array_equal(back, img), name
    with pytest.raises(ValueError, match="cannot write a PNG"):
        png.encode(np.zeros((4, 4), np.float32))


RESIZES = [((480, 640, 3), (256, 320)), ((480, 640, 3), (64, 96)),
           ((480, 640, 3), (240, 320)), ((480, 640, 3), (600, 800)),
           ((37, 53, 3), (24, 40)), ((37, 53, 3), (77, 101)),
           ((24, 32, 3), (64, 96)), ((480, 640), (250, 333)),
           ((31, 29, 4), (61, 64))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_uint8_equals_cv2(src, dst):
    """Bit for bit: cv2's 11-bit fixed point and its vertical rounding."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src, dtype=np.uint8)
    want = cv2.resize(img, dst[::-1])
    got = io_utils.resize_linear(img, dst[1], dst[0])
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((256, 320), (480, 640)),
                                     ((64, 96), (37, 53)),
                                     ((64, 96), (480, 640)),
                                     ((480, 640), (256, 320))])
def test_resize_float32_equals_cv2(src, dst):
    """float32 (the scorer resizes predictions to the GT's size)."""
    rng = np.random.default_rng(sum(src))
    img = rng.uniform(0.3, 5.0, src).astype(np.float32)
    want = cv2.resize(img, dst[::-1])
    got = io_utils.resize_linear(img, dst[1], dst[0])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dst,share", [((OUT_H, OUT_W), 0.0032),
                                       ((97, 131), 0.0003)])
def test_resize_uint16_near_cv2(dst, share):
    """uint16 depth (the keyframe reader resizes it) runs in float32, where
    cv2's order of rounding is not reproduced: within 1 mm, on no more
    pixels than measured here (0.31% and 0.024% of them)."""
    _, depth, _ = _frame(4)
    want = cv2.resize(depth, dst[::-1]).astype(np.int64)
    got = io_utils.resize_linear(depth, dst[1], dst[0])
    assert got.dtype == np.uint16
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= share


@pytest.mark.parametrize("case", ["scannet_png", "7scenes"])
def test_datasets_without_cv2_match_jax(roots, no_cv2, case):
    """PNG scenes read without OpenCV equal the JAX readers' with it."""
    root, scene, seq, kw = SCENES[case]
    args = (roots[root], OUT_H, OUT_W)
    got = eval_stream.StreamEvalDataset(*args, frame_interval=4, **kw)
    want = jstream.StreamEvalDataset(*args, frame_interval=4, **kw)
    got.reset(scene, seq)
    want.reset(scene, seq)
    for g, w in zip(got, want):
        _assert_same(g, w)
    got = eval_windows.WindowEvalDataset(*args, frame_interval=2, **kw)
    want = jwindows.WindowEvalDataset(*args, frame_interval=2, **kw)
    got.reset(scene, seq)
    want.reset(scene, seq)
    _assert_same(got[0], want[0])


def test_jpeg_without_cv2_raises(roots, no_cv2):
    path = os.path.join(roots["scannet"], "scene_jpg", "rgb", "0.jpg")
    with pytest.raises(IOError, match="only PNG"):
        io_utils.read_image_rgb(path, OUT_W, OUT_H)
    ds = eval_stream.StreamEvalDataset(roots["scannet"], OUT_H, OUT_W)
    ds.reset("scene_jpg")
    with pytest.raises(IOError, match="cv2"):
        next(iter(ds))
