"""Host-side image and pose IO shared by the dataset readers (the port's own
copy of estdepth_tpu/data/io_utils.py).

Where OpenCV imports, images are decoded with `cv2.imread` and resized
with `cv2.resize` (INTER_LINEAR), exactly as the JAX package does, so both
read the same arrays. Where it does not, the port's own numpy code runs:
PNGs are decoded by `data/png.py` and `resize_linear` reproduces cv2's
INTER_LINEAR resize. Only PNG frames can be read without OpenCV; any
other file (ScanNet's JPEG colour frames) raises an IOError that says so.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from estdepth_tpu_torch.data import png

try:
    import cv2

    HAVE_CV2 = True
except ImportError:
    cv2 = None
    HAVE_CV2 = False


def natsorted(paths: List[str]) -> List[str]:
    """Natural sort (numeric-aware), replacing the natsort dependency."""

    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


def _taps(src: int, dst: int, float_fraction: bool, clamp: bool):
    """cv2's INTER_LINEAR sample positions along one axis: pixel centres at
    half-pixel offsets, (dst + 0.5) * src / dst - 0.5. Returns the two
    source indices (clamped to the image) and the float32 weight of the
    second. cv2 takes the fraction of that position in float32 for uint8
    images (its fixed-point path) and in float64 for the others, and along
    x (`clamp`) it sets the weight to 0 where the position lies outside
    the first or last pixel centre."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    if float_fraction:
        pos = pos.astype(np.float32)
    first = np.floor(pos).astype(np.int64)
    frac = (pos - first).astype(np.float32)
    if clamp:
        frac[(first < 0) | (first >= src - 1)] = 0
    return (np.clip(first, 0, src - 1), np.clip(first + 1, 0, src - 1),
            frac)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height))` (INTER_LINEAR) in numpy, for
    [H, W] or [H, W, C] uint8, uint16 or float32 images.

    uint8 runs cv2's fixed point: weights rounded to 11 bits, the vertical
    blend as its vector code does it ((row >> 4) * weight >> 16 per row,
    then + 2 >> 2), which equals cv2 exactly on every image the tests
    compare. uint16 and float32 run in float32 arithmetic (uint16 rounded
    to nearest at the end), within float32 rounding of cv2: a uint16
    result may differ from cv2's by 1."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16, np.float32):
        raise TypeError(f"resize_linear takes uint8, uint16 or float32, "
                        f"not {img.dtype}")
    src_h, src_w = img.shape[:2]
    if (src_h, src_w) == (height, width):
        return img.copy()
    float_fraction = img.dtype == np.uint8
    x0, x1, fx = _taps(src_w, width, float_fraction, clamp=True)
    y0, y1, fy = _taps(src_h, height, float_fraction, clamp=False)
    cols = (slice(None),) + (None,) * (img.ndim - 2)  # weight per column
    rows = (slice(None), None) + (None,) * (img.ndim - 2)  # per row
    one = np.float32(1)
    if img.dtype == np.uint8:
        def fixed(w):
            return np.rint(w * np.float32(2048)).astype(np.int32)

        src = img.astype(np.int32)
        horiz = (src[:, x0] * fixed(one - fx)[cols]
                 + src[:, x1] * fixed(fx)[cols])
        out = ((((horiz[y0] >> 4) * fixed(one - fy)[rows]) >> 16)
               + (((horiz[y1] >> 4) * fixed(fy)[rows]) >> 16))
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    horiz = src[:, x0] * (one - fx)[cols] + src[:, x1] * fx[cols]
    out = horiz[y0] * (one - fy)[rows] + horiz[y1] * fy[rows]
    if img.dtype == np.uint16:
        return np.clip(np.rint(out), 0, 65535).astype(np.uint16)
    return out


def resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize's INTER_LINEAR: cv2 itself where it imports."""
    if HAVE_CV2:
        return cv2.resize(img, (width, height))
    return resize_linear(img, width, height)


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not png.is_png(data):
        raise IOError(f"cannot read {path}: OpenCV (cv2) is not installed "
                      f"and without it only PNG images can be read")
    return png.decode(data, path)


def read_image_rgb(
    path: str, width: int, height: int, dtype=np.float32
) -> np.ndarray:
    """Colour image -> resized RGB [H, W, 3] in 0..255 (data/scannet.py:
    115-124).

    The decode + resize chain runs entirely in uint8, so values are exact
    integers either way. `dtype=np.uint8` skips the final cast: the eval
    datasets ship uint8 to keep the host->device frame upload at 1/4 the
    float32 bytes (the model casts on the device, bit-identically)."""
    if HAVE_CV2:
        img = cv2.imread(path)
        if img is None:
            raise IOError(f"failed to read image {path}")
        img = cv2.resize(img, (width, height))
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:
        img = _read_png(path)
        # cv2.imread's IMREAD_COLOR: grey to three channels, alpha dropped
        img = (np.repeat(img[..., None], 3, -1) if img.ndim == 2
               else img[..., :3])
        if img.dtype != np.uint8:
            raise IOError(f"{path}: a {img.dtype} colour image; only 8-bit "
                          f"colour PNGs are read without OpenCV")
        img = resize_linear(img, width, height)
    return img if dtype == np.uint8 else img.astype(dtype)


def read_depth_mm(
    path: str, width: int = None, height: int = None
) -> np.ndarray:
    """16-bit png depth in mm -> float32 meters; optional resize
    (data/scannet.py:136-142)."""
    if HAVE_CV2:
        depth = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        if depth is None:
            raise IOError(f"failed to read depth {path}")
    else:
        depth = _read_png(path)
        if depth.ndim != 2:
            raise IOError(f"{path}: a depth PNG must have one channel")
    if width is not None:
        depth = resize(depth, width, height)
    return depth.astype(np.float32) / 1000.0


def read_pose(path: str) -> np.ndarray:
    """4x4 cam-to-world pose from whitespace text (data/scannet.py:127)."""
    pose = np.loadtxt(path).astype(np.float32)
    if pose.shape != (4, 4):
        raise ValueError(f"bad pose shape {pose.shape} in {path}")
    return pose


def pose_is_finite(pose: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(pose)))


def scannet_intrinsics(width: int, height: int) -> np.ndarray:
    """Fixed ScanNet intrinsics scaled from 640x480 (data/scannet.py:83-87)."""
    sw, sh = width / 640.0, height / 480.0
    return np.array(
        [
            [577.87 * sw, 0.0, 319.5 * sw],
            [0.0, 577.87 * sh, 239.5 * sh],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def read_split_file(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]
