"""Depth / probability colorization for dumps (the port's own copy of
estdepth_tpu/utils/viz.py).

Behavioral equivalent of the reference's utils/misc_utils.py:6-59 (cv2
COLORMAP_RAINBOW over a normalized map). Host-side numpy. Where OpenCV
does not import, the colours come from a numpy ramp and `save_image`
writes a PNG with the port's own encoder (data/png.py) under the same
stem; the .npy maps, which are what gets scored, are the same either way.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

from estdepth_tpu_torch.data import png

try:
    import cv2

    HAVE_CV2 = True
except ImportError:
    cv2 = None
    HAVE_CV2 = False


def _rainbow(norm: np.ndarray) -> np.ndarray:
    u8 = (255.0 * np.clip(norm, 0.0, 1.0)).astype(np.uint8)
    if HAVE_CV2:
        bgr = cv2.applyColorMap(u8, cv2.COLORMAP_RAINBOW)
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    # numpy fallback: simple HSV-ish ramp
    h = u8.astype(np.float32) / 255.0
    r = np.clip(1.5 - np.abs(4 * h - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * h - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * h - 1), 0, 1)
    return (255 * np.stack([r, g, b], -1)).astype(np.uint8)


def colorize_depth(
    depth: np.ndarray, depth_min: float = None, depth_max: float = None
) -> np.ndarray:
    """[H, W] metric depth -> RGB uint8 (misc_utils.py:6-38)."""
    depth = np.asarray(depth, dtype=np.float32)
    dmin = float(np.nanmin(depth)) if depth_min is None else depth_min
    dmax = float(np.nanmax(depth)) if depth_max is None else depth_max
    norm = (depth - dmin) / max(dmax - dmin, 1e-6)
    return _rainbow(norm)


def colorize_probmap(prob: np.ndarray) -> np.ndarray:
    """[H, W] probability in [0,1] -> RGB uint8 (misc_utils.py:41-59)."""
    return _rainbow(np.asarray(prob, dtype=np.float32))


@functools.cache
def _say_png_once() -> None:
    print("viz: OpenCV (cv2) is not installed; colorized images are "
          "written as .png", file=sys.stderr)


def save_image(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image. Without OpenCV it goes to `path` with a
    .png suffix, through data/png.py."""
    if HAVE_CV2:
        cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        return
    _say_png_once()
    png.write(os.path.splitext(path)[0] + ".png",
              np.ascontiguousarray(rgb, dtype=np.uint8))
