"""Point-cloud export + depth inpainting extras (the port's own copy of
estdepth_tpu/utils/pointcloud.py).

Behavioral equivalents of the reference's misc utilities:
generate_pointcloud / local_pcd (the reference's utils/utils.py:262-311)
and fill_depth (its data/scannet.py:30-39).
"""

from __future__ import annotations

import numpy as np


def backproject_depth(
    depth: np.ndarray, cam_intr: np.ndarray, cam_pose: np.ndarray = None
) -> np.ndarray:
    """[H, W] depth -> [N, 3] world (or camera) points (utils.py:262-285)."""
    h, w = depth.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    pts = (np.linalg.inv(cam_intr) @ pix) * depth.ravel()
    if cam_pose is not None:
        pts = cam_pose[:3, :3] @ pts + cam_pose[:3, 3:4]
    return pts.T


def write_ply(
    path: str, points: np.ndarray, colors: np.ndarray = None
) -> None:
    """ASCII PLY writer (utils.py:288-311). points [N,3], colors [N,3] u8."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.6f} {points[i, 1]:.6f} {points[i, 2]:.6f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def fill_depth_nearest(depth: np.ndarray) -> np.ndarray:
    """Nearest-neighbor inpaint of zero/invalid depth (scannet.py:30-39),
    without the scipy dependency (BFS dilation)."""
    out = depth.copy()
    invalid = out <= 0
    if not invalid.any() or invalid.all():
        return out
    while invalid.any():
        shifted = []
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            s = np.roll(out, (dy, dx), axis=(0, 1))
            m = np.roll(~invalid, (dy, dx), axis=(0, 1))
            # roll wraps; mask the wrapped border
            if dy == 1:
                m[0, :] = False
            if dy == -1:
                m[-1, :] = False
            if dx == 1:
                m[:, 0] = False
            if dx == -1:
                m[:, -1] = False
            shifted.append((s, m))
        fill = np.zeros_like(out)
        cnt = np.zeros_like(out)
        for s, m in shifted:
            fill = np.where(m & invalid, fill + s, fill)
            cnt = np.where(m & invalid, cnt + 1, cnt)
        newly = invalid & (cnt > 0)
        out = np.where(newly, fill / np.maximum(cnt, 1), out)
        invalid = invalid & ~newly
    return out
