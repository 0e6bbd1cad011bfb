"""Synthetic video-depth scenes with closed-form ground truth (the port's
own numpy copy of estdepth_tpu/data/synthetic.py).

A textured slanted plane rendered from a moving pinhole camera; depth is
analytic, so the eval CLI and the smoke run work without a dataset and
their output can be checked to the pixel. Host-side numpy arrays;
`write_scannet_scene` also writes a scene to disk in ScanNet's layout for
the dataset readers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSceneConfig:
    height: int = 256
    width: int = 320
    # plane: n . X = offset, gently slanted
    plane_normal: tuple = (0.15, -0.1, 1.0)
    plane_offset: float = 2.5
    # camera path: translation step per frame + small yaw
    step_x: float = 0.08
    step_z: float = 0.02
    yaw_per_frame: float = 0.01
    focal: float = 288.935303  # ScanNet fx/2 at 320-wide
    seed: int = 0


def intrinsics(cfg: SyntheticSceneConfig) -> np.ndarray:
    return np.array(
        [
            [cfg.focal, 0.0, (cfg.width - 1) / 2.0],
            [0.0, cfg.focal, (cfg.height - 1) / 2.0],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def pose(cfg: SyntheticSceneConfig, frame: int) -> np.ndarray:
    """Cam-to-world pose [4, 4] of `frame`."""
    yaw = cfg.yaw_per_frame * frame
    c, s = np.cos(yaw), np.sin(yaw)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
    p[0, 3] = cfg.step_x * frame
    p[2, 3] = cfg.step_z * frame
    return p


def render(cfg: SyntheticSceneConfig, cam_pose: np.ndarray):
    """Returns (rgb [H, W, 3] in 0..255, depth [H, W] metric)."""
    k = intrinsics(cfg)
    h, w = cfg.height, cfg.width
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack(
        [xx.ravel(), yy.ravel(), np.ones(h * w)], axis=0
    ).astype(np.float64)
    rays = np.linalg.inv(k) @ pix  # unit-z camera rays
    n = np.asarray(cfg.plane_normal, dtype=np.float64)
    r = cam_pose[:3, :3].astype(np.float64)
    cpos = cam_pose[:3, 3].astype(np.float64)
    dirs = r @ rays
    denom = n @ dirs
    t = (cfg.plane_offset - n @ cpos) / denom  # depth (rays are unit-z)
    world = dirs * t + cpos[:, None]

    phase = cfg.seed * 0.7
    u, v = world[0], world[1]
    rgb = np.stack(
        [
            0.5 + 0.5 * np.sin(3.1 * u + phase) * np.cos(2.3 * v),
            0.5 + 0.5 * np.cos(1.7 * u - 1.1 * v + phase),
            0.5 + 0.25 * np.sin(5.0 * u + 4.0 * v) + 0.25 * np.cos(0.9 * v),
        ],
        axis=-1,
    )
    rgb = (255.0 * np.clip(rgb, 0, 1)).astype(np.float32).reshape(h, w, 3)
    depth = np.where(denom > 1e-6, t, 0.0).astype(np.float32).reshape(h, w)
    return rgb, depth


def synthetic_window(
    cfg: Optional[SyntheticSceneConfig] = None,
    n_frames: int = 5,
    start_frame: int = 0,
    depth_min: float = 0.01,
    depth_max: float = 10.0,
    batch: int = 1,
) -> dict:
    """A window in the model's input format: imgs [B, V, H, W, 3] (0..255),
    cam_poses [B, V, 4, 4] cam-to-world, cam_intr [B, 3, 3], dmaps and
    dmasks [B, T, H, W] of the T = V-2 target frames 1..V-2
    (model_hybrid.py:152-164)."""
    cfg = cfg or SyntheticSceneConfig()
    poses = [pose(cfg, f) for f in range(start_frame, start_frame + n_frames)]
    rendered = [render(cfg, p) for p in poses]
    dmaps = np.stack([d for _, d in rendered])[None, 1:n_frames - 1]
    out = {
        "imgs": np.stack([rgb for rgb, _ in rendered])[None].astype(
            np.float32),
        "cam_poses": np.stack(poses)[None].astype(np.float32),
        "cam_intr": intrinsics(cfg)[None],
        "dmaps": dmaps.astype(np.float32),
        "dmasks": ((dmaps > depth_min) & (dmaps < depth_max)
                   & np.isfinite(dmaps)),
    }
    if batch > 1:
        out = {k: np.repeat(v, batch, axis=0) for k, v in out.items()}
    return out


def synthetic_stream(
    cfg: Optional[SyntheticSceneConfig] = None,
    n_frames: int = 20,
    depth_min: float = 0.01,
    depth_max: float = 10.0,
) -> Iterator[dict]:
    """Per-frame stream for ESTM mode: img, cam_pose, cam_intr, dmap, dmask."""
    cfg = cfg or SyntheticSceneConfig()
    k = intrinsics(cfg)
    for f in range(n_frames):
        p = pose(cfg, f)
        rgb, depth = render(cfg, p)
        mask = (depth > depth_min) & (depth < depth_max) & np.isfinite(depth)
        yield {
            "img": rgb,
            "cam_pose": p,
            "cam_intr": k,
            "dmap": depth,
            "dmask": mask,
        }


def write_scannet_scene(folder: str, cfg: SyntheticSceneConfig,
                        poses) -> None:
    """Render one frame per cam-to-world pose [4, 4] into `folder` in the
    ScanNet layout the eval datasets read: rgb/<i>.png (8-bit RGB),
    depth/<i>.png (16-bit millimetres), pose/<i>.txt. A pose that is not
    finite is written as it is, beside the identity pose's images: the
    datasets skip such a frame. PNGs are written by data/png.py, so no
    OpenCV is needed."""
    from estdepth_tpu_torch.data import png

    for sub in ("rgb", "depth", "pose"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i, p in enumerate(poses):
        p = np.asarray(p, np.float32)
        rgb, depth = render(cfg, p if np.isfinite(p).all() else np.eye(4))
        png.write(os.path.join(folder, "rgb", f"{i}.png"),
                  rgb.astype(np.uint8))
        png.write(os.path.join(folder, "depth", f"{i}.png"),
                  np.clip(np.rint(depth * 1000.0), 0, 65535).astype(
                      np.uint16))
        np.savetxt(os.path.join(folder, "pose", f"{i}.txt"), p)


def write_scannet_train_scene(folder: str, cfg: SyntheticSceneConfig,
                              poses, interval: int = 10) -> list[str]:
    """One scene in ScanNet's training layout, which the training dataset
    reads: pose/<i>.txt for every cam-to-world pose [4, 4], and for every
    `interval`-th id (those the dataset samples) the rendered colour as
    rgb/<i>.jpg (through OpenCV, default quality) and depth/<i>.png
    (16-bit millimetres). Returns the paths of the JPEGs written."""
    import cv2

    from estdepth_tpu_torch.data import png

    for sub in ("rgb", "depth", "pose"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    written = []
    for i, p in enumerate(poses):
        p = np.asarray(p, np.float32)
        np.savetxt(os.path.join(folder, "pose", f"{i}.txt"), p)
        if i % interval:
            continue
        rgb, depth = render(cfg, p)
        path = os.path.join(folder, "rgb", f"{i}.jpg")
        cv2.imwrite(path, cv2.cvtColor(rgb.astype(np.uint8),
                                       cv2.COLOR_RGB2BGR))
        png.write(os.path.join(folder, "depth", f"{i}.png"),
                  np.clip(np.rint(depth * 1000.0), 0, 65535).astype(
                      np.uint16))
        written.append(path)
    return written
