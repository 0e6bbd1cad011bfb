"""Synthetic scenes from the seed: the benchmark's traffic generator.

A copy of `estdepth_tpu_torch/data/synthetic.py` (commit dd5b5eb): a
textured slanted plane seen by a pinhole camera that moves along a path,
with closed-form depth. The arithmetic is the same (float64, rays at unit
depth, the texture's three sinusoids); it runs on the device, one call per
scene, so set-up renders hundreds of frames in well under a second. The
seed draws each scene's texture phase and plane offset; the camera path,
the frame size and the counts are the traffic mix's, the same for every
seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Path:
    """The camera path and plane of a mix (traffic/<mix>.json, "scene")."""

    height: int = 256
    width: int = 320
    frames: int = 100
    step_x: float = 0.08  # metres per frame
    step_z: float = 0.0
    yaw_per_frame: float = 0.01  # radians per frame
    plane_normal: tuple = (0.15, -0.1, 1.0)
    plane_offset: tuple = (2.0, 3.0)  # drawn uniformly per scene
    focal: float = 288.935303  # ScanNet fx/2 at 320 wide


def intrinsics(p: Path) -> np.ndarray:
    return np.array([[p.focal, 0.0, (p.width - 1) / 2.0],
                     [0.0, p.focal, (p.height - 1) / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def poses(p: Path, n: int) -> np.ndarray:
    """Cam-to-world poses [n, 4, 4] of frames 0..n-1."""
    yaw = p.yaw_per_frame * np.arange(n)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    out[:, 0, 0], out[:, 0, 2], out[:, 2, 0], out[:, 2, 2] = c, s, -s, c
    out[:, 0, 3] = p.step_x * np.arange(n)
    out[:, 2, 3] = p.step_z * np.arange(n)
    return out


def render(p: Path, cam_poses: np.ndarray, phase: float, offset: float,
           device) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 frames [n, H, W, 3], depth [n, H, W] float32) of the plane
    n . X = offset seen from cam_poses [n, 4, 4]."""
    f64 = dict(dtype=torch.float64, device=device)
    k = torch.as_tensor(intrinsics(p), **f64)
    yy, xx = torch.meshgrid(torch.arange(p.height, **f64),
                            torch.arange(p.width, **f64), indexing="ij")
    pix = torch.stack([xx.reshape(-1), yy.reshape(-1),
                       torch.ones_like(xx).reshape(-1)], 0)
    rays = torch.linalg.inv(k) @ pix
    cp = torch.as_tensor(cam_poses, **f64)
    n = torch.tensor(p.plane_normal, **f64)
    dirs = cp[:, :3, :3] @ rays  # [n, 3, HW]
    denom = torch.einsum("c,ncp->np", n, dirs)
    t = (offset - cp[:, :3, 3] @ n)[:, None] / denom
    world = dirs * t[:, None] + cp[:, :3, 3, None]
    u, v = world[:, 0], world[:, 1]
    rgb = torch.stack([
        0.5 + 0.5 * torch.sin(3.1 * u + phase) * torch.cos(2.3 * v),
        0.5 + 0.5 * torch.cos(1.7 * u - 1.1 * v + phase),
        0.5 + 0.25 * torch.sin(5.0 * u + 4.0 * v) + 0.25 * torch.cos(0.9 * v),
    ], -1)
    frames = (255.0 * rgb.clamp(0, 1)).to(torch.uint8)
    depth = torch.where(denom > 1e-6, t, torch.zeros_like(t)).float()
    shape = (cam_poses.shape[0], p.height, p.width)
    return (frames.reshape(*shape, 3).cpu().numpy(),
            depth.reshape(shape).cpu().numpy())


@dataclasses.dataclass
class Scene:
    frames: np.ndarray  # uint8 [n, H, W, 3]
    poses: np.ndarray  # float32 [n, 4, 4]
    intr: np.ndarray  # float32 [3, 3]
    depth: np.ndarray  # float32 [n, H, W]


def make_scenes(p: Path, count: int, seed: int, device) -> list[Scene]:
    """`count` scenes of p.frames frames, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    cam = poses(p, p.frames)
    out = []
    for _ in range(count):
        phase = float(rng.uniform(0.0, 2.0 * np.pi))
        offset = float(rng.uniform(*p.plane_offset))
        frames, depth = render(p, cam, phase, offset, device)
        out.append(Scene(frames, cam, intrinsics(p), depth))
    return out
