"""Fuse dumped depth maps into a world-frame colored point cloud (.ply;
counterpart of tools/export_pointcloud.py).

Entry point for the reference's point-cloud utilities (its
utils/utils.py:262-311 generate_pointcloud/local_pcd),
which ship without an entry point: take the per-frame depth `.npy` dumps
produced by tools/eval_estm.py (stream-indexed; the joint tool's
window-indexed dumps cannot be matched to poses here), back-project each
through its camera pose, and write one fused ASCII PLY colored by the RGB
frames.

Usage:
  python -m estdepth_tpu_torch.tools.export_pointcloud --preddir out/ \
      --datapath /data/scannet --scene scene0707_00 --out scene0707_00.ply
  python -m estdepth_tpu_torch.tools.export_pointcloud --preddir out/ \
      --synthetic --scene synthetic0 --out cloud.ply
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from estdepth_tpu_torch.data.io_utils import resize
from estdepth_tpu_torch.tools.gt_stream import gt_frames
from estdepth_tpu_torch.utils.pointcloud import write_ply


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preddir", type=str, required=True,
                   help="directory of <scene>_<idx>_depth.npy dumps (or the "
                        "reference layout <scene>/refined_depth/<idx>.npy)")
    p.add_argument("--scene", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--datapath", type=str, default=None)
    p.add_argument("--eval-dataset", choices=["scannet", "7scenes"],
                   default="scannet")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--frame-interval", type=int, default=10)
    p.add_argument("--start-index", type=int, default=0,
                   help="MUST match the eval run's --start-index (dump "
                        "indices are positions in the offset stream)")
    p.add_argument("--min-depth", type=float, default=0.3)
    p.add_argument("--max-depth", type=float, default=5.0)
    p.add_argument("--stride", type=int, default=4,
                   help="pixel subsampling stride per frame")
    p.add_argument("--max-frames", type=int, default=None)
    return p.parse_args(argv)


def _pred(preddir, scene, idx):
    flat = os.path.join(preddir, f"{scene}_{idx:06d}_depth.npy")
    if os.path.exists(flat):
        return flat
    ref = os.path.join(preddir, scene, "refined_depth", f"{idx:06d}.npy")
    return ref if os.path.exists(ref) else None


def _frames(args):
    yield from gt_frames(
        args.scene, synthetic=args.synthetic, datapath=args.datapath,
        eval_dataset=args.eval_dataset, height=args.height,
        width=args.width, frame_interval=args.frame_interval,
        start_index=args.start_index,
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.synthetic and not args.datapath:
        raise SystemExit("need --datapath (or --synthetic) for poses/RGB")

    all_pts, all_rgb = [], []
    n_frames = 0
    for idx, f in _frames(args):
        path = _pred(args.preddir, args.scene, idx)
        if path is None:
            continue
        depth = np.load(path).astype(np.float32)
        img = np.asarray(f["img"], np.float32)
        if depth.shape != img.shape[:2]:
            depth = resize(depth, img.shape[1], img.shape[0])
        s = args.stride
        depth_s = depth[::s, ::s]
        rgb_s = img[::s, ::s].reshape(-1, 3)
        # back-project the subsampled grid: pixel (i, j) sits at (i*s, j*s)
        # in the full-resolution intrinsics' frame (utils.py:262-285)
        intr = np.asarray(f["cam_intr"], np.float64)
        h2, w2 = depth_s.shape
        yy, xx = np.meshgrid(
            np.arange(h2) * s, np.arange(w2) * s, indexing="ij"
        )
        pix = np.stack([xx.ravel(), yy.ravel(), np.ones(h2 * w2)])
        rays = np.linalg.inv(intr) @ pix
        pts_cam = rays * depth_s.ravel()
        pose = np.asarray(f["cam_pose"], np.float64)
        pts = (pose[:3, :3] @ pts_cam + pose[:3, 3:4]).T

        valid = (depth_s.ravel() > args.min_depth) & (
            depth_s.ravel() < args.max_depth
        )
        all_pts.append(pts[valid])
        all_rgb.append(np.clip(rgb_s[valid], 0, 255).astype(np.uint8))
        n_frames += 1
        if args.max_frames and n_frames >= args.max_frames:
            break

    if not all_pts:
        raise SystemExit(f"no predictions for scene {args.scene}")
    pts = np.concatenate(all_pts)
    rgb = np.concatenate(all_rgb)
    write_ply(args.out, pts, rgb)
    print(f"wrote {args.out}: {len(pts)} points from {n_frames} frames")


if __name__ == "__main__":
    main()
