"""Window-based (Joint mode) evaluation dataset for 7-Scenes and ScanNet-test
(the port's own copy of estdepth_tpu/data/eval_windows.py).

Behavioral equivalent of SevenScenes + prepare_seqs (the reference's
data/general_eval.py:24-241): per scene, builds
`seq_length`-frame windows with frame spacing `frame_interval` and window
stride `seq_inter * frame_interval`, skipping windows containing non-finite
poses. Supports the 7-Scenes layout (frame-%06d.{color,depth,pose}) and the
ScanNet layout (rgb/ depth/ pose/, general_eval_seq.py:36-59).

GT depth is kept at native resolution (the reference does not resize eval
depth, general_eval.py:206-207); score with
eval/metric_offline.compute_errors after resizing predictions to the GT.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from estdepth_tpu_torch.data import io_utils

SEVEN_SCENES_TEST_SEQS: List[Tuple[str, str]] = [
    ("chess", "seq-03"), ("chess", "seq-05"),
    ("fire", "seq-03"), ("fire", "seq-04"),
    ("heads", "seq-01"),
    ("office", "seq-02"), ("office", "seq-06"),
    ("office", "seq-07"), ("office", "seq-09"),
    ("pumpkin", "seq-01"), ("pumpkin", "seq-07"),
    ("redkitchen", "seq-03"), ("redkitchen", "seq-04"),
    ("redkitchen", "seq-06"), ("redkitchen", "seq-12"),
    ("redkitchen", "seq-14"),
    ("stairs", "seq-01"), ("stairs", "seq-04"),
]


def _frame_paths(folder: str, scannet_layout: bool):
    """Discover (img, depth, pose) path triplets, naturally sorted."""
    if scannet_layout:
        img_names = io_utils.natsorted(glob.glob(os.path.join(folder, "rgb/*")))
        dmap_names = io_utils.natsorted(glob.glob(os.path.join(folder, "depth/*")))
    else:
        img_names = io_utils.natsorted(
            glob.glob(os.path.join(folder, "*.color.*"))
        )
        dmap_names = [
            x
            for x in io_utils.natsorted(glob.glob(os.path.join(folder, "*.depth.*")))
            if "colored" not in x
        ]
    if not img_names:
        raise FileNotFoundError(f"no frames under {folder}")
    img_ext = os.path.splitext(img_names[0])[1]
    dmap_ext = os.path.splitext(dmap_names[0])[1]

    triplets = []
    for name in img_names:
        idx = int(re.findall(r"\d+", os.path.basename(name))[0])
        if scannet_layout:
            triplets.append(
                (
                    os.path.join(folder, f"rgb/{idx}{img_ext}"),
                    os.path.join(folder, f"depth/{idx}{dmap_ext}"),
                    os.path.join(folder, f"pose/{idx}.txt"),
                )
            )
        else:
            triplets.append(
                (
                    os.path.join(folder, f"frame-{idx:06d}.color{img_ext}"),
                    os.path.join(folder, f"frame-{idx:06d}.depth{dmap_ext}"),
                    os.path.join(folder, f"frame-{idx:06d}.pose.txt"),
                )
            )
    return triplets


def build_windows(
    folder: str,
    seq_length: int,
    frame_interval: int,
    seq_inter: int,
    scannet_layout: bool,
    eval_all: bool = False,
) -> List[List[Tuple[str, str, str]]]:
    """Windows of seq_length frames spaced frame_interval apart, window
    start stride seq_inter (general_eval.py:51-72).

    eval_all: also enumerate windows from every start offset in
    [0, frame_interval) — the reference's --eval_all densification
    (general_eval.py:46-50, start_indexs=interval)."""
    triplets = _frame_paths(folder, scannet_layout)
    num = len(triplets)
    windows = []
    starts = range(frame_interval) if eval_all else range(1)
    for start_i in starts:
        for start in range(start_i, num - seq_length * frame_interval,
                           seq_inter):
            window = [
                triplets[start + s * frame_interval]
                for s in range(seq_length)
            ]
            if all(
                io_utils.pose_is_finite(np.loadtxt(t[2])) for t in window
            ):
                windows.append(window)
    return windows


class WindowEvalDataset:
    """Joint-mode eval windows for one scene at a time (reset per scene)."""

    def __init__(
        self,
        data_dir: str,
        height: int = 256,
        width: int = 320,
        depth_min: float = 0.3,
        depth_max: float = 5.0,
        seq_length: int = 5,
        frame_interval: int = 10,
        seq_inter: Optional[int] = None,
        scannet_layout: bool = False,
        eval_all: bool = False,
    ):
        self.data_dir = data_dir
        self.height = height
        self.width = width
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.seq_length = seq_length
        self.frame_interval = frame_interval
        # reference default: windows advance by (seq_len-2) frames so target
        # frames tile the video (eval_hybrid.py:76-78)
        self.seq_inter = (
            seq_inter
            if seq_inter is not None
            else (seq_length - 2) * frame_interval
        )
        self.scannet_layout = scannet_layout
        self.eval_all = eval_all
        self.cam_intr = io_utils.scannet_intrinsics(width, height)
        self.windows: List[List[Tuple[str, str, str]]] = []

    def reset(self, scene: str, seq: Optional[str] = None):
        folder = os.path.join(
            self.data_dir, scene if seq is None else f"{scene}/{seq}"
        )
        self._folder = folder
        self.windows = build_windows(
            folder, self.seq_length, self.frame_interval, self.seq_inter,
            self.scannet_layout, self.eval_all,
        )

    def sequence(self, max_windows: Optional[int] = None):
        """The scene's sampled-frame sequence + window grid, for scan-mode
        evaluation (tools/eval_joint.py --scan): every window is a
        seq_length-slice of this sequence at a uniform stride, so the whole
        chain runs through one eval/sequence.make_joint_processor call.

        Returns None when the window chain is NOT a gapless uniform grid —
        pose-skipped windows (build_windows drops them, leaving gaps the
        scan cannot express), --eval_all multi-offset enumeration, or a
        seq_inter that is not a multiple of frame_interval — and the
        caller falls back to the per-window loop.

        Result dict: imgs [T, H, W, 3] / poses [T, 4, 4] / cam_intr [3, 3]
        (T sampled frames, spaced frame_interval apart), window_stride (in
        sampled frames), n_windows, and dmap_paths (GT read lazily at
        scoring time — native-resolution depth for a whole scene is too
        large to materialize up front).
        """
        if self.eval_all or self.seq_inter % self.frame_interval != 0:
            return None
        stride = self.seq_inter // self.frame_interval
        triplets = _frame_paths(self._folder, self.scannet_layout)
        num = len(triplets)
        expected = len(
            range(0, num - self.seq_length * self.frame_interval,
                  self.seq_inter)
        )
        if expected == 0 or len(self.windows) != expected:
            return None  # pose-skipped windows -> gapped chain
        n_windows = expected
        if max_windows:
            n_windows = min(n_windows, max_windows)
        t = (n_windows - 1) * stride + self.seq_length
        imgs, poses, dmap_paths = [], [], []
        for k in range(t):
            img_path, dmap_path, pose_path = triplets[k * self.frame_interval]
            imgs.append(
                io_utils.read_image_rgb(img_path, self.width, self.height)
            )
            poses.append(io_utils.read_pose(pose_path))
            dmap_paths.append(dmap_path)
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "cam_poses": np.stack(poses).astype(np.float32),
            "cam_intr": self.cam_intr,
            "dmap_paths": dmap_paths,
            "window_stride": stride,
            "n_windows": n_windows,
        }

    def read_gt(self, dmap_path: str):
        """Native-resolution GT depth + validity mask (same masking as
        __getitem__)."""
        dmap = io_utils.read_depth_mm(dmap_path)
        mask = (
            (dmap >= self.depth_min)
            & (dmap <= self.depth_max)
            & np.isfinite(dmap)
        )
        return np.where(mask, dmap, 0.0).astype(np.float32), mask

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        imgs, poses, dmaps, dmasks, paths = [], [], [], [], []
        for img_path, dmap_path, pose_path in self.windows[i]:
            imgs.append(io_utils.read_image_rgb(img_path, self.width, self.height))
            poses.append(io_utils.read_pose(pose_path))
            dmap = io_utils.read_depth_mm(dmap_path)  # native resolution
            mask = (
                (dmap >= self.depth_min)
                & (dmap <= self.depth_max)
                & np.isfinite(dmap)
            )
            dmaps.append(np.where(mask, dmap, 0.0))
            dmasks.append(mask)
            paths.append(img_path)
        return {
            "imgs": np.stack(imgs)[None].astype(np.float32),
            "cam_poses": np.stack(poses)[None].astype(np.float32),
            "cam_intr": self.cam_intr[None],
            "dmaps": np.stack(dmaps[1:-1])[None].astype(np.float32),
            "dmasks": np.stack(dmasks[1:-1])[None],
            "img_paths": paths,
        }
