"""Per-frame streaming evaluation dataset (ESTM mode; the port's own copy of
estdepth_tpu/data/eval_stream.py).

Behavioral equivalent of SevenScenesSeq + prepare_seqs (the reference's
data/general_eval_seq.py:24-223): yields one frame per
step, every `frame_interval`-th frame of a scene, skipping frames with
non-finite poses; supports 7-Scenes and ScanNet layouts.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from estdepth_tpu_torch.data import io_utils
from estdepth_tpu_torch.data.eval_windows import _frame_paths


class StreamEvalDataset:
    def __init__(
        self,
        data_dir: str,
        height: int = 256,
        width: int = 320,
        depth_min: float = 0.01,
        depth_max: float = 5.0,
        frame_interval: int = 10,
        scannet_layout: bool = True,
        start_index: int = 0,
    ):
        """start_index: offset of the first subsampled frame — the
        reference's start_i (general_eval_seq.py:48-49)."""
        self.data_dir = data_dir
        self.start_index = start_index
        self.height = height
        self.width = width
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.frame_interval = frame_interval
        self.scannet_layout = scannet_layout
        self.cam_intr = io_utils.scannet_intrinsics(width, height)
        self.frames = []

    def reset(self, scene: str, seq: Optional[str] = None):
        folder = os.path.join(
            self.data_dir, scene if seq is None else f"{scene}/{seq}"
        )
        triplets = _frame_paths(folder, self.scannet_layout)
        self.frames = []
        for t in triplets[self.start_index :: self.frame_interval]:
            if io_utils.pose_is_finite(np.loadtxt(t[2])):
                self.frames.append(t)

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for img_path, dmap_path, pose_path in self.frames:
            # uint8: 1/4 the host->device upload; models cast on device
            img = io_utils.read_image_rgb(
                img_path, self.width, self.height, dtype=np.uint8
            )
            pose = io_utils.read_pose(pose_path)
            dmap = io_utils.read_depth_mm(dmap_path)  # native resolution
            mask = (
                (dmap >= self.depth_min)
                & (dmap <= self.depth_max)
                & np.isfinite(dmap)
            )
            yield {
                "img": img,
                "cam_pose": pose,
                "cam_intr": self.cam_intr,
                "dmap": np.where(mask, dmap, 0.0).astype(np.float32),
                "dmask": mask,
                "img_path": img_path,
            }
