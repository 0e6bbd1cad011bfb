"""Keyframe evaluation dataset: 5 frames around a listed (scene, index) (the
port's own copy of estdepth_tpu/data/keyframe_eval.py).

Behavioral equivalent of ScannetTestDataset (the reference's
data/scannet_select.py:51-144): each entry of the list
file names a scene and a keyframe index; the window is
[index-10, index, index-20, index-30, index-40] (or +offsets when
index < 10, :79-82), ScanNet rgb/depth/pose layout, depth resized like the
train reader. Not used by the reference's shipped eval scripts, but part of
its public dataset API (SURVEY.md §2.2).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from estdepth_tpu_torch.data import io_utils


def read_keyframe_list(path: str) -> List[Tuple[str, int]]:
    """Lines of `scene index`."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], int(parts[1])))
    return out


class KeyframeEvalDataset:
    def __init__(
        self,
        dataset_path: str,
        test_listfile: str,
        height: int = 256,
        width: int = 320,
        depth_min: float = 0.1,
        depth_max: float = 10.0,
    ):
        self.dataset_path = dataset_path
        self.height = height
        self.width = width
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.entries = read_keyframe_list(test_listfile)
        self.cam_intr = io_utils.scannet_intrinsics(width, height)

    def __len__(self):
        return len(self.entries)

    @staticmethod
    def window_indices(index: int) -> List[int]:
        if index < 10:
            return [index + 10, index, index + 20, index + 30, index + 40]
        return [index - 10, index, index - 20, index - 30, index - 40]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        scene, index = self.entries[i]
        sp = os.path.join(self.dataset_path, scene)
        imgs, poses, dmaps, dmasks, paths = [], [], [], [], []
        for f in self.window_indices(index):
            img_path = os.path.join(sp, "rgb", f"{f}.jpg")
            paths.append(img_path)
            imgs.append(
                io_utils.read_image_rgb(img_path, self.width, self.height)
            )
            poses.append(io_utils.read_pose(os.path.join(sp, "pose", f"{f}.txt")))
            depth = io_utils.read_depth_mm(
                os.path.join(sp, "depth", f"{f}.png"), self.width, self.height
            )
            mask = (
                (depth >= self.depth_min)
                & (depth <= self.depth_max)
                & np.isfinite(depth)
            )
            dmaps.append(np.where(mask, depth, 0.0))
            dmasks.append(mask)
        poses = np.stack(poses).astype(np.float32)
        if not np.all(np.isfinite(poses)):
            raise ValueError(f"{scene} {index}: a pose of the keyframe "
                             f"window is not finite")
        return {
            "imgs": np.stack(imgs)[None].astype(np.float32),
            "cam_poses": poses[None],
            "cam_intr": self.cam_intr[None],
            "dmaps": np.stack(dmaps[1:-1])[None].astype(np.float32),
            "dmasks": np.stack(dmasks[1:-1])[None],
            "scene": scene,
            "index": index,
            "img_paths": paths,  # reference 'img_path' (scannet_select.py:139)
        }
