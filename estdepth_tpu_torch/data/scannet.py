"""ScanNet training dataset: overlapping windows of n_frames (the port's own
copy of estdepth_tpu/data/scannet.py; reference data/scannet.py:61-272).

  * scene layout <root>/<scene>/{rgb/%d.jpg, depth/%d.png, pose/%d.txt};
  * every 10th pose id (interval), the scene cut at the first non-finite
    pose;
  * the per-scene index cached next to the data as scene_index.json, in
    the JAX package's format, so each package reads the other's;
  * windows of n_frames starting at i - r for i in range(r, len - r, r // 2)
    (r = n_frames): the effective windows of the reference's
    build_dataset_index_train + read_sample_train;
  * resize to (width, height), BGR->RGB, depth mm->m, validity mask in
    [depth_min, depth_max], more than 50% valid per frame, targets the
    frames 1..V-2;
  * a corrupt sample is replaced by one drawn from the item's generator.

Colour is JPEG, so the cv2 backend needs OpenCV: without it the reader
raises an IOError that names the file (data/io_utils.py), and there is no
other fallback. Samples are channels-last numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from estdepth_tpu_torch.data import io_utils

_CACHE_NAME = "scene_index.json"
BACKENDS = ("auto", "native", "cv2")


def _load_scan(
    scan_path: str, interval: int = 10, use_cache: bool = True,
    reload_scan: bool = False,
) -> Dict[str, List[str]]:
    """{"images", "depths", "poses"}: the paths of every `interval`-th pose
    id of one scene, up to the first non-finite pose, read from or written
    to the scene's scene_index.json."""
    cache = os.path.join(scan_path, _CACHE_NAME)
    if use_cache and os.path.exists(cache) and not reload_scan:
        with open(cache) as f:
            return json.load(f)

    pose_dir = os.path.join(scan_path, "pose")
    ids = sorted(
        int(os.path.basename(p).split(".")[0])
        for p in os.listdir(pose_dir)
        if p.endswith(".txt")
    )
    images, depths, poses = [], [], []
    for i in ids[::interval]:
        pose_file = os.path.join(scan_path, "pose", f"{i}.txt")
        if not np.all(np.isfinite(np.loadtxt(pose_file))):
            break  # the reference cuts the scene at the first bad pose
        poses.append(pose_file)
        images.append(os.path.join(scan_path, "rgb", f"{i}.jpg"))
        depths.append(os.path.join(scan_path, "depth", f"{i}.png"))

    info = {"images": images, "depths": depths, "poses": poses}
    if use_cache:
        try:
            with open(cache, "w") as f:
                json.dump(info, f)
        except OSError:  # a read-only dataset keeps no cache
            pass
    return info


def photometric_augment(
    images: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Gamma, brightness and per-channel colour jitter of a [V, H, W, 3]
    window in 0..255 (the reference's augument(), scannet.py:40-58)."""
    images = np.asarray(images, np.float64)
    gamma = rng.uniform(0.9, 1.1)
    images = 255.0 * (images / 255.0) ** gamma
    images *= rng.uniform(0.8, 1.2)
    images *= rng.uniform(0.8, 1.2, size=3).reshape(1, 1, 1, 3)
    return np.clip(images, 0.0, 255.0).astype(np.float32)


class ScanNetTrainDataset:
    """Map-style dataset of training windows; item i is deterministic in
    (seed, epoch, i) and safe to read from several threads."""

    def __init__(
        self,
        dataset_path: str,
        split_txt: Optional[str] = None,
        height: int = 256,
        width: int = 320,
        n_frames: int = 5,
        depth_min: float = 0.1,
        depth_max: float = 10.0,
        frame_interval: int = 10,
        min_valid_ratio: float = 0.5,
        reload_scan: bool = False,
        seed: int = 0,
        backend: str = "auto",
        augment_prob: float = 0.0,
    ):
        """backend: "native" (the threaded C++ reader, data/native/),
        "cv2", or "auto" (native when it builds, else cv2).

        augment_prob: the probability of the reference's photometric
        augmentation per window. The reference ships it disabled ("it seems
        that augment will influence accuracy", scannet.py:180-183), so the
        default is 0.0; 0.5 is its commented-out recipe."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        self.dataset_path = dataset_path
        self.height = height
        self.width = width
        self.n_frames = n_frames
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.min_valid_ratio = min_valid_ratio
        self.augment_prob = augment_prob
        self.seed = seed
        self._epoch = 0

        if backend == "auto":
            from estdepth_tpu_torch.data import native

            backend = "native" if native.available() else "cv2"
        self.backend = backend

        if split_txt and os.path.exists(split_txt):
            self.scenes = io_utils.read_split_file(split_txt)
        else:
            self.scenes = sorted(os.listdir(dataset_path))

        self.cam_intr = io_utils.scannet_intrinsics(width, height)
        self._build_index(frame_interval, reload_scan)
        if self.backend == "cv2" and not io_utils.HAVE_CV2 and self.index:
            raise IOError(f"cannot read {self.index[0]['images'][0]}: the "
                          f"cv2 backend reads JPEG colour with OpenCV "
                          f"(cv2), which is not installed")

    def _build_index(self, interval: int, reload_scan: bool):
        self.index: List[Dict[str, List[str]]] = []
        r = self.n_frames
        for scan in self.scenes:
            info = _load_scan(os.path.join(self.dataset_path, scan),
                              interval, reload_scan=reload_scan)
            images, depths, poses = (info["images"], info["depths"],
                                     info["poses"])
            for i in range(r, len(images) - r, r // 2):
                s = i - r  # the reference reads the first r of [i-r, i+r]
                self.index.append({"images": images[s:s + r],
                                   "depths": depths[s:s + r],
                                   "poses": poses[s:s + r]})

    def __len__(self) -> int:
        return len(self.index)

    def _read(self, i: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        blob = self.index[i]
        if self.backend == "native":
            from estdepth_tpu_torch.data import native

            imgs, depths, poses = native.read_window(
                blob["images"], blob["depths"], blob["poses"],
                self.width, self.height)
        else:
            imgs = np.stack([io_utils.read_image_rgb(p, self.width,
                                                     self.height)
                             for p in blob["images"]])
            depths = np.stack([io_utils.read_depth_mm(p, self.width,
                                                      self.height)
                               for p in blob["depths"]])
            poses = np.stack([io_utils.read_pose(p) for p in blob["poses"]])

        if not np.all(np.isfinite(poses)):
            raise ValueError(f"non-finite pose in {blob['poses']}")
        masks = ((depths >= self.depth_min) & (depths <= self.depth_max)
                 & np.isfinite(depths))
        depths = np.where(masks, depths, 0.0)
        ratios = masks.reshape(self.n_frames, -1).mean(axis=1)
        if not ratios.min() > self.min_valid_ratio:
            raise ValueError(f"only {ratios.min():.0%} valid depth in "
                             f"{blob['depths']}")
        if self.augment_prob > 0 and rng.uniform() < self.augment_prob:
            imgs = photometric_augment(imgs, rng)
        return {
            "imgs": imgs.astype(np.float32),        # [V, H, W, 3]
            "cam_poses": poses.astype(np.float32),  # [V, 4, 4]
            "cam_intr": self.cam_intr,              # [3, 3]
            # the model is scored on the targets 1..V-2 only
            "dmaps": depths[1:-1].astype(np.float32),  # [T, H, W]
            "dmasks": masks[1:-1],                     # [T, H, W]
        }

    def set_epoch(self, epoch: int) -> None:
        """Fold the epoch into each item's generator (TrainLoader calls
        it), so a corrupt sample's substitute is drawn afresh every epoch,
        as the reference's unseeded resample is, and stays
        deterministic."""
        self._epoch = int(epoch)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        # one generator per item: deterministic in (seed, epoch, index) and
        # not shared between the loader's threads
        rng = np.random.default_rng((self.seed, self._epoch, i))
        # a corrupt sample is replaced by a random one (scannet.py:169-178)
        for _ in range(32):
            try:
                return self._read(i, rng)
            except Exception as e:  # noqa: BLE001 - any unreadable sample
                error = e
                i = int(rng.integers(0, len(self)))
        raise RuntimeError(f"too many consecutive corrupt samples; the last: "
                           f"{error}") from error
