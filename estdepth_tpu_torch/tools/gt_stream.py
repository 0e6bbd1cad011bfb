"""Shared ground-truth stream resolver for the offline tools (counterpart of
tools/_gt_stream.py).

tools/score_offline.py and tools/export_pointcloud.py both need to map a
dump file's stream index back to the ground-truth frame it was produced
from. That mapping must replay the EXACT subsampling the eval run used —
including --frame-interval and --start-index — or every prediction is
silently compared against a neighboring frame's GT/pose.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np

from estdepth_tpu_torch.data.eval_stream import StreamEvalDataset
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream,
)


def gt_frames(
    scene: str,
    *,
    synthetic: bool,
    datapath: str,
    eval_dataset: str,
    height: int,
    width: int,
    frame_interval: int,
    start_index: int = 0,
    depth_min: float = 0.3,
    depth_max: float = 5.0,
    n_synthetic: int = 64,
) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """(stream_index, frame) pairs for one scene, replaying the eval run's
    subsampling protocol."""
    if synthetic:
        m = re.match(r"synthetic(\d+)", scene)
        cfg = SyntheticSceneConfig(
            height=height, width=width,
            seed=int(m.group(1)) if m else 0,
        )
        yield from enumerate(synthetic_stream(cfg, n_frames=n_synthetic))
        return

    ds = StreamEvalDataset(
        datapath, height, width,
        depth_min=depth_min, depth_max=depth_max,
        frame_interval=frame_interval,
        scannet_layout=eval_dataset == "scannet",
        start_index=start_index,
    )
    if eval_dataset == "7scenes" and "_seq-" in scene:
        base, seq = scene.rsplit("_", 1)
        ds.reset(base, seq)
    else:
        ds.reset(scene)
    yield from enumerate(iter(ds))
