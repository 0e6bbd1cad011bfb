"""Output trimming shared by the eval runners (port of
estdepth_tpu/eval/output.py): return only the depth scales a consumer
reads, optionally downcast."""

from __future__ import annotations

import torch

FULL_SCALES = (0, 1, 2, 3)


def trim_depth(depth: torch.Tensor, output_scales,
               output_dtype) -> torch.Tensor:
    """depth [B, 4, H, W] -> [B, len(output_scales), H, W] (+ cast)."""
    if tuple(output_scales) != FULL_SCALES:
        depth = depth[:, list(output_scales)]
    if output_dtype is not None:
        depth = depth.to(output_dtype)
    return depth
