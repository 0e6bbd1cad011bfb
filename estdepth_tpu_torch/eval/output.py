"""Output trimming shared by the eval runners (port of
estdepth_tpu/eval/output.py): return only the depth scales a consumer
reads, optionally downcast, and read them on the host.

The scales' index is made on the host and copied to the device inside
`host_wait.constant` (utils/trace.py)."""

from __future__ import annotations

import torch

from estdepth_tpu_torch.utils import trace

FULL_SCALES = (0, 1, 2, 3)


def trim_depth(depth: torch.Tensor, output_scales,
               output_dtype) -> torch.Tensor:
    """depth [B, 4, H, W] -> [B, len(output_scales), H, W] (+ cast)."""
    if tuple(output_scales) != FULL_SCALES:
        with trace.host_wait("constant"):
            depth = depth[:, list(output_scales)]
    if output_dtype is not None:
        depth = depth.to(output_dtype)
    return depth


def to_numpy(t: torch.Tensor):
    """A host tensor as a numpy array. numpy has no bfloat16: a bfloat16
    tensor (a `output_dtype=torch.bfloat16` fetch, half the bytes of the
    copy) becomes float32 here, on the host, after the copy."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
