"""Peaks of the card and the least work of the port's kernels.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit. The byte and
operation counts of kernels 1 and 2 are copied from `chip_smoke.py`
(commit dd5b5eb, `_plane_sweep_case` and `_frustum_case`): each input byte
read once, each output byte written once; operations per output value and
per voxel as counted there. A count is taken from the op range's argument
shapes, float32 throughout.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
F32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call: the larger of its bytes over the memory
    peak and its operations over the float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def plane_sweep(shapes) -> tuple[float, float]:
    """estdepth::plane_sweep_sample(src [B, H, W, C], x, y [B, D*H*W] or
    [B, D, H, Wo]) -> (bytes, operations)."""
    src, x = shapes[0], shapes[1]
    c = src[-1]
    voxels = math.prod(x)
    out = voxels * c
    return F32 * (math.prod(src) + 2 * voxels + out), out * 9 + voxels * 20


def exact_z(shapes) -> tuple[float, float]:
    """estdepth::exact_z_resample(volume [B, D, H, W, C], zi [B, D, H*W],
    x, y, z [B, D*H*W] or [B, D, H, Wo], ...) -> (bytes, operations)."""
    vol, zi, x = shapes[0], shapes[1], shapes[2]
    c = vol[-1]
    voxels = math.prod(x)
    out = voxels * c
    return (F32 * (math.prod(vol) + math.prod(zi) + 3 * voxels + out),
            out * 32 + voxels * 30)


def roofline_percent(spans, count) -> float | None:
    """100 x the sum of the least times of the calls over the device time
    they took; None where no call ran."""
    bound = sum(bound_s(*count(s.shapes)) for s in spans)
    device_s = sum(s.device_us for s in spans) / 1e6
    if not spans or device_s <= 0:
        return None
    return 100.0 * bound / device_s
