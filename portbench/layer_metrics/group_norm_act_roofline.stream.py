"""The port's GroupNorm-and-activation kernel (`csrc/group_norm_act.cu`,
op `estdepth::group_norm_act`) in the EST GRU of the ESTM stream: 100 x the least
time of its calls (bytes at 3.35 TB/s: x read once and the output
written once, float32 as every ESTDepth cell runs, and the float32
weight and bias; no operation counted, from the op's argument shapes)
over the device time inside its op ranges, in %. A port without the op
has no such range, and the metric reads None."""

import math

from portbench.harness import rooflines


def group_norm_act(shapes) -> tuple[float, float]:
    """estdepth::group_norm_act(x [N, C, *S], weight [C], bias [C], ...)
    -> (bytes, operations)."""
    x, weight = shapes[0], shapes[1]
    return rooflines.F32 * (2 * math.prod(x) + 2 * math.prod(weight)), 0.0


def read(r):
    if r.protocol != "estm_stream":
        return None
    spans = [s for s in r.trace.spans
             if s.name == "estdepth::group_norm_act"
             and not s.nested_in_same and len(s.shapes) > 1
             and len(s.shapes[0]) >= 2 and len(s.shapes[1]) == 1]
    return rooflines.roofline_percent(spans, group_norm_act)
