"""The port's correlation kernel (`csrc/view_correlation.cu`, op
`estdepth::view_correlation`) in TransMVSNet's cost volumes: 100 x the
least time of its calls (bytes at 3.35 TB/s: the reference [B, H, W, C]
and the swept volume [B, D, H, W, C] read once, the correlation
[B, D, H, W] written once; no operation counted, from the op's two
argument shapes) over the device time inside its op ranges, in %. A port
without the op has no such range, and the metric reads None."""

import math

from portbench.harness import rooflines


def view_correlation(shapes) -> tuple[float, float]:
    """estdepth::view_correlation(ref [B, H, W, C], warped
    [B, D, H, W, C]) -> (bytes, operations)."""
    ref, warped = shapes[0], shapes[1]
    return (rooflines.F32 * (math.prod(ref) + math.prod(warped)
                             + math.prod(warped[:-1])), 0.0)


def read(r):
    if r.protocol != "mvs_views_wta":
        return None
    spans = [s for s in r.trace.spans
             if s.name == "estdepth::view_correlation"
             and not s.nested_in_same and len(s.shapes) > 1
             and len(s.shapes[0]) == 4 and len(s.shapes[1]) == 5]
    return rooflines.roofline_percent(spans, view_correlation)
