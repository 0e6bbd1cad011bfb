"""The port's variance kernel (`csrc/view_variance.cu`, op
`estdepth::view_variance`) in CasMVSNet's cost volumes: 100 x the least
time of its calls (bytes at 3.35 TB/s: the reference [B, H, W, C] and the
V - 1 swept volumes [B, D, H, W, C] read once, the variance
[B, C, D, H, W] written once; no operation counted) over the device time
inside its op ranges, in %.

The profiler records the op's list of volumes with no shapes (an empty
entry after the reference's), so a call's volumes are read from the
sweeps that made them: the `estdepth::plane_sweep_sample` ranges (kernel
1) in the same `estdepth::mvs_cost_volume` span before the call, whose
source map has the reference's shape [B, H, W, C] and whose coordinates
name the D planes. A call without them counts for nothing (a port without
the op has no such range, and the metric reads None)."""

import dataclasses
import math

from portbench.harness import rooflines


def view_variance(shapes) -> tuple[float, float]:
    """estdepth::view_variance(ref [B, H, W, C], V - 1 volumes
    [B, D, H, W, C]) -> (bytes, operations): each input read once, the
    output [B, C, D, H, W] written once."""
    ref, volumes = shapes[0], shapes[1:]
    nbytes = math.prod(ref) + sum(math.prod(v) for v in volumes)
    return rooflines.F32 * (nbytes + math.prod(volumes[0])), 0.0


def _with_volumes(call, spans):
    """The call with its volumes' shapes after the reference's, from the
    sweeps before it in its cost-volume span; None without them."""
    ref = call.shapes[0] if call.shapes else ()
    outer = [s for s in spans if s.name == "estdepth::mvs_cost_volume"
             and s.start_us <= call.start_us and call.end_us <= s.end_us]
    if len(ref) != 4 or not outer:
        return None
    start = max(s.start_us for s in outer)
    b, h, w, c = ref
    volumes = [(b, math.prod(s.shapes[1]) // (b * h * w), h, w, c)
               for s in spans if s.name == "estdepth::plane_sweep_sample"
               and start <= s.start_us and s.end_us <= call.start_us
               and len(s.shapes) > 1 and s.shapes[0] == ref]
    if not volumes:
        return None
    return dataclasses.replace(call, shapes=(ref, *volumes))


def read(r):
    if r.protocol != "mvs_views":
        return None
    spans = r.trace.spans
    calls = [_with_volumes(s, spans) for s in spans
             if s.name == "estdepth::view_variance" and not s.nested_in_same]
    return rooflines.roofline_percent([c for c in calls if c is not None],
                                      view_variance)
