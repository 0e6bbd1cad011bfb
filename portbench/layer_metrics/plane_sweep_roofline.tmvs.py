"""Kernel 1 (`csrc/plane_sweep_warp.cu`, op `estdepth::plane_sweep_sample`)
in TransMVSNet's per-pixel sweeps: 100 x the least time of its calls
(bytes at 3.35 TB/s, each input read once and the output written once,
from the op's argument shapes) over the device time inside its op ranges,
in %."""

from portbench.harness import rooflines


def read(r):
    if r.protocol != "mvs_views_wta":
        return None
    spans = [s for s in r.trace.spans
             if s.name == "estdepth::plane_sweep_sample"
             and not s.nested_in_same]
    return rooflines.roofline_percent(spans, rooflines.plane_sweep)
