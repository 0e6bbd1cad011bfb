"""The attention in VGGT's global blocks against the card's dense bf16
peak: 100 x the operations of the port's `estdepth::attention` calls
inside the `estdepth::vggt_global` spans (4 B heads N^2 64 a call, from
the op's argument shapes: harness/attention.py) at 989 TFLOP/s over the
device time of the kernels launched inside those op ranges, in %. A port
without the op or the span gives None."""

from portbench.harness import attention


def read(r):
    if r.protocol != "mvs_scan":
        return None
    return attention.roofline_percent(attention.inside(
        r.trace.spans, attention.OP, "estdepth::vggt_global"))
