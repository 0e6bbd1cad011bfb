"""The least work of softmax attention, and the card's bf16 peak.

A call's operations are counted from the shapes of q [B, heads, Nq, d],
k [B, heads, Nk, d] and v [B, heads, Nk, dv], the argument shapes of the
port's `estdepth::attention` op range: 2 B heads Nq Nk d for q k^T and
2 B heads Nq Nk dv for the weighted sum of v (4 B heads N^2 64 for a
self-attention of 64-wide heads), the same whatever backend or kernel
computes it. Peak: NVIDIA H100 SXM data sheet, dense bf16 on the tensor
cores, at the 700 W limit.
"""

from __future__ import annotations

import bisect
import math

PEAK_BF16_FLOPS = 989e12
OP = "estdepth::attention"


def attention_ops(shapes) -> float:
    """Operations of one estdepth::attention(q, k, v) call."""
    q, k = shapes[0], shapes[1]
    dv = shapes[2][-1] if len(shapes) > 2 and shapes[2] else q[-1]
    return 2.0 * math.prod(q[:-1]) * k[-2] * (q[-1] + dv)


def inside(spans, inner: str, outer: str) -> list:
    """The outermost spans named `inner` whose host interval lies within
    an outermost span named `outer` (on one thread, as the port runs)."""
    outers = sorted((s.start_us, s.end_us) for s in spans
                    if s.name == outer and not s.nested_in_same)
    starts = [a for a, _ in outers]
    out = []
    for s in spans:
        if s.name != inner or s.nested_in_same:
            continue
        i = bisect.bisect_right(starts, s.start_us) - 1
        if i >= 0 and s.end_us <= outers[i][1]:
            out.append(s)
    return out


def roofline_percent(spans) -> float | None:
    """100 x the calls' operations at the bf16 peak over the device time
    inside their op ranges; None where no call ran."""
    device_s = sum(s.device_us for s in spans) / 1e6
    if not spans or device_s <= 0:
        return None
    ops = sum(attention_ops(s.shapes) for s in spans)
    return 100.0 * ops / PEAK_BF16_FLOPS / device_s
