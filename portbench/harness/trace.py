"""The traced half of a `--trace 1` run: spans opened by the benchmark, the
profiler's events reduced to what the per-layer readers need.

Spans come from the benchmark's own code: `record_function` ranges around
each request's issue and fetch (harness/loop.py) and around the forward of
named submodules of the port's model, opened and closed by forward pre-
and post-hooks that the benchmark registers on the model (the program is
not edited). The `estdepth::*` ranges are the port's custom ops, which the
profiler records by itself. Device activity is every kernel, copy and set
on the device; the kernel grouping for the breakdown is a copy of
`estdepth_tpu_torch/tools/profile_estm.py`'s GROUPS (commit dd5b5eb).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

SPAN_PREFIXES = ("portbench::", "estdepth::")


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_us: float
    end_us: float
    device_us: float  # device time of the work launched inside it
    shapes: tuple  # input shapes of an op range
    nested_in_same: bool  # inside another span of the same name


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced half's host-clock length
    records: list  # the traced half's loop records
    spans: list
    device: list  # (name, start_us, end_us) of each device activity
    busy: list  # merged device intervals (start_us, end_us)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def span_device_ms(self, names) -> float:
        """Device ms inside the outermost spans named in `names`."""
        return sum(s.device_us for s in self.spans
                   if s.name in names and not s.nested_in_same) / 1e3


@contextlib.contextmanager
def module_spans(modules: dict):
    """Open `portbench::<label>` around the forward of each module of
    {label: module} while the block runs."""
    handles, open_ = [], {}

    def pre(label):
        def hook(_module, _args):
            rf = record_function(f"portbench::{label}")
            rf.__enter__()
            open_.setdefault(label, []).append(rf)
        return hook

    def post(label):
        def hook(_module, _args, _out):
            open_[label].pop().__exit__(None, None, None)
        return hook

    for label, m in modules.items():
        handles.append(m.register_forward_pre_hook(pre(label)))
        handles.append(m.register_forward_hook(post(label)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def reduce(prof, window_s: float, records) -> Trace:
    """The profiler's raw events (without building its event tree, which
    takes minutes for a window of 10^5 launches): device activities, and
    each span's device time, that of the activities launched from inside
    it (their linked host op starts within the span, on its thread)."""
    device, spans, op_start = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns() / 1e3,
                               e.end_ns() / 1e3, e.linked_correlation_id()))
            continue
        if e.linked_correlation_id():  # a runtime call, not a host op
            continue
        op_start[e.correlation_id()] = (e.start_ns() / 1e3,
                                        e.start_thread_id())
        if e.name().startswith(SPAN_PREFIXES):
            spans.append(e)
    launched = defaultdict(list)  # thread -> [(host op start, device us)]
    for _, s, e, corr in device:
        if corr in op_start:
            at, thread = op_start[corr]
            launched[thread].append((at, e - s))
    sums = {}
    for thread, pairs in launched.items():
        pairs.sort()
        starts = [a for a, _ in pairs]
        acc = [0.0]
        for _, d in pairs:
            acc.append(acc[-1] + d)
        sums[thread] = (starts, acc)
    out, open_end = [], {}
    for e in sorted(spans, key=lambda e: e.start_ns()):
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        starts, acc = sums.get(e.start_thread_id(), ([], [0.0]))
        used = (acc[bisect.bisect_right(starts, end)]
                - acc[bisect.bisect_left(starts, start)])
        key = (e.name(), e.start_thread_id())
        nested = start < open_end.get(key, float("-inf"))
        if not nested:
            open_end[key] = end
        out.append(Span(e.name(), start, end, used,
                        tuple(tuple(x) for x in e.shapes()), nested))
    return Trace(window_s, records, out, [d[:3] for d in device],
                 _merge((s, e) for _, s, e, _ in device))


GROUPS = [
    ("port: plane_sweep_warp", r"plane_sweep_warp_kernel"),
    ("port: frustum_warp_exact_z", r"frustum_warp_exact_z_kernel"),
    ("port: two_pass_resample", r"two_pass_resample_kernel"),
    ("port: frustum_warp_plane_mix", r"frustum_warp_plane_mix_kernel"),
    ("port: epipolar_attention", r"epipolar_attention_kernel"),
    ("batchnorm (cuDNN)", r"bn_fw|bn_bw|batch_norm"),
    ("groupnorm", r"RowwiseMoments|group_norm|GroupNorm"),
    ("layout / copy / cat", r"nhwcToNchw|nchwToNhwc|copy|Memcpy|"
                            r"transpose"),
    ("conv FFT tiles (cuDNN)", r"fft|cf32cf32"),
    ("conv (cuDNN)", r"conv|cudnn|implicit|xmma|winograd|fft|sm90|sm80|"
                     r"wgrad|dgrad|fprop"),
    ("gemm", r"gemm|cutlass|cublas"),
    ("optimizer (multi-tensor)", r"multi_tensor|adam|foreach"),
    ("gather / index", r"gather|index|scatter"),
    ("reduce / softmax", r"reduce|softmax|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, re.IGNORECASE):
            return group
    return "other"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device's time by kernel group, and its idle time between
    device activities by the innermost benchmark span open on the host
    when the gap began, each the `top` largest, in seconds."""
    ops = defaultdict(float)
    for name, s, e in trace.device:
        ops[group_of(name)] += (e - s) / 1e6
    host = sorted((s for s in trace.spans if s.name.startswith("portbench::")),
                  key=lambda s: s.start_us)
    gaps, stack, i = defaultdict(float), [], 0
    for (_, a), (b, _) in zip(trace.busy, trace.busy[1:]):
        while i < len(host) and host[i].start_us <= a:
            stack.append(host[i])  # the benchmark's spans nest
            i += 1
        while stack and stack[-1].end_us < a:
            stack.pop()
        label = stack[-1].name if stack else "host: outside any span"
        gaps[label] += (b - a) / 1e6
    return {key: sorted(([k, v] for k, v in d.items()),
                        key=lambda kv: -kv[1])[:top]
            for key, d in (("device_ops", ops), ("idle_gaps", gaps))}
