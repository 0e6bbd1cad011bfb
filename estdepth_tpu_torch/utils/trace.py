"""Spans and counters at the port's layer boundaries.

`span(name)` opens the profiler range `estdepth::<name>` while torch's
profiler records, so a trace holds each layer's host interval and, linked
to it, the device work launched inside it, all on the profiler's clock.
With no profiler recording it returns `OFF`, one shared no-op: a span
costs one flag test when tracing is off. `spanned(name)` wraps every call
of a function or method in `span(name)`; it is the decorator form, since a
decorator is built at import, when no profiler records.

`host_wait(kind)` is `span("host_wait." + kind)`, opened around a call at
which the host waits for the device to drain its queue: on CUDA a copy
from pageable host memory, or a factorization that checks its result on
the host. The range lies on the same clock as the device's activity, so a
trace tells the host's waiting from its launching, and an idle gap that
begins inside a wait is the wait's. `kind` names the call, not the line;
the enclosing span says where it waits. A span's name never equals a
custom op's (`estdepth::plane_sweep_sample` and the others), which the
profiler records by itself.

`count(name, n)` adds to one process-wide counter of plain ints, on the
host (nothing here reads the device); `count_new(name, key)` adds 1 the
first time the process gives `name` that key; `counts()` is a copy of
them all. They count the eager model's calls: an exported program
(serving.py) runs without them.

Each module's docstring names the spans, waits and counters it opens.
"""

from __future__ import annotations

import collections
import functools
import threading

from torch.autograd import profiler as _profiler

PREFIX = "estdepth::"


class _Off:
    """The context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_counts: collections.Counter = collections.Counter()
_seen: collections.defaultdict = collections.defaultdict(set)
_lock = threading.Lock()


def span(name: str):
    """`record_function("estdepth::<name>")` while torch's profiler
    records (a flag set on every thread, autograd's included), else
    `OFF`."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return OFF


def host_wait(kind: str):
    """`span("host_wait." + kind)`: around a call at which the host waits
    on the device."""
    return span("host_wait." + kind)


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counts[name] += n


def count_new(name: str, key) -> None:
    """Add 1 to the counter `name` the first time it is given `key`."""
    with _lock:
        if key not in _seen[name]:
            _seen[name].add(key)
            _counts[name] += 1


def counts() -> dict:
    """A copy of every counter, {name: int}."""
    with _lock:
        return dict(_counts)
