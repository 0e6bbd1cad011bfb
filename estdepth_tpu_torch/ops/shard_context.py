"""The width layout a forward runs on (the `width_sharded` context) and
the small helpers the layers and warps read under it.

A leaf module: the layers and ops import it, and parallel/spatial.py,
which holds the layout (`WidthShards`) and the entry point, imports it in
turn. Inside `width_sharded(shards)` `current()` returns `shards`, an
object with `columns(w)`, `full_width(w)`, `halo(x, dim, left, right,
value)`, `all_reduce(x)` and `gather_width(x, dim)`
(parallel/spatial.WidthShards); outside it None, and every layer computes
what it always did.
"""

from __future__ import annotations

import contextlib
import contextvars

# the modes the sharded forward does not run yet: their ROADMAP.md entries
DEFERRED = {"two_pass_warp": 2, "senet": 3}

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "estdepth_width_shards", default=None)


def current():
    """The width layout the running forward is sharded over, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def width_sharded(shards):
    """Run the model's layers on `shards` inside the block (a context
    variable, as autocast works): outside it every layer runs as
    unsharded."""
    token = _CURRENT.set(shards)
    try:
        yield shards
    finally:
        _CURRENT.reset(token)


def conv_halo(kernel: int, stride: int, padding: int,
              dilation: int) -> tuple[int, int]:
    """The (left, right) halo of a width-sharded convolution or pooling
    window: its left padding, and the columns its last output of a shard
    reaches past the shard (with shards whose widths are multiples of the
    stride)."""
    return padding, max(0, (kernel - 1) * dilation - padding - (stride - 1))


def refuse_deferred(mode: str) -> None:
    """Raise for a mode of DEFERRED, which the width-sharded forward does
    not run yet, naming its queue entry."""
    raise NotImplementedError(
        f"{mode} does not run width-sharded yet: ROADMAP.md §A, item "
        f"{DEFERRED[mode]}")
