"""Softmax attention as one op, `estdepth::attention`.

`attention(q, k, v)` is `F.scaled_dot_product_attention(q, k, v)` (scale
1 / sqrt(head width), no mask) behind a `torch.library.custom_op`, so that
a profile records each call as one `estdepth::attention` range with the
shapes of q, k and v, and the device time of the backend's kernels
launched inside it, whichever backend PyTorch picks (flash, cuDNN,
memory-efficient or the math path). The op has no autograd formula and no
autocast rule: its callers (models/vggt.py) cast q and k to v's dtype,
as autocast would cast all three before a plain call. Its inputs are
[B, heads, N, D] and it returns [B, heads, N, Dv], never a view of an
input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.library.custom_op("estdepth::attention", mutates_args=())
def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    return F.scaled_dot_product_attention(q, k, v)


@attention.register_fake
def _attention_fake(q, k, v):
    return q.new_empty((*q.shape[:-1], v.shape[-1]), dtype=v.dtype)
