"""Kernel 1: the plane-sweep sample, csrc/plane_sweep_warp.cu.

Replaces estdepth_tpu/ops/pallas/plane_warp.py:plane_sweep_warp_pallas.
`plane_sweep_sample` calls the op `estdepth::plane_sweep_sample`
(ops/cuda/library.py): on a CUDA tensor it launches the kernel, on a CPU
tensor it runs the plain PyTorch version (ops/sampling.bilinear_sample).
`src` is float32 or bfloat16 (the kernel's two instances; C % 4 == 0 or
C % 8 == 0: whole 16-byte vectors), the coordinates float32, the result
in src's dtype. A bfloat16 map is sampled in float32 and rounded once.
The coordinates name the output grid: x, y [B, D*H*W] sample the D planes
of the source's own grid, x, y [B, D, H, Wo] a window of Wo columns (a
width shard's own, parallel/spatial.py), which is exactly those columns
of the whole sweep.

Gradient, as the JAX package's `custom_vjp` (_psweep_bwd): the kernel is
forward-only; the backward is autograd of the plain version with respect
to `src` at the same coordinates. `x` and `y` get no gradient on either
device (the reference computes its grid under `torch.no_grad()`).
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library
from estdepth_tpu_torch.ops.sampling import bilinear_sample

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("plane_sweep_warp", "plane_sweep_warp",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def plane_sweep_sample_plain(src: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """src [B, H, W, C] sampled at x, y [B, D*H*W] -> [B, D, H, W, C], or
    at x, y [B, D, H, Wo] -> [B, D, H, Wo, C]."""
    b, h, w, c = src.shape
    d, _, wo = build.output_grid("plane_sweep_sample", x, h, w)
    return bilinear_sample(src, x.reshape(b, -1), y.reshape(b, -1)).reshape(
        b, d, h, wo, c)


def _launch(src: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    b, h, w, c = src.shape
    d, _, wo = build.output_grid("plane_sweep_sample", x, h, w)
    build.require(src, "src", (b, h, w, c), src.device, allow_grad=True)
    build.require_channels("plane_sweep_sample: src", src.shape, src.dtype)
    build.require(x, "x", (b, *x.shape[1:]), src.device, dtype=torch.float32)
    build.require(y, "y", x.shape, src.device, dtype=torch.float32)
    out = torch.empty((b, d, h, wo, c), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):  # the C entry launches there
        KERNEL(src.dtype, src.data_ptr(), x.data_ptr(), y.data_ptr(),
               out.data_ptr(), b, d, h, w, wo, c,
               torch.cuda.current_stream().cuda_stream)
    return out


def _fake(src, x, y):
    b, h, w, c = src.shape
    d, _, wo = build.output_grid("plane_sweep_sample", x, h, w)
    return src.new_empty((b, d, h, wo, c))


OP = library.define("plane_sweep_sample", plane_sweep_sample_plain, _launch,
                    _fake)


def plane_sweep_sample(src: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """src [B, H, W, C] sampled at x, y [B, D*H*W] -> [B, D, H, W, C], or
    at x, y [B, D, H, Wo] -> [B, D, H, Wo, C]: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    library.check_device("plane_sweep_sample", src)
    build.output_grid("plane_sweep_sample", x, *src.shape[1:3])
    return build.sample_with_plain_grad(
        OP, plane_sweep_sample_plain, "plane_sweep_warp", src, x, y)
