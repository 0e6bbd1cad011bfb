"""Kernel 1: the plane-sweep sample, csrc/plane_sweep_warp.cu.

Replaces estdepth_tpu/ops/pallas/plane_warp.py:plane_sweep_warp_pallas.
`plane_sweep_sample` calls the op `estdepth::plane_sweep_sample`
(ops/cuda/library.py): on a CUDA tensor it launches the kernel, on a CPU
tensor it runs the plain PyTorch version (ops/sampling.bilinear_sample).
`src` is float32 or bfloat16 (the kernel's two instances; C % 4 == 0 or
C % 8 == 0: whole 16-byte vectors), the coordinates float32, the result
in src's dtype. A bfloat16 map is sampled in float32 and rounded once.

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
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])


def plane_sweep_sample_plain(src: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """src [B, H, W, C] sampled at x, y [B, D*H*W] -> [B, D, H, W, C]."""
    b, h, w, c = src.shape
    return bilinear_sample(src, x, y).reshape(b, -1, h, w, c)


def _launch(src: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    b, h, w, c = src.shape
    d = x.shape[1] // (h * w)
    build.require(src, "src", (b, h, w, c), src.device, allow_grad=True)
    build.require_channels("plane_sweep_sample: src", src.shape, src.dtype)
    build.require(x, "x", (b, d * h * w), src.device, dtype=torch.float32)
    build.require(y, "y", (b, d * h * w), src.device, dtype=torch.float32)
    out = torch.empty((b, d, h, w, c), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):  # the C entry launches there
        KERNEL(src.dtype, src.data_ptr(), x.data_ptr(), y.data_ptr(),
               out.data_ptr(), b, d, h, w, c,
               torch.cuda.current_stream().cuda_stream)
    return out


def _fake(src, x, y):
    b, h, w, c = src.shape
    return src.new_empty((b, x.shape[1] // (h * w), h, w, c))


OP = library.define("plane_sweep_sample", plane_sweep_sample_plain, _launch,
                    _fake)


def plane_sweep_sample(src: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """src [B, H, W, C] sampled at x, y [B, D*H*W] -> [B, D, H, W, C]:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    library.check_device("plane_sweep_sample", src)
    b, h, w, c = src.shape
    if x.dim() != 2 or x.shape[1] % (h * w):
        raise ValueError(f"plane_sweep_sample: src {tuple(src.shape)} "
                         f"with x {tuple(x.shape)} ([B, D*H*W])")
    return build.sample_with_plain_grad(
        OP, plane_sweep_sample_plain, "plane_sweep_warp", src, x, y)
