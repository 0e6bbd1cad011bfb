"""Kernel 2: the exact-z frustum resample, csrc/frustum_warp_exact_z.cu.

Replaces estdepth_tpu/ops/pallas/plane_warp_exact_z.py:
frustum_warp_exact_z_pallas. `exact_z_resample` calls the op
`estdepth::exact_z_resample` (ops/cuda/library.py): on a CUDA tensor it
launches the kernel, on a CPU tensor it runs the plain PyTorch version
(ops/warp_exact_z.resample_exact_z). The zi field is computed in PyTorch
by the caller (ops/warp_exact_z.zi_field) and read by both. `depth_min`
and `depth_interval` are arguments of the op, so an exported program
carries them as constants; the CUDA implementation turns the interval into
the float32 reciprocal that PyTorch multiplies by when it divides a tensor
by a scalar on the card, which keeps the kernel bit-equal to the plain
version.

The coordinates name the output grid: x, y, z [B, D*H*W] the volume's own
grid, x, y, z [B, D, H, Wo] a window of Wo columns (a width shard's own,
parallel/spatial.py), exactly those columns of the whole output; zi stays
on the volume's (source) grid.

The volume is float32 or bfloat16 (the kernel's two instances; C % 4 == 0
or C % 8 == 0), zi and the coordinates float32, the result in the volume's
dtype: A and s are float32 for either (ops/warp_exact_z.py), and a
bfloat16 result is rounded once. The TPU function's packed bf16 transport
of (A, s) between its kernels has no counterpart: this kernel keeps A and s
in registers, so no transport halves any traffic.

Gradient, as the JAX package's `custom_vjp` (_frustum_exact_z_bwd): the
kernel is forward-only; the backward is autograd of the plain version with
respect to `volume` at the same coordinates. `zi`, `x`, `y` and `z` get no
gradient on either device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from estdepth_tpu_torch.ops.cuda import build, library
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = build.Kernel(
    "frustum_warp_exact_z", "frustum_warp_exact_z",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
)


def _launch(volume: torch.Tensor, zi: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor, z: torch.Tensor, depth_min: float,
            depth_interval: float) -> torch.Tensor:
    b, d, h, w, c = volume.shape
    if d < 2:
        raise ValueError(f"exact_z_resample: volume {tuple(volume.shape)} "
                         f"needs D >= 2")
    dev = volume.device
    build.require(volume, "volume", (b, d, h, w, c), dev, allow_grad=True)
    build.require_channels("exact_z_resample: volume", volume.shape,
                           volume.dtype)
    _, _, wo = build.output_grid("exact_z_resample", x, h, w, d)
    build.require(zi, "zi", (b, d, h * w), dev, dtype=torch.float32)
    for name, t in (("x", x), ("y", y), ("z", z)):
        build.require(t, name, (b, *x.shape[1:]), dev, dtype=torch.float32)
    out = volume.new_empty((b, d, h, wo, c))
    # the f32 reciprocal PyTorch uses for a tensor / scalar on the card
    inv_interval = float(np.float32(1.0) / np.float32(depth_interval))
    with torch.cuda.device(dev):  # the C entry launches there
        KERNEL(volume.dtype, volume.data_ptr(), zi.data_ptr(),
               x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(),
               b, d, h, w, wo, c, float(depth_min), inv_interval,
               torch.cuda.current_stream().cuda_stream)
    return out


def _fake(volume, zi, x, y, z, depth_min, depth_interval):
    b, d, h, w, c = volume.shape
    _, _, wo = build.output_grid("exact_z_resample", x, h, w, d)
    return volume.new_empty((b, d, h, wo, c))


OP = library.define("exact_z_resample", resample_exact_z, _launch, _fake)


def exact_z_resample(volume: torch.Tensor, zi: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, z: torch.Tensor, depth_min: float,
                     depth_interval: float) -> torch.Tensor:
    """volume [B, D, H, W, C], zi [B, D, H*W], exact source x, y and depth z
    [B, D*H*W] -> [B, D, H, W, C], or [B, D, H, Wo] -> [B, D, H, Wo, C]:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    library.check_device("exact_z_resample", volume)
    build.output_grid("exact_z_resample", x, *volume.shape[2:4],
                      volume.shape[1])
    depth_min, depth_interval = float(depth_min), float(depth_interval)

    def plain(vol, *coords):
        return resample_exact_z(vol, *coords, depth_min, depth_interval)

    def launch(vol, *coords):
        return OP(vol, *coords, depth_min, depth_interval)

    return build.sample_with_plain_grad(launch, plain, "frustum_warp_exact_z",
                                        volume, zi, x, y, z)
