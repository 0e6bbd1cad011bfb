"""Kernel 4: the plane-mix frustum resample, csrc/frustum_warp_plane_mix.cu.

Replaces estdepth_tpu/ops/pallas/plane_warp.py:frustum_warp_pallas (the
lane-gather z-mix kernel plus the two-pass resample). `plane_mix_resample`
calls the op `estdepth::plane_mix_resample` (ops/cuda/library.py): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
PyTorch version below, which is ops/warp._frustum_warp_planemix of the JAX
package: the z-mix per SOURCE pixel, then one bilinear sample per voxel at
the exact (x, y). The zi field is computed in PyTorch by the caller
(ops/warp_exact_z.zi_field) and read by both.

The TPU function's bf16 transport (channel pairs packed as int32) has no
counterpart; the wrapper raises on bf16 volumes.

Gradient, as the JAX package's `custom_vjp` (_frustum_diff_bwd): the kernel
is forward-only; the backward is autograd of the plain version with respect
to `volume` at the same coordinates. `zi`, `x` and `y` get no gradient on
either device.
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library
from estdepth_tpu_torch.ops.sampling import bilinear_sample
from estdepth_tpu_torch.ops.warp_exact_z import EPS

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("frustum_warp_plane_mix", "frustum_warp_plane_mix_f32",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])


def z_mix(volume: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Each target plane's values at the SOURCE pixels: the hat-weighted
    sum over the Z source planes at zi, as its two non-zero taps.

    volume [B, Z, H, W, C]; zi [B, D, HW] -> [B, D, HW, C]. Outside the
    eps-padded window [-EPS, Z-1+EPS] the result is 0; inside it the taps
    are z0 = clip(floor(zi), 0, Z-2) and z0 + 1 with weights
    max(0, 1 - |zi - tap|), so a zi just outside [0, Z-1] fades by its
    distance instead of clamping."""
    b, z, h, w, c = volume.shape
    zi = zi.float()
    valid = (zi >= -EPS) & (zi <= z - 1.0 + EPS)
    z0 = torch.floor(zi).clamp(0.0, max(z - 2.0, 0.0))
    w0 = (1.0 - (zi - z0).abs()).clamp(min=0.0)
    w1 = (1.0 - (zi - (z0 + 1.0)).abs()).clamp(min=0.0)
    zero = torch.zeros_like(zi)
    w0 = torch.where(valid, w0, zero)[..., None].to(volume.dtype)
    w1 = torch.where(valid, w1, zero)[..., None].to(volume.dtype)
    z0i = z0.long()
    src = volume.reshape(b, z, h * w, c)
    hw = torch.arange(h * w, device=volume.device)
    bi = torch.arange(b, device=volume.device)[:, None, None]
    return w0 * src[bi, z0i, hw] + w1 * src[bi, z0i + 1, hw]


def plane_mix_resample_plain(volume: torch.Tensor, zi: torch.Tensor,
                             x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """volume [B, D, H, W, C], zi [B, D, H*W], exact source x, y [B, D*H*W]
    -> [B, D, H, W, C]. Plain version of kernel 4."""
    b, d, h, w, c = volume.shape
    mixed = z_mix(volume, zi).reshape(b * d, h, w, c)
    out = bilinear_sample(mixed, x.reshape(b * d, h * w),
                          y.reshape(b * d, h * w))
    return out.reshape(b, d, h, w, c)


def _launch(volume: torch.Tensor, zi: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    b, d, h, w, c = volume.shape
    if c % 4 or d < 2:
        raise ValueError(f"plane_mix_resample: volume {tuple(volume.shape)} "
                         f"needs C % 4 == 0 and D >= 2")
    dev = volume.device
    build.require(volume, "volume", (b, d, h, w, c), dev, allow_grad=True)
    build.require(zi, "zi", (b, d, h * w), dev)
    build.require(x, "x", (b, d * h * w), dev)
    build.require(y, "y", (b, d * h * w), dev)
    out = torch.empty_like(volume)
    with torch.cuda.device(dev):  # the C entry launches there
        KERNEL(volume.data_ptr(), zi.data_ptr(), x.data_ptr(), y.data_ptr(),
               out.data_ptr(), b, d, h, w, c,
               torch.cuda.current_stream().cuda_stream)
    return out


def _fake(volume, zi, x, y):
    return volume.new_empty(volume.shape)


OP = library.define("plane_mix_resample", plane_mix_resample_plain, _launch,
                    _fake)


def plane_mix_resample(volume: torch.Tensor, zi: torch.Tensor,
                       x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """volume [B, D, H, W, C], zi [B, D, H*W], exact source x, y [B, D*H*W]
    -> [B, D, H, W, C]: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    library.check_device("plane_mix_resample", volume)
    return build.sample_with_plain_grad(
        OP, plane_mix_resample_plain, "frustum_warp_plane_mix", volume, zi,
        x, y)
