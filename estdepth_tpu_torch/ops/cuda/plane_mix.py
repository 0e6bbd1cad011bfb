"""Kernel 4: the plane-mix frustum resample, csrc/frustum_warp_plane_mix.cu.

Replaces estdepth_tpu/ops/pallas/plane_warp.py:frustum_warp_pallas (the
lane-gather z-mix kernel plus the two-pass resample). `plane_mix_resample`
calls the op `estdepth::plane_mix_resample` (ops/cuda/library.py): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
PyTorch version below, which is ops/warp._frustum_warp_planemix of the JAX
package: the z-mix per SOURCE pixel, then one bilinear sample per voxel at
the exact (x, y). The zi field is computed in PyTorch by the caller
(ops/warp_exact_z.zi_field) and read by both.

The volume is float32 or bfloat16 (the kernel's two instances; C % 4 == 0
or C % 8 == 0), zi and the coordinates float32, the result in the volume's
dtype. A bfloat16 volume is mixed and sampled in float32 and rounded once,
where the TPU function, which moves channel pairs packed as int32 lanes
between its kernels, also rounds its two intermediates to bfloat16.

Gradient, as the JAX package's `custom_vjp` (_frustum_diff_bwd): the kernel
is forward-only; the backward is autograd of the plain version with respect
to `volume` at the same coordinates. `zi`, `x` and `y` get no gradient on
either device.
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library
from estdepth_tpu_torch.ops.sampling import bilinear_sample, upcast_half
from estdepth_tpu_torch.ops.warp_exact_z import EPS

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("frustum_warp_plane_mix", "frustum_warp_plane_mix",
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
    -> [B, D, H, W, C] in volume's dtype. Plain version of kernel 4: a
    bfloat16 volume is mixed and sampled in float32 and rounded once."""
    b, d, h, w, c = volume.shape
    mixed = z_mix(upcast_half(volume), zi).reshape(b * d, h, w, c)
    out = bilinear_sample(mixed, x.reshape(b * d, h * w),
                          y.reshape(b * d, h * w))
    return out.reshape(b, d, h, w, c).to(volume.dtype)


def _launch(volume: torch.Tensor, zi: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    b, d, h, w, c = volume.shape
    if d < 2:
        raise ValueError(f"plane_mix_resample: volume {tuple(volume.shape)} "
                         f"needs D >= 2")
    dev = volume.device
    build.require(volume, "volume", (b, d, h, w, c), dev, allow_grad=True)
    build.require_channels("plane_mix_resample: volume", volume.shape,
                           volume.dtype)
    build.require(zi, "zi", (b, d, h * w), dev, dtype=torch.float32)
    build.require(x, "x", (b, d * h * w), dev, dtype=torch.float32)
    build.require(y, "y", (b, d * h * w), dev, dtype=torch.float32)
    out = torch.empty_like(volume)
    with torch.cuda.device(dev):  # the C entry launches there
        KERNEL(volume.dtype, volume.data_ptr(), zi.data_ptr(),
               x.data_ptr(), y.data_ptr(), out.data_ptr(), b, d, h, w, c,
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
