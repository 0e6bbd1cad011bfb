"""The correlation of a swept source view with the reference in
TransMVSNet's cost volume, csrc/view_correlation.cu.

Replaces no TPU kernel: the JAX package has no TransMVSNet.
`view_correlation` calls the op `estdepth::view_correlation`
(ops/cuda/library.py): on CUDA tensors it launches the kernel, on CPU
tensors it runs `view_correlation_plain`, the expression the model ran in
plain PyTorch before the kernel, `(warped * ref[:, None]).mean(-1)`.

The kernel reads the swept volume and the reference once and writes the
[B, D, H, W] mean once, where the plain version writes the product as a
second volume and reads it back through ATen's reduce over an innermost
axis of 8 to 32 channels. It sums the channels in another order than
ATen's, so on the card it is within 4 C 2^-23 mean_c |warped_c ref_c| of
the plain version at every voxel, not bit for bit; on the CPU the op is
the plain version. Float32 only, as TransMVSNet; the kernel has no
gradient (the model runs under `torch.inference_mode()`).
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library

MAX_CHANNELS = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("view_correlation", "view_correlation",
                      [_P, _P, _P, _I, _I, _I, _I, _I, _P])


def view_correlation_plain(ref: torch.Tensor,
                           warped: torch.Tensor) -> torch.Tensor:
    """ref [B, H, W, C], the reference view's features; warped
    [B, D, H, W, C], a source view swept to D hypotheses -> the mean over
    the channels of their product [B, D, H, W], contiguous."""
    return (warped * ref[:, None]).mean(-1)


def _check(ref: torch.Tensor, warped: torch.Tensor) -> tuple[int, ...]:
    """(B, D, H, W, C) of a call the kernel takes, or raise: ref
    [B, H, W, C] and warped [B, D, H, W, C], contiguous float32 on one
    device, C % 4 == 0 and C <= 512."""
    if ref.dim() != 4:
        raise ValueError(f"view_correlation: ref {tuple(ref.shape)}, "
                         f"expected [B, H, W, C]")
    b, h, w, c = ref.shape
    build.require(ref, "ref", (b, h, w, c), ref.device, dtype=torch.float32)
    build.require_channels("view_correlation: ref", ref.shape, ref.dtype)
    if c > MAX_CHANNELS:
        raise ValueError(f"view_correlation: C = {c}, the kernel takes up "
                         f"to {MAX_CHANNELS}")
    d = warped.shape[1] if warped.dim() > 1 else 0
    build.require(warped, "warped", (b, d, h, w, c), ref.device,
                  dtype=torch.float32)
    return b, d, h, w, c


def _launch(ref: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    b, d, h, w, c = _check(ref, warped)
    out = torch.empty((b, d, h, w), dtype=ref.dtype, device=ref.device)
    with torch.cuda.device(ref.device):  # the C entry launches there
        KERNEL(ref.dtype, ref.data_ptr(), warped.data_ptr(), out.data_ptr(),
               b, d, h, w, c, torch.cuda.current_stream().cuda_stream)
    return out


def _fake(ref, warped):
    return ref.new_empty(warped.shape[:-1])


OP = library.define("view_correlation", view_correlation_plain, _launch,
                    _fake)


def view_correlation(ref: torch.Tensor,
                     warped: torch.Tensor) -> torch.Tensor:
    """ref [B, H, W, C] and a swept volume [B, D, H, W, C] -> the mean
    over channels of their product [B, D, H, W]: the kernel on CUDA
    tensors, the plain version on CPU tensors. Both refuse what the kernel
    does not take (`_check`)."""
    library.check_device("view_correlation", ref)
    _check(ref, warped)
    return OP(ref, warped)
