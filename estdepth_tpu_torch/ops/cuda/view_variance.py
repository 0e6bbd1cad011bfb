"""The variance over the views of CasMVSNet's cost volume,
csrc/view_variance.cu.

Replaces no TPU kernel: the JAX package has no CasMVSNet. `view_variance`
calls the op `estdepth::view_variance` (ops/cuda/library.py): on CUDA
tensors it launches the kernel, on CPU tensors it runs
`view_variance_plain`, the arithmetic the model ran in plain PyTorch
before the kernel, op for op and in the same order: t = ref, s = ref *
ref; for each swept view in turn t = t + w_i and s = s + w_i * w_i; then
s / V - (t / V)^2, permuted from channels-last to [B, C, D, H, W].

The kernel reads the reference and each swept volume once and writes the
NCDHW variance once, where the plain version makes about 45 passes over
the volume. It is the plain version on the card bit for bit: ATen's CUDA
division by a Python number multiplies by its float32 reciprocal, as the
kernel does (on the CPU the plain version divides). Float32 only, as
CasMVSNet; the kernel has no gradient (the model runs under
`torch.inference_mode()`).
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library

MAX_SOURCES = 16  # source views a call takes (the kernel's pointer array)
MAX_CHANNELS = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("view_variance", "view_variance",
                      [_P, ctypes.POINTER(_P), _I, _P, _I, _I, _I, _I, _I,
                       _P])


def view_variance_plain(ref: torch.Tensor,
                        warped: list[torch.Tensor]) -> torch.Tensor:
    """ref [B, H, W, C], the reference view's features; warped, V - 1
    volumes [B, D, H, W, C], the source views swept to D hypotheses ->
    the variance over the V views [B, C, D, H, W], contiguous."""
    b, h, w, c = ref.shape
    v = len(warped) + 1
    first = ref[:, None].expand(b, warped[0].shape[1], h, w, c)
    total = first.clone()
    squares = first.square()
    for vol in warped:
        total += vol
        squares += vol.square()
    var = squares.div_(v).sub_(total.div_(v).square_())
    return var.permute(0, 4, 1, 2, 3).contiguous()


def _check(ref: torch.Tensor, warped) -> tuple[int, ...]:
    """(B, D, H, W, C) of a call the kernel takes, or raise: 1 to 16
    contiguous float32 volumes [B, D, H, W, C] on ref's device, ref
    [B, H, W, C] contiguous float32, C % 4 == 0 and C <= 512."""
    if not 1 <= len(warped) <= MAX_SOURCES:
        raise ValueError(f"view_variance: {len(warped)} source views, the "
                         f"kernel takes 1 to {MAX_SOURCES}")
    if ref.dim() != 4:
        raise ValueError(f"view_variance: ref {tuple(ref.shape)}, expected "
                         f"[B, H, W, C]")
    b, h, w, c = ref.shape
    build.require(ref, "ref", (b, h, w, c), ref.device, dtype=torch.float32)
    build.require_channels("view_variance: ref", ref.shape, ref.dtype)
    if c > MAX_CHANNELS:
        raise ValueError(f"view_variance: C = {c}, the kernel takes up to "
                         f"{MAX_CHANNELS}")
    d = warped[0].shape[1] if warped[0].dim() > 1 else 0
    for i, vol in enumerate(warped):
        build.require(vol, f"warped[{i}]", (b, d, h, w, c), ref.device,
                      dtype=torch.float32)
    return b, d, h, w, c


def _launch(ref: torch.Tensor, warped: list[torch.Tensor]) -> torch.Tensor:
    b, d, h, w, c = _check(ref, warped)
    out = torch.empty((b, c, d, h, w), dtype=ref.dtype, device=ref.device)
    pointers = (_P * len(warped))(*(vol.data_ptr() for vol in warped))
    with torch.cuda.device(ref.device):  # the C entry launches there
        KERNEL(ref.dtype, ref.data_ptr(), pointers, len(warped),
               out.data_ptr(), b, d, h, w, c,
               torch.cuda.current_stream().cuda_stream)
    return out


def _fake(ref, warped):
    b, h, w, c = ref.shape
    return ref.new_empty((b, c, warped[0].shape[1], h, w))


OP = library.define("view_variance", view_variance_plain, _launch, _fake)


def view_variance(ref: torch.Tensor,
                  warped: list[torch.Tensor]) -> torch.Tensor:
    """ref [B, H, W, C] and V - 1 swept volumes [B, D, H, W, C] -> the
    variance over the V views [B, C, D, H, W]: the kernel on CUDA
    tensors, the plain version on CPU tensors. Both refuse what the
    kernel does not take (`_check`)."""
    library.check_device("view_variance", ref)
    _check(ref, warped)
    return OP(ref, list(warped))
