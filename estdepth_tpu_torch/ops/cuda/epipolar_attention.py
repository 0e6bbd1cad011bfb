"""Kernel 5: the per-voxel epipolar attention, csrc/epipolar_attention.cu.

Replaces estdepth_tpu/ops/pallas/epipolar_attention.py:epipolar_attention.
`epipolar_attention` calls the op `estdepth::epipolar_attention`
(ops/cuda/library.py): on CUDA tensors it launches the kernel, on CPU
tensors it runs `epipolar_attention_plain`, the counterpart of the JAX
package's `epipolar_attention_reference` and the attention
EpipolarTransformer runs by default.

The wrapper takes the channels-last tensors the EST fusion has, not folded
copies: the warped keys and values are the two channel halves of one
warped [B, N, D, H, W, 2C] volume, and the kernel reads them in place
through their strides, in an exported program too (the op takes views).
The inputs are float32 or bfloat16, all three alike (the kernel's two
instances), and the output is a new contiguous tensor of their dtype on
either device: the kernel computes in float32 and rounds a bfloat16
result once, as the TPU kernel does (bf16 in and out, f32 inside). Where
the JAX function falls back to its reference for a channel count its kernel
cannot take, this wrapper raises: C must be 16.
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library
from estdepth_tpu_torch.ops.sampling import upcast_half

_NEG_INF = -1e9
CHANNELS = 16
MAX_NEIGHBOURS = 8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = build.Kernel("epipolar_attention", "epipolar_attention",
                      [_P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _L, _L, _L,
                       _P])


def epipolar_attention_plain(target_key: torch.Tensor,
                             warped_keys: torch.Tensor,
                             warped_values: torch.Tensor,
                             valid: torch.Tensor) -> torch.Tensor:
    """target_key [S, ..., C]; warped_keys / warped_values [N, S, ..., C];
    valid [N, S] bool -> [S, ..., C]. Per voxel: the correlation over C, a
    softmax over the N neighbours masked by `valid`, the weighted sum of
    the values divided by the number of valid neighbours (at least 1);
    zero where no neighbour is valid. Plain version of kernel 5: the
    result is in warped_values' dtype, computed in float32 and rounded
    once for bfloat16 inputs."""
    dtype = warped_values.dtype
    target_key, warped_keys, warped_values = (
        upcast_half(t) for t in (target_key, warped_keys, warped_values))
    corr = (target_key[None] * warped_keys).sum(-1)  # [N, S, ...]
    vmask = valid.reshape(valid.shape + (1,) * (corr.dim() - 2))
    logits = torch.where(vmask, corr.float(),
                         torch.full_like(corr, _NEG_INF, dtype=torch.float32))
    attn = torch.softmax(logits, 0)
    attn = torch.where(vmask, attn, torch.zeros_like(attn))
    n_valid = valid.float().sum(0).clamp(min=1.0)  # [S]
    h = (warped_values * attn[..., None]).sum(0)
    return (h / n_valid.reshape((-1,) + (1,) * (h.dim() - 1))).to(dtype)


def _launch(target_key: torch.Tensor, warped_keys: torch.Tensor,
            warped_values: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    dev = target_key.device
    if warped_keys.dim() != 6:
        raise ValueError(f"epipolar_attention: warped_keys "
                         f"{tuple(warped_keys.shape)}, expected "
                         f"[N, B, D, H, W, C]")
    n, b, d, h, w, c = warped_keys.shape
    if c != CHANNELS or not 1 <= n <= MAX_NEIGHBOURS:
        raise ValueError(f"epipolar_attention: the kernel takes C == "
                         f"{CHANNELS} and 1 <= N <= {MAX_NEIGHBOURS}, got "
                         f"C = {c}, N = {n}")
    (tk_batch,), tk_pitch = build.require_voxel_rows(
        target_key, "target_key", (b, d, h, w, c), dev)
    k_lead, k_pitch = build.require_voxel_rows(
        warped_keys, "warped_keys", (n, b, d, h, w, c), dev,
        dtype=target_key.dtype)
    v_lead, v_pitch = build.require_voxel_rows(
        warped_values, "warped_values", (n, b, d, h, w, c), dev,
        dtype=target_key.dtype)
    if (k_lead, k_pitch) != (v_lead, v_pitch):
        raise ValueError(f"epipolar_attention: warped_keys strides "
                         f"{warped_keys.stride()} differ from "
                         f"warped_values strides {warped_values.stride()}")
    if valid.device != dev or tuple(valid.shape) != (n, b):
        raise ValueError(f"epipolar_attention: valid {tuple(valid.shape)} "
                         f"on {valid.device}, expected {(n, b)} on {dev}")
    valid_i = valid.to(torch.int32).contiguous()
    out = torch.empty((b, d, h, w, c), dtype=target_key.dtype, device=dev)
    with torch.cuda.device(dev):  # the C entry launches there
        KERNEL(target_key.dtype, target_key.data_ptr(),
               warped_keys.data_ptr(), warped_values.data_ptr(),
               valid_i.data_ptr(), out.data_ptr(), n, b, d * h * w,
               tk_batch, tk_pitch, k_lead[0], k_lead[1], k_pitch,
               torch.cuda.current_stream().cuda_stream)
    return out


def _plain_contiguous(target_key: torch.Tensor, warped_keys: torch.Tensor,
                      warped_values: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    return epipolar_attention_plain(target_key, warped_keys, warped_values,
                                    valid).contiguous()


def _fake(target_key, warped_keys, warped_values, valid):
    return target_key.new_empty(target_key.shape, dtype=warped_values.dtype)


OP = library.define("epipolar_attention", _plain_contiguous, _launch, _fake)


def epipolar_attention(target_key: torch.Tensor, warped_keys: torch.Tensor,
                       warped_values: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """target_key [B, D, H, W, C]; warped_keys / warped_values
    [N, B, D, H, W, C] (views with a voxel pitch are read in place);
    valid [N, B] bool -> [B, D, H, W, C] contiguous: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    library.check_device("epipolar_attention", target_key)
    return OP(target_key, warped_keys, warped_values, valid)
