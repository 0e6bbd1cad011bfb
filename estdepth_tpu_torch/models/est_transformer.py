"""Epipolar spatio-temporal transformer: per-voxel attention over warped
neighbour volumes + ConvGRU fusion (port of
estdepth_tpu/models/est_transformer.py, its attention path at :70-86;
reference epipolar_transformer.py:10-83).

Inputs and output are channels-last like the JAX module; the GRU convs run
NCDHW. Neighbours are a static leading axis with a validity mask: the
softmax masks invalid neighbours, h = sum(attn * v) / n_valid, and with no
neighbours at all h = 0 (the reference's zero-h fallback, :78-79).

The attention stage is ops/cuda/epipolar_attention: its plain PyTorch
version by default, and with `use_fused_attention` (the counterpart of the
JAX module's `use_pallas`) the wrapper that launches the CUDA kernel on
CUDA tensors. Both compute the logits and the softmax in float32 and
return the values' dtype. On bf16 volumes (a bf16 model) the GRU's
convolutions and gates run in bf16 and its GroupNorms normalize in
float32 and return bf16 (models/layers.py), as the JAX module with
`dtype=bfloat16`.

A grad-free, unsharded call on CUDA tensors runs each GroupNorm and the
activation after it as one op `estdepth::group_norm_act`
(ops/cuda/group_norm_act.py), whose kernel spreads each group over the
whole card: the reset and update gates as one call over all 2C gate
channels in 2 groups (GroupNorm(1) of each half is GroupNorm(2) of the
whole), the output norm as another. Training, the CPU and the
width-sharded forward run the modules as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from estdepth_tpu_torch.models.layers import Conv3d, GroupNorm
from estdepth_tpu_torch.ops import shard_context
from estdepth_tpu_torch.ops.cuda.epipolar_attention import (
    epipolar_attention, epipolar_attention_plain,
)
from estdepth_tpu_torch.ops.cuda.group_norm_act import group_norm_act


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


class EpipolarTransformer(nn.Module):
    """channels: key/value channel count (reference base_channels // 2).
    use_fused_attention: run the attention stage through kernel 5."""

    def __init__(self, channels: int = 16, use_fused_attention: bool = False):
        super().__init__()
        c = channels
        self.channels = c
        self.use_fused_attention = use_fused_attention
        self.gate_conv = Conv3d(2 * c, 2 * c, 3, padding=1)
        self.output_conv = Conv3d(2 * c, c, 3, padding=1)
        self.reset_gate_norm = GroupNorm(1, c, eps=1e-5)
        self.update_gate_norm = GroupNorm(1, c, eps=1e-5)
        self.output_norm = GroupNorm(1, c, eps=1e-5)

    def forward(
        self,
        target_key: torch.Tensor,      # [B, D, H, W, C]
        target_value: torch.Tensor,    # [B, D, H, W, C]
        warped_keys: torch.Tensor | None = None,    # [N, B, D, H, W, C]
        warped_values: torch.Tensor | None = None,  # [N, B, D, H, W, C]
        neighbor_valid: torch.Tensor | None = None,  # [N, B] bool
    ) -> torch.Tensor:
        c = self.channels
        if warped_keys is not None and warped_keys.shape[0] > 0:
            n, b = warped_keys.shape[:2]
            if neighbor_valid is None:
                neighbor_valid = torch.ones(n, b, dtype=torch.bool,
                                            device=target_key.device)
            if self.use_fused_attention:
                # the kernel reads a voxel's channels as one row, and the
                # decoder's keys are a view of a conv's NCDHW output: only
                # this route pays for the channels-last copy
                h = epipolar_attention(target_key.contiguous(), warped_keys,
                                       warped_values, neighbor_valid)
            else:
                h = epipolar_attention_plain(target_key, warped_keys,
                                             warped_values, neighbor_valid)
        else:
            h = torch.zeros_like(target_value)

        x = _to_ncdhw(target_value)
        h = _to_ncdhw(h)
        gates = self.gate_conv(torch.cat([x, h], 1))
        fused = (gates.is_cuda and not torch.is_grad_enabled()
                 and shard_context.current() is None)
        if fused:
            rn, un = self.reset_gate_norm, self.update_gate_norm
            ru = group_norm_act(
                gates.contiguous(), torch.cat([rn.weight, un.weight]),
                torch.cat([rn.bias, un.bias]), 2, rn.eps, "sigmoid")
            r, u = ru[:, :c], ru[:, c:]
        else:
            r = torch.sigmoid(self.reset_gate_norm(gates[:, :c]))
            u = torch.sigmoid(self.update_gate_norm(gates[:, c:]))
        o = self.output_conv(torch.cat([x, r * h], 1))
        if fused:
            on = self.output_norm
            y = group_norm_act(o.contiguous(), on.weight, on.bias, 1, on.eps,
                               "tanh")
        else:
            y = torch.tanh(self.output_norm(o))
        out = u * h + (1.0 - u) * y
        return out.permute(0, 2, 3, 4, 1)
