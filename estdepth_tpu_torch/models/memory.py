"""ESTM streaming state: a fixed-shape FIFO of key/value cost volumes (port
of estdepth_tpu/models/memory.py; reference eval_hybrid_seq.py:70,190-193).

`ESTMemory` crosses the boundary of an exported serving program
(serving.py) as a pytree of its four tensors; `register_serialization`
(run at import) names it for `torch.export` and lets `torch.load`'s
weights-only reader rebuild it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ESTMemory:
    """FIFO memory of M past key/value volumes (newest at slot M-1).

    keys/values: [B, M, D, H, W, C]; poses: [B, M, 4, 4] cam-to-world;
    valid: [B, M] bool, False for slots not yet filled (zeros with an
    identity pose — the fusion warps them anyway and the attention masks
    them)."""

    keys: torch.Tensor
    values: torch.Tensor
    poses: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.keys.shape[1]

    @classmethod
    def create(cls, batch: int, memory_size: int, ndepths: int, height: int,
               width: int, channels: int = 16, dtype=torch.float32,
               device=None) -> "ESTMemory":
        shape = (batch, memory_size, ndepths, height, width, channels)
        return cls(
            keys=torch.zeros(shape, dtype=dtype, device=device),
            values=torch.zeros(shape, dtype=dtype, device=device),
            poses=torch.eye(4, device=device).expand(
                batch, memory_size, 4, 4).clone(),
            valid=torch.zeros(batch, memory_size, dtype=torch.bool,
                              device=device),
        )

    def push(self, key: torch.Tensor, value: torch.Tensor, pose: torch.Tensor,
             reference_pose_pairing: bool = False) -> "ESTMemory":
        """Append (key [B,D,H,W,C], value, pose [B,4,4]) dropping the oldest
        entry; gradients are cut (hybrid_depth_decoder.py:215-216).

        reference_pose_pairing reproduces the reference's pose bookkeeping:
        once memory is non-empty, the pose stored with the new volume is the
        newest existing memory pose (hybrid_depth_decoder.py:221,292). The
        default pairs each volume with its own pose."""
        key = key.detach()
        value = value.detach()
        if reference_pose_pairing:
            newest_valid = self.valid[:, -1]
            pose = torch.where(newest_valid[:, None, None], self.poses[:, -1],
                               pose)
        return ESTMemory(
            keys=torch.cat([self.keys[:, 1:], key[:, None]], 1),
            values=torch.cat([self.values[:, 1:], value[:, None]], 1),
            poses=torch.cat([self.poses[:, 1:], pose[:, None]], 1),
            valid=torch.cat([self.valid[:, 1:],
                             torch.ones_like(self.valid[:, :1])], 1),
        )


SERIALIZED_NAME = "estdepth_tpu_torch.models.memory.ESTMemory"
_registered = False


def register_serialization() -> None:
    """Register ESTMemory with torch.export under SERIALIZED_NAME, and as a
    class a weights-only load may rebuild (an exported program keeps its
    example inputs). Registering again does nothing."""
    global _registered
    if _registered:
        return
    torch.export.register_dataclass(ESTMemory,
                                    serialized_type_name=SERIALIZED_NAME)
    torch.serialization.add_safe_globals([ESTMemory])
    _registered = True


register_serialization()
