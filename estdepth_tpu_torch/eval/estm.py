"""ESTM streaming inference (port of estdepth_tpu/eval/estm.py; reference
eval_hybrid_seq.py:124-261).

A sliding window of `lwindow` frames plus a FIFO memory of `memory_size`
detached key/value volumes. Each frame, once the window is full, yields
the depth of the window's centre frame. The first window of a scene runs
without EST fusion, later windows with it (hybrid_depth_decoder.py:423).
Matching features of the lwindow-1 frames shared with the previous window
are carried over, so the matching encoder runs on the new frame only.

Spans (utils/trace.py): `step` around `push_frame`; inside it
`host_wait.upload` around the frame's, the pose's and the intrinsics'
copies to the device (pageable host memory: on CUDA each copy waits for
the device's queue to drain), the model's own and the output scales'
`host_wait.constant` (eval/output.py).
"""

from __future__ import annotations

import numpy as np
import torch

from estdepth_tpu_torch.config import resolve_device
from estdepth_tpu_torch.eval.output import trim_depth
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.utils import trace


class ESTMRunner:
    """Streaming runner around the model's window step.

    push_frame returns a device tensor; reading it to the host is the
    caller's choice. The model is moved to `device` (None: the CUDA
    device, raising when there is none) and kept in eval mode; the memory
    is in its compute dtype."""

    def __init__(
        self,
        model: DepthNetHybrid,
        height: int,
        width: int,
        lwindow: int = 3,
        memory_size: int = 2,
        batch: int = 1,
        reference_pose_pairing: bool = False,
        output_scales: tuple = (0, 1, 2, 3),
        output_dtype=None,
        return_probs: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.height = height
        self.width = width
        self.lwindow = lwindow
        self.memory_size = memory_size
        self.batch = batch
        self.reference_pose_pairing = reference_pose_pairing
        self.output_scales = tuple(output_scales)
        self.output_dtype = output_dtype
        self.return_probs = return_probs
        self._window_imgs: list[torch.Tensor] = []   # [B, H, W, 3]
        self._window_poses: list[torch.Tensor] = []  # [B, 4, 4]
        self._intr = None
        self._memory_filled = False
        self._feats = None  # [B, lwindow-1, H/4, W/4, C] of shared frames
        self.memory = self._fresh_memory()

    def _fresh_memory(self) -> ESTMemory:
        return ESTMemory.create(
            self.batch, self.memory_size, self.model.cfg.ndepths,
            self.height // 4, self.width // 4, 16,
            dtype=self.model.compute_dtype, device=self.device,
        )

    def reset(self) -> None:
        """New scene: clear window, memory and the intrinsics
        (eval_hybrid_seq.py:163-167)."""
        self._window_imgs.clear()
        self._window_poses.clear()
        self.memory = self._fresh_memory()
        self._memory_filled = False
        self._feats = None
        self._intr = None

    @torch.inference_mode()
    def _step(self, use_est: bool):
        model = self.model
        imgs = torch.stack(self._window_imgs, 1)  # [B, lw, H, W, 3]
        poses = torch.stack(self._window_poses, 1)  # [B, lw, 4, 4]
        b, lw, h_img, w_img, _ = imgs.shape
        if self._feats is None:  # first window: every frame
            feats = model.compute_matching(
                imgs.reshape(b * lw, h_img, w_img, 3)
            ).reshape(b, lw, h_img // 4, w_img // 4, -1)
        else:
            new = model.compute_matching(imgs[:, -1])
            feats = torch.cat([self._feats, new[:, None]], 1)
        outputs, (key, value, pose) = model(
            imgs, poses, self._intr, memory=self.memory if use_est else None,
            use_est=use_est, matching_feats=feats,
        )
        self.memory = self.memory.push(
            key, value, pose,
            reference_pose_pairing=self.reference_pose_pairing)
        self._feats = feats[:, 1:]
        # centre-frame depth (eval_hybrid_seq.py:200-258)
        depth = trim_depth(outputs["depth"][:, 0], self.output_scales,
                           self.output_dtype)
        if self.return_probs:
            probs = torch.stack([outputs["init_prob"][:, 0],
                                 outputs["fused_prob"][:, 0]], 1)
            return depth, probs
        return depth

    @trace.spanned("step")
    def push_frame(self, img, pose, intr):
        """Feed one frame per stream; returns [B, S, H, W] centre-frame depth
        (S = len(output_scales)), or (depth, probs [B, 2, H, W]) with
        return_probs, once the window is full, else None.

        img is [H, W, 3] (replicated to every stream) or [B, H, W, 3], uint8
        or float in 0..255; uint8 is uploaded as uint8 and cast on the
        device. pose is [4, 4] or [B, 4, 4]; intr [3, 3] or [B, 3, 3]."""
        img = torch.as_tensor(np.asarray(img))
        if img.dtype != torch.uint8:
            img = img.float()
        if img.dim() == 3:
            img = img[None].expand(self.batch, *img.shape)
        pose = torch.as_tensor(np.asarray(pose, np.float32))
        if pose.dim() == 2:
            pose = pose[None].expand(self.batch, 4, 4)
        with trace.host_wait("upload"):
            self._window_imgs.append(img.to(self.device).contiguous())
            self._window_poses.append(pose.to(self.device).contiguous())
        if len(self._window_imgs) < self.lwindow:
            return None
        if self._intr is None:
            k = torch.as_tensor(np.asarray(intr, np.float32))
            k = k[None] if k.dim() == 2 else k
            if k.shape[0] != self.batch:
                k = k[:1].expand(self.batch, 3, 3)
            with trace.host_wait("upload"):
                self._intr = k.to(self.device).contiguous()
        out = self._step(use_est=self._memory_filled)
        self._memory_filled = True
        # slide the window by one (eval_hybrid_seq.py:190)
        self._window_imgs.pop(0)
        self._window_poses.pop(0)
        return out
