"""Whole-sequence evaluation: the offline processors (port of
estdepth_tpu/eval/sequence.py; reference eval_hybrid_seq.py:169-193 and
eval_hybrid.py:229-243).

The JAX package runs a scene's window chain as one `lax.scan` program with
the ESTMemory FIFO as the carry. PyTorch runs eagerly, so the scan is a
plain Python loop under `torch.inference_mode()`; what the processors keep
from the scan form is its economy: a scene is uploaded once (or chunk by
chunk), the matching features of every frame are computed once in one
batched encoder call, and nothing is read back before the chain ends.

Semantics match the window-by-window runners exactly: the first window
runs without EST fusion (hybrid_depth_decoder.py:423), every later window
fuses in-window neighbours and the memory.

  * make_sequence_processor: the stride-1 ESTM chain over a whole clip;
  * make_joint_processor: the Joint chain (seq_length-frame windows
    advancing by seq_length-2, a 1-entry memory);
  * SequenceProcessor: ESTM over scenes of any length in chunks of
    `chunk` frames, with the memory and the lwindow-1 shared frames'
    features carried across chunk boundaries, and several scenes of
    different lengths batched.

The signatures are the JAX package's without `variables` (the module holds
its weights) and with `device` (None: the CUDA device; "cpu" on request).
"""

from __future__ import annotations

import numpy as np
import torch

from estdepth_tpu_torch.config import resolve_device
from estdepth_tpu_torch.eval.output import FULL_SCALES, to_numpy, trim_depth
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory


def _on(device, x, keep_uint8: bool = False) -> torch.Tensor:
    """x (numpy or tensor) on `device`: float32, or uint8 left as it is
    (a quarter of the upload; the model casts on the device, exactly)."""
    t = torch.as_tensor(x)
    if not (keep_uint8 and t.dtype == torch.uint8):
        t = t.float()
    return t.to(device)


def _matching(model, frames: torch.Tensor) -> torch.Tensor:
    """Matching features of frames [B, T, H, W, 3] in one encoder call:
    [B, T, H/4, W/4, C]."""
    b, t, h, w, _ = frames.shape
    return model.compute_matching(frames.reshape(b * t, h, w, 3)).reshape(
        b, t, h // 4, w // 4, -1)


def _window_step(model, frames, poses, intr, feats, start: int, length: int,
                 memory: ESTMemory, use_est: bool,
                 reference_pose_pairing: bool):
    """One window [start, start + length): all targets' depth
    [B, T, 4, H, W] and the memory with the window's state pushed."""
    sl = slice(start, start + length)
    outputs, (key, value, pose) = model(
        frames[:, sl], poses[:, sl], intr,
        memory=memory if use_est else None, use_est=use_est,
        matching_feats=feats[:, sl])
    return outputs["depth"], memory.push(
        key, value, pose, reference_pose_pairing=reference_pose_pairing)


def make_sequence_processor(model: DepthNetHybrid, lwindow: int = 3,
                            memory_size: int = 2,
                            reference_pose_pairing: bool = False,
                            output_scales: tuple = FULL_SCALES,
                            output_dtype=None, device=None):
    """Returns fn(frames, poses, intr) -> depths for the ESTM chain.

    frames [B, T, H, W, 3] (0..255), poses [B, T, 4, 4], intr [B, 3, 3],
    numpy or tensors. Result [B, T - lwindow + 1, S, H, W] on the device:
    the centre-frame depth of each sliding window in frame order,
    S = len(output_scales)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def process(frames, poses, intr):
        frames = _on(dev, frames, keep_uint8=True)
        poses, intr = _on(dev, poses), _on(dev, intr)
        b, t, h, w, _ = frames.shape
        memory = ESTMemory.create(b, memory_size, model.cfg.ndepths, h // 4,
                                  w // 4, 16, dtype=model.compute_dtype,
                                  device=dev)
        feats = _matching(model, frames)
        depths = []
        for start in range(t - lwindow + 1):
            depth, memory = _window_step(
                model, frames, poses, intr, feats, start, lwindow, memory,
                start > 0, reference_pose_pairing)
            depths.append(trim_depth(depth[:, 0], output_scales,
                                     output_dtype))
        return torch.stack(depths, 1)

    return process


def make_joint_processor(model: DepthNetHybrid, seq_length: int = 5,
                         est_on: bool = True,
                         reference_pose_pairing: bool = False,
                         output_scales: tuple = FULL_SCALES,
                         output_dtype=None, device=None):
    """Returns fn(frames, poses, intr) -> depths for the Joint chain.

    frames [B, T, H, W, 3] is the SAMPLED frame sequence (already spaced
    by the eval frame interval). Result [B, NW, seq_length-2, S, H, W]:
    each window's depth of its seq_length-2 target frames,
    NW = (T - seq_length) // stride + 1 with stride = seq_length - 2; tail
    frames beyond the window grid are ignored. The last target's state
    threads to the next window as a 1-entry memory; `est_on=False` runs
    the pure stereo path in every window (the --no-est protocol). With
    reference_pose_pairing, window 0's last-target pose is paired with
    every later volume (see ESTMemory.push)."""
    stride = seq_length - 2
    if stride < 1:
        raise ValueError("seq_length must be at least 3")
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def process(frames, poses, intr):
        frames = _on(dev, frames, keep_uint8=True)
        poses, intr = _on(dev, poses), _on(dev, intr)
        b, t, h, w, _ = frames.shape
        # an empty (valid=False) slot: window 0's push stores its OWN pose,
        # so the strict-pairing induction starts as in JointRunner
        memory = ESTMemory.create(b, 1, model.cfg.ndepths, h // 4, w // 4,
                                  16, dtype=model.compute_dtype, device=dev)
        feats = _matching(model, frames)
        depths = []
        for wi in range((t - seq_length) // stride + 1):
            depth, memory = _window_step(
                model, frames, poses, intr, feats, wi * stride, seq_length,
                memory, est_on and wi > 0, reference_pose_pairing)
            depths.append(trim_depth(depth.flatten(0, 1), output_scales,
                                     output_dtype).unflatten(0, depth.shape[:2]))
        return torch.stack(depths, 1)

    return process


class SequenceProcessor:
    """Chunked whole-scene ESTM evaluation.

    A scene of any length is processed in chunks of `chunk` frames, so the
    frames and matching features held on the device are bounded by the
    chunk and not by the scene. Consecutive chunks overlap by lwindow-1
    frames (the sliding window spans the boundary); those frames' features
    and the ESTMemory FIFO are carried over, so the window sequence is
    IDENTICAL to frame-by-frame streaming and each frame's features are
    computed exactly once."""

    def __init__(self, model: DepthNetHybrid, lwindow: int = 3,
                 memory_size: int = 2, chunk: int = 16,
                 reference_pose_pairing: bool = False,
                 output_scales: tuple = FULL_SCALES, output_dtype=None,
                 device=None):
        """output_scales / output_dtype trim what is fetched to the host,
        once per chunk, to the depth scales (and precision) the consumer
        reads. A bfloat16 fetch (numpy has no bfloat16) is copied to the
        host as bfloat16 and given as float32 there."""
        if chunk < lwindow:
            raise ValueError(f"chunk {chunk} is shorter than the window "
                             f"{lwindow}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.lwindow = lwindow
        self.memory_size = memory_size
        self.chunk = chunk
        # windows emitted per chunk = frame stride between chunk starts
        self.stride = chunk - (lwindow - 1)
        self.reference_pose_pairing = reference_pose_pairing
        self.output_scales = tuple(output_scales)
        self.output_dtype = output_dtype

    def process_scene(self, frames, poses, intr) -> np.ndarray:
        """frames [T, H, W, 3] (0..255, float or uint8), poses [T, 4, 4],
        intr [3, 3] -> [T - lwindow + 1, S, H, W] centre-frame depths."""
        return self.process_scenes([(frames, poses, intr)])[0]

    @torch.inference_mode()
    def process_scenes(self, scenes) -> list:
        """Evaluate B INDEPENDENT scenes as one batch.

        scenes: list of (frames [T_i, H, W, 3], poses [T_i, 4, 4],
        intr [3, 3]); lengths may differ. Each scene's window chain (the
        first window's no-EST flag, the memory FIFO) is independent
        because the batch axis never mixes. Shorter scenes are padded to
        the longest by repeating their last frame and the padded windows'
        outputs dropped, so the result equals B separate process_scene
        runs. Returns a list of [T_i - lwindow + 1, S, H, W] arrays."""
        lw, dev, model = self.lwindow, self.device, self.model
        ts = [np.asarray(s[0]).shape[0] for s in scenes]
        for t in ts:
            if t < lw:
                raise ValueError(f"scene has {t} frames but the sliding "
                                 f"window needs at least {lw}")
        t_max = max(ts)
        all_u8 = all(np.asarray(s[0]).dtype == np.uint8 for s in scenes)

        def pad(x, t):  # repeat the last frame up to t_max
            x = np.asarray(x)
            if not (all_u8 and x.dtype == np.uint8):
                x = x.astype(np.float32, copy=False)
            return x if t == t_max else np.concatenate(
                [x, np.repeat(x[-1:], t_max - t, axis=0)], 0)

        frames_b = np.stack([pad(s[0], t) for s, t in zip(scenes, ts)])
        poses_b = np.stack([pad(np.asarray(s[1], np.float32), t)
                            for s, t in zip(scenes, ts)])
        intr = _on(dev, np.stack([np.asarray(s[2], np.float32)
                                  for s in scenes]))
        b, _, h, w, _ = frames_b.shape
        memory = ESTMemory.create(b, self.memory_size, model.cfg.ndepths,
                                  h // 4, w // 4, 16,
                                  dtype=model.compute_dtype, device=dev)
        fetched, carry = [], None
        # chunk starts advance by `stride`; the last chunk is as long as
        # the frames that are left
        for start in range(0, t_max - lw + 1, self.stride):
            end = min(start + self.chunk, t_max)
            frames = _on(dev, frames_b[:, start:end], keep_uint8=True)
            poses = _on(dev, poses_b[:, start:end])
            if carry is None:
                feats = _matching(model, frames)
            else:  # the first lw-1 frames came with the previous chunk
                feats = torch.cat(
                    [carry, _matching(model, frames[:, lw - 1:])], 1)
            depths = []
            for s in range(end - start - lw + 1):
                depth, memory = _window_step(
                    model, frames, poses, intr, feats, s, lw, memory,
                    start + s > 0, self.reference_pose_pairing)
                depths.append(trim_depth(depth[:, 0], self.output_scales,
                                         self.output_dtype))
            fetched.append(to_numpy(torch.stack(depths, 1).cpu()))
            carry = feats[:, self.stride:]
        out = np.concatenate(fetched, 1)  # [B, T_max - lw + 1, S, H, W]
        return [out[i, :t - lw + 1] for i, t in enumerate(ts)]
