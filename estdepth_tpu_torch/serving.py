"""Serving artifacts of the ESTM and Joint window steps (port of
estdepth_tpu/serving.py).

`torch.export` freezes the window step of a DepthNetHybrid in eval mode
into two programs, with its weights and buffers stored in each:

    first    the first window of a scene (no EST fusion yet)
    steady   every later window (EST fusion against the memory FIFO)

and `load_stream` / `load_joint` stream frames through them without
importing the model: a loaded program needs only the five kernels' ops
(ops/cuda/library.py) and the ESTMemory pytree (models/memory.py). The
kernels are `estdepth::*` op nodes in the programs, so a program launches
them on the card and runs their plain versions on the CPU, on whichever
device it is loaded to; an artifact exported on one device is moved to the
other with `torch.export.passes.move_to_device_pass` (the counterpart of
the JAX artifact's `platforms`).

Artifact layout (`export_stream(...).save(dir)`):

    manifest.json   shapes, scales, dtypes, protocol, torch version, device
    first.pt2       torch.export.save of the first window's program
    steady.pt2      the steady state's

A bfloat16 model's programs hold its casts: the weights are stored in
float32 and cast where the model casts them, the memory and the carried
features are bfloat16 (the manifest's `memory_dtype`), and the op nodes
launch the kernels' bf16 instances.

Both programs take the window as `lwindow` (Joint: `seq_length`) separate
float32 frames [B, H, W, 3] in 0..255 and stack them inside the program,
so the runner keeps earlier frames on the device and uploads only the new
ones:

    first (frames, poses [B, lw, 4, 4], intr [B, 3, 3], memory)
                                     -> (depth, memory, feats)
    steady(frames, poses, intr, memory, feats)
                                     -> (depth, memory, feats)

depth is [B, S, H, W] (Joint: [B, seq_length - 2, S, H, W]) for the S
manifest `output_scales`, cast to `output_dtype`. `feats` are the matching
features of the frames the next window shares with this one: lwindow - 1
for the stream (the window slides by one frame), 2 for Joint (windows
advance by seq_length - 2 frames). Eval-mode BatchNorm makes them
per-frame deterministic, so the carry is exact.

A manifest's `protocol` keeps the two kinds apart, and a `VERIFY_FAILED`
file (written by tools/export_serving.py when the artifact disagrees with
the live runner) keeps a quarantined artifact from loading.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from estdepth_tpu_torch.config import resolve_device
from estdepth_tpu_torch.eval.output import trim_depth
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.ops.cuda import library

MANIFEST = "manifest.json"
FIRST = "first.pt2"
STEADY = "steady.pt2"
FORMAT_VERSION = 1
MEMORY_CHANNELS = 16  # key/value channels of the EST memory
JOINT_OVERLAP = 2  # frames a Joint window shares with the next


class WindowStep(nn.Module):
    """The window step of eval/estm.ESTMRunner._step (stream) or of
    tools/eval_joint.JointRunner.run_window (Joint) over frames passed one
    by one. Without `feats` it is the first window's step: matching
    features of every frame, no EST fusion. With `feats`, those of the
    `window - new_frames` frames carried from the previous window, it
    computes the new frames' features and fuses against `memory`. The new
    key/value volume is pushed into `memory` either way."""

    def __init__(self, model, new_frames: int, output_scales,
                 output_dtype=None, joint: bool = False):
        super().__init__()
        self.model = model.eval()
        self.new_frames = new_frames
        self.output_scales = tuple(output_scales)
        self.output_dtype = output_dtype
        self.joint = joint

    def forward(self, frames, poses, intr, memory: ESTMemory, feats=None):
        model = self.model
        imgs = torch.stack(frames, 1)  # [B, lw, H, W, 3]
        b, lw, h, w, _ = imgs.shape
        steady = feats is not None
        n = self.new_frames if steady else lw
        new = model.compute_matching(
            imgs[:, lw - n:].reshape(b * n, h, w, 3)
        ).reshape(b, n, h // 4, w // 4, -1)
        all_feats = torch.cat([feats, new], 1) if steady else new
        outputs, (key, value, pose) = model(
            imgs, poses, intr, memory=memory if steady else None,
            use_est=steady, matching_feats=all_feats)
        memory = memory.push(key, value, pose)
        depth = outputs["depth"]  # [B, T, 4, H, W]
        if self.joint:
            t = depth.shape[1]
            depth = trim_depth(depth.reshape(b * t, 4, h, w),
                               self.output_scales, self.output_dtype)
            depth = depth.reshape(b, t, -1, h, w)
        else:  # the window's centre frame
            depth = trim_depth(depth[:, 0], self.output_scales,
                               self.output_dtype)
        return depth, memory, all_feats[:, self.new_frames:]


def _dtype_name(dtype) -> str | None:
    return None if dtype is None else str(dtype).removeprefix("torch.")


def fresh_memory(manifest: dict, device=None) -> ESTMemory:
    """The empty FIFO the manifest's programs take."""
    return ESTMemory.create(
        manifest["batch"], manifest["memory_size"], manifest["ndepths"],
        manifest["height"] // 4, manifest["width"] // 4,
        manifest["memory_channels"],
        dtype=getattr(torch, manifest["memory_dtype"]), device=device)


@dataclasses.dataclass
class StreamArtifact:
    """An exported window step: the manifest and the two programs."""

    manifest: dict
    first: torch.export.ExportedProgram
    steady: torch.export.ExportedProgram

    def save(self, directory: str) -> int:
        """Write the artifact into `directory`; returns its bytes."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, MANIFEST), "w") as f:
            json.dump(self.manifest, f, indent=2, sort_keys=True)
        torch.export.save(self.first, os.path.join(directory, FIRST))
        torch.export.save(self.steady, os.path.join(directory, STEADY))
        return sum(os.path.getsize(os.path.join(directory, name))
                   for name in (MANIFEST, FIRST, STEADY))


def _export(model, protocol: str, height: int, width: int, batch: int,
            window: int, memory_size: int, output_scales, output_dtype,
            device) -> StreamArtifact:
    """Both programs of one protocol, traced on `device` at fixed shapes
    with the ops' shape functions (no kernel runs)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    new_frames = 1 if protocol == "stream" else window - JOINT_OVERLAP
    manifest = {
        "format_version": FORMAT_VERSION,
        "protocol": protocol,
        "torch_version": torch.__version__,
        "device": dev.type,
        "height": height,
        "width": width,
        "batch": batch,
        "lwindow" if protocol == "stream" else "seq_length": window,
        "memory_size": memory_size,
        "ndepths": model.cfg.ndepths,
        "memory_channels": MEMORY_CHANNELS,
        "memory_dtype": _dtype_name(model.compute_dtype),
        "output_scales": list(output_scales),
        "output_dtype": _dtype_name(output_dtype),
    }
    frames = tuple(torch.zeros(batch, height, width, 3, device=dev)
                   for _ in range(window))
    poses = torch.eye(4, device=dev).expand(batch, window, 4, 4).clone()
    intr = torch.eye(3, device=dev).expand(batch, 3, 3).clone()
    memory = fresh_memory(manifest, dev)
    channels = model.matchingFeature.lastconv[-1].out_channels
    feats = torch.zeros(batch, window - new_frames, height // 4, width // 4,
                        channels, dtype=model.compute_dtype, device=dev)
    step = WindowStep(model, new_frames, output_scales, output_dtype,
                      joint=protocol == "joint")
    programs = []
    with torch.no_grad():
        for args in ((frames, poses, intr, memory),
                     (frames, poses, intr, memory, feats)):
            program = torch.export.export(step, args, strict=False)
            # the example inputs would be saved with the program: the
            # memory alone is 2 x 42 MB at the flagship width
            program.example_inputs = None
            programs.append(program)
    return StreamArtifact(manifest, *programs)


def export_stream(model, *, height: int, width: int, batch: int = 1,
                  lwindow: int = 3, memory_size: int = 2,
                  output_scales=(0,), output_dtype=None,
                  device=None) -> StreamArtifact:
    """The ESTM window step (eval/estm.ESTMRunner) as a serving artifact,
    exported on `device` (None: the CUDA device). `output_dtype` casts the
    returned maps only (e.g. torch.bfloat16); the model computes in its
    `compute_dtype`, which the memory and the carried features take."""
    return _export(model, "stream", height, width, batch, lwindow,
                   memory_size, output_scales, output_dtype, device)


def export_joint(model, *, height: int, width: int, batch: int = 1,
                 seq_length: int = 5, output_scales=(0,), output_dtype=None,
                 device=None) -> StreamArtifact:
    """The Joint window step (tools/eval_joint.JointRunner) as a serving
    artifact: seq_length-frame windows advancing by seq_length - 2 frames,
    seq_length - 2 target depths per window, a 1-entry memory."""
    return _export(model, "joint", height, width, batch, seq_length, 1,
                   output_scales, output_dtype, device)


class ExportedStreamRunner:
    """Streams frames through a loaded artifact with the bookkeeping of
    eval/estm.ESTMRunner: a window sliding by one frame, the memory FIFO,
    the carried matching features, `reset()` per scene. Frames stay on the
    device: each call uploads its one new frame (uint8 as uint8, cast on
    the device). Returns device tensors."""

    def __init__(self, manifest: dict, first, steady, device: torch.device):
        self.manifest = manifest
        self._first = first
        self._steady = steady
        self.device = device
        self.batch = manifest["batch"]
        self.window = manifest.get("lwindow", manifest.get("seq_length"))
        self.stride = 1
        self.reset()

    def reset(self) -> None:
        """New scene: clear the window, the memory and the intrinsics."""
        self._window_imgs: list[torch.Tensor] = []
        self._window_poses: list[torch.Tensor] = []
        self._feats = None
        self._intr = None
        self._memory = fresh_memory(self.manifest, self.device)

    def _upload(self, img, pose) -> None:
        img = torch.as_tensor(np.asarray(img))
        if img.dtype != torch.uint8:
            img = img.float()
        if img.dim() == 3:
            img = img[None].expand(self.batch, *img.shape)
        pose = torch.as_tensor(np.asarray(pose, np.float32))
        if pose.dim() == 2:
            pose = pose[None].expand(self.batch, 4, 4)
        self._window_imgs.append(
            img.to(self.device).float().contiguous())
        self._window_poses.append(pose.to(self.device).contiguous())

    @torch.inference_mode()
    def _step(self, intr):
        if self._intr is None:
            k = torch.as_tensor(np.asarray(intr, np.float32))
            k = k[None] if k.dim() == 2 else k
            if k.shape[0] != self.batch:
                k = k[:1].expand(self.batch, 3, 3)
            self._intr = k.to(self.device).contiguous()
        frames = tuple(self._window_imgs)
        poses = torch.stack(self._window_poses, 1)
        if self._feats is None:
            out = self._first(frames, poses, self._intr, self._memory)
        else:
            out = self._steady(frames, poses, self._intr, self._memory,
                               self._feats)
        depth, self._memory, self._feats = out
        del self._window_imgs[:self.stride]
        del self._window_poses[:self.stride]
        return depth

    def push_frame(self, img, pose, intr):
        """Feed one frame ([H, W, 3] or [B, H, W, 3], uint8 or float in
        0..255; pose [4, 4] or [B, 4, 4]; intr [3, 3] or [B, 3, 3]);
        returns the window centre's depth [B, S, H, W] once the window is
        full, else None."""
        self._upload(img, pose)
        if len(self._window_imgs) < self.window:
            return None
        return self._step(intr)


class ExportedJointRunner(ExportedStreamRunner):
    """ExportedStreamRunner's Joint counterpart (tools/eval_joint's
    JointRunner chain, frames fed one at a time): every completed
    seq_length window (the first after seq_length frames, then every
    seq_length - 2) returns its [B, seq_length - 2, S, H, W] target
    depths; the 2 overlap frames stay on the device."""

    def __init__(self, manifest: dict, first, steady, device: torch.device):
        super().__init__(manifest, first, steady, device)
        self.stride = self.window - JOINT_OVERLAP


def _read_artifact(directory: str, expected_protocol: str, loader_name: str,
                   device):
    marker = os.path.join(directory, "VERIFY_FAILED")
    if os.path.exists(marker):
        with open(marker) as f:
            reason = f.read().strip()
        raise ValueError(f"artifact {directory} failed export-time "
                         f"verification ({reason}); re-export it")
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"artifact format {manifest.get('format_version')}"
                         f" != {FORMAT_VERSION}")
    protocol = manifest.get("protocol", "stream")
    if protocol != expected_protocol:
        raise ValueError(f"artifact {directory} is protocol {protocol!r}; "
                         f"load it with load_{protocol} (not "
                         f"{loader_name})")
    dev = resolve_device(device)
    library.load_ops()
    programs = []
    for name in (FIRST, STEADY):
        program = torch.export.load(os.path.join(directory, name))
        if manifest["device"] != dev.type:
            program = move_to_device_pass(program, dev)
        programs.append(program.module())
    return manifest, *programs, dev


def load_stream(directory: str, device=None) -> ExportedStreamRunner:
    """A saved stream artifact as a ready runner on `device` (None: the
    CUDA device, raising when there is none)."""
    return ExportedStreamRunner(
        *_read_artifact(directory, "stream", "load_stream", device))


def load_joint(directory: str, device=None) -> ExportedJointRunner:
    """A saved Joint artifact as a ready runner on `device`."""
    return ExportedJointRunner(
        *_read_artifact(directory, "joint", "load_joint", device))
