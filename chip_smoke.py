#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from estdepth_tpu_torch/csrc, holds
each against its plain PyTorch version at the flagship shapes of the path
that runs it, and the warp kernels' gradients against autograd of their
plain versions; checks the plane-sweep kernel against the analytic depth of
a synthetic scene; holds a small ESTM stream, a small Joint chain and three
small training steps on the card against the plain path on the CPU; and
drives three paths at full width (256x320, D = 64, ResNet-50, float32,
random weights from a seed; bf16 below) through the kernels: the ESTM
streaming step (lwindow 3, memory 2), the Joint window chain (5 frames
in, 3 depth maps out, a 1-entry memory; once with the default warp and
once with the plane-mix warp and the attention kernel), and the training
step of tools/train.py (5-frame windows, batch 1, EST on; once with the
default plane sweep and once through the fused two-pass resample). Last,
the dataset path: a scene written in ScanNet's layout (640x480 PNGs, one
non-finite pose) and a reference-format checkpoint of the seed-0 model go
through the ESTM and Joint eval tools' own `run` (maps saved, ground
truth scored at 640x480) and tools/score_offline.py rescores the ESTM
dump; the tools' maps are held bit for bit against an ESTMRunner fed the
same frames. Then training from recorded scenes: a scene written in
ScanNet's training layout (640x480 JPEG colour, one JPEG corrupt, 200 pose
ids of which every 10th is sampled) and a seeded torchvision-layout
ResNet-50 go through tools/train.py's `run` (`--datapath`,
`--pretrained-encoder`, 4 decode threads, image dumps), after the native
window reader is held against cv2 on that scene; one more run trains
ResNet-101. Serving: the stream step and the Joint step (default warp;
plane-mix warp with the attention kernel) are exported on the card by
tools/export_serving.py (oracle-checked there), loaded back and streamed
beside the live runners in turns, and a small artifact exported on the
CPU is loaded onto the card, where its op nodes must launch the kernels.
Last, the release flow: the training checkpoint of the full-width path
through tools/export_torch.py, `export_serving --ckpt --verify 4` and
tools/rehearse_release_ckpt.py's convert, eval and score steps on the
ScanNet-layout scene. The bf16 model (ModelConfig.compute_dtype
"bfloat16", the tools' --bf16): each kernel row also holds its bf16
instance against the plain bf16 version (kernels 1 to 4 bit for bit, the
attention kernel within one bf16 ulp) and times it in turns with the
float32 instance and, where the row has one, the library call on the
bf16 inputs; a small bf16 stream on the card is held against the CPU;
and the ESTM stream, both Joint chains, the training step and a bf16
stream artifact run at full width through the bf16 instances, each in
turns with the float32 model. Data-parallel training (phase
`train_ddp`, at the training step's full width): tools/train.py
--multihost on one NCCL rank in turns with the one-device run, float32
and bf16 (losses, BatchNorm statistics, kernel launches per step, ms per
step, peak memory), then two gloo ranks on the one card, each a process
of this script (`--ddp-rank R --port P --out DIR`), driving
parallel.mesh and the trainer directly: equal losses and parameters
across the ranks, agreement with the one-process step on both ranks'
windows, rank 0's checkpoint loaded into a one-device model, and the
share of each step with a collective in flight. The SENet model (phase
`senet_path`, ModelConfig.feature_net "senet"): a small stream, Joint
chain and bf16 stream on the card against the CPU, the full-width ESTM
stream and Joint chain in turns with the PSM model in float32 and bf16
(the same kernel launches), and 3 training steps. `--scan
--scene-batch` (phase `scene_batch`): both eval tools over five scenes
of unequal lengths at --scene-batch 1 and 4 in turns, float32 and bf16:
the maps of batch 4 against batch 1 and against a runner, one group's
launches against one scene's, kernels 1 and 2 bit-equal to their plain
versions at the batch-4 shapes, frames (targets) per second, peak
memory and the device's idle share. The width-sharded forward (phase
`spatial_shard`, parallel/spatial.make_spatial_window_fn at the flagship
width): two gloo ranks on the one card, each a process of this script
(`--spatial-rank R --port P --out DIR`) holding 160 columns, in turns
with the one-device model: the ESTM stream with its memory carried as
each rank's K/V columns, a 5-frame Joint window and a plane-mix window,
the gathered maps against the one-device maps, kernels 1, 2 and 4 at
each rank's output window against the whole launch's columns, ms per
window, collectives, bytes, collective share and peak memory per rank.
Every phase prints one line; any failure raises and exits non-zero. The last line is {"ok":
true, "device": {...}}.

A kernel's time is device ms per call, from runs of 20 back-to-back calls
queued while the device is held busy, one CUDA event pair per run; where a
PyTorch call computes the same memory work (F.grid_sample,
scaled_dot_product_attention) the kernel and that call are timed in turns.
The two frustum warps (kernels 2 and 4, one body: csrc/frustum_gather.cuh)
are held bit for bit in both instances, also at a rolled pose, timed in
turns with a 5-D F.grid_sample at (x, y, z*) (another function, a
yardstick of the same 8-tap memory work), with their instances'
registers and shared memory (tools/kernel_report).

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.config import (
    ModelConfig, set_fp32_numerics, torch_dtype,
)
from estdepth_tpu_torch.data import io_utils, native
from estdepth_tpu_torch.data.eval_stream import StreamEvalDataset
from estdepth_tpu_torch.data.eval_windows import WindowEvalDataset
from estdepth_tpu_torch.data.pipeline import TrainLoader
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, intrinsics, pose, render, synthetic_stream,
    synthetic_window, write_scannet_scene, write_scannet_train_scene,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.layers import convert_sync_batchnorm
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.models.resnet import ResNetEncoder
from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import (
    build, epipolar_attention, plane_mix, plane_warp,
    plane_warp_exact_z, two_pass,
)
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field
from estdepth_tpu_torch.parallel import mesh as parallel_mesh
from estdepth_tpu_torch.parallel.mesh import (
    create_mesh, init_distributed, shutdown,
)
from estdepth_tpu_torch.parallel.spatial import (
    WidthShards, make_spatial_window_fn, shard_bounds,
)
from estdepth_tpu_torch.tools import (
    eval_estm, eval_joint, export_serving, export_torch, kernel_report,
    rehearse_release_ckpt, score_offline,
)
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.tools.eval_estm import run_synthetic
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train import trainer
from estdepth_tpu_torch.train.trainer import (
    TrainState, make_optimizer, make_train_step,
)
from estdepth_tpu_torch.utils import viz
from estdepth_tpu_torch.utils.checkpoint import CheckpointManager
from estdepth_tpu_torch.utils.convert import load_reference_checkpoint

# Flagship shapes: 256x320 frames, cost volume 64x80, D = 64 planes, 32
# matching channels. ESTM step: 2 plane-sweep neighbours and 2 memory
# neighbours. Joint window: 3 targets, each attending over 3 neighbours
# (2 in-window, 1 memory) of 16 key + 16 value channels. Training window:
# 5 frames, 3 targets, 6 plane sweeps, each target fused over its 2
# in-window neighbours (no memory).
HEIGHT, WIDTH, NDEPTHS, CHANNELS = 256, 320, 64, 32
DEPTH_MIN, DEPTH_MAX = 0.01, 10.0
REL_TOL = 1e-5  # max |kernel - plain| / max |plain|
# Gradients: both sides scatter-add with float atomics, whose order changes
# from run to run, and the exact-z form carries factors up to D - 1 = 63;
# measured up to 5.3e-6 of the gradient's scale.
GRAD_TOL = 3e-5
LWINDOW, MEMORY, FRAMES = 3, 2, 8
SEQ_LENGTH, JOINT_WINDOWS, JOINT_NEIGHBOURS = 5, 5, 3
TRAIN_FRAMES, TRAIN_STEPS = 5, 4  # the first step warms up
# dataset path: ScanNet's 640x480 frames and focal; every second frame is
# sampled, and frame 10 has a non-finite pose (ESTM skips it, Joint the
# window that holds it)
SCENE, SCENE_FRAMES, SCENE_INTERVAL, NONFINITE_FRAME = (
    "scene0000_00", 40, 2, 10)
# training from recorded scenes: 200 pose ids, every 10th sampled (20
# frames, 5 windows of 5), the first JPEG cut inside its header
TRAIN_SCENE_IDS, TRAIN_SCENE_INTERVAL, TRAIN_DATASET_STEPS = 200, 10, 6
IMAGE_FREQ, TRAIN_WORKERS = 3, 4
# the float16 rounding of the saved maps, relative, between the ESTM tool's
# mean metrics and score_offline's on its dump
DUMP_REL_TOL = 2e-3
LAUNCHES = 20  # back-to-back calls per timed run of a kernel
# in the order of PERF.md's table of TPU kernels (rows 1 to 5)
KERNELS = {"plane_sweep_warp": plane_warp.KERNEL,
           "frustum_warp_exact_z": plane_warp_exact_z.KERNEL,
           "two_pass_resample": two_pass.KERNEL,
           "frustum_warp_plane_mix": plane_mix.KERNEL,
           "epipolar_attention": epipolar_attention.KERNEL}
# each kernel's torch.library op (ops/cuda/library.py)
OPS = {"plane_sweep_warp": "estdepth::plane_sweep_sample",
       "frustum_warp_exact_z": "estdepth::exact_z_resample",
       "two_pass_resample": "estdepth::two_pass_resample",
       "frustum_warp_plane_mix": "estdepth::plane_mix_resample",
       "epipolar_attention": "estdepth::epipolar_attention"}
WINDOW_SWEEPS = ([0, 2, 1, 3, 2, 4], [1, 1, 2, 2, 3, 3])  # (src, ref) frames
# serving artifacts: the maps the eval tools score (refined, fused head);
# frames (Joint: windows) of the export tool's oracle check
SERVING_SCALES, VERIFY_FRAMES, VERIFY_WINDOWS = (0, 2), 8, 2
RELEASE_VERIFY_FRAMES = 4
# data-parallel training (phase_train_ddp): steps per run, and each rank
# process's time limit in seconds (case (b))
DDP_STEPS, DDP_RANK_TIMEOUT = 3, 400
# the width-sharded forward (phase_spatial_shard): ranks on the one card,
# the ESTM stream's frames (4 windows of 3), each rank process's time
# limit in seconds, and the gathered maps' tolerance against one device
SPATIAL_RANKS, SPATIAL_FRAMES, SPATIAL_RANK_TIMEOUT = 2, 6, 300
SPATIAL_TOL = 1e-3
# (memory bytes/s, float32 FLOP/s) of the H100 SXM data sheet
PEAK = {"bytes": 3.35e12, "f32": 67e12}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.cache
def _sleep_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 10**7 / start.elapsed_time(end)


def _hold_device(ms: float) -> None:
    """Keep the device busy for about `ms` (torch.cuda._sleep spins a
    kernel), so that the host has queued what follows before it runs."""
    torch.cuda._sleep(int(ms * _sleep_cycles_per_ms()))


def _host_ms(fn, launches: int) -> float:
    """Host ms per call that fn() takes to queue its work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / launches
    torch.cuda.synchronize()
    return host


def _batch(fn, launches: int, host_ms: float) -> float:
    """Device ms per call of `launches` back-to-back calls of fn() between
    one CUDA event pair, queued while the device is held busy: the pair's
    own microseconds are spread over the run and no call waits for the
    host, so a call of ~0.04 ms is told apart from its neighbours."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _hold_device(2 * launches * host_ms + 0.5)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def batch_ms(fn, launches: int = LAUNCHES, reps: int = 5) -> float:
    """Median over `reps` runs of the device ms per call of fn()."""
    host = _host_ms(fn, launches)
    return statistics.median(_batch(fn, launches, host) for _ in range(reps))


def turns_ms(*fns, launches: int = LAUNCHES, rounds: int = 5) -> tuple:
    """Device ms per call of each of fns, timed in turns in runs of
    `launches` calls (the functions in order and then in reverse in every
    round: kernel, library, library, kernel for two) so that all see the
    same clocks: the medians of each."""
    host = [_host_ms(fn, launches) for fn in fns]
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            times[i].append(_batch(fns[i], launches, host[i]))
    return tuple(statistics.median(t) for t in times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK["bytes"] * 1e3
    t_ops = flops / PEAK["f32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    set_fp32_numerics()
    smi = nvidia_smi()
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return {"nvidia_smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build_all()
    log("build", sources=build.sources(), built=built,
        seconds=round(time.perf_counter() - t0, 3))


def _scene_geometry(dev):
    """Poses of frames 0..4 of the synthetic scene and K at 1/4 res."""
    cfg = SyntheticSceneConfig(height=HEIGHT, width=WIDTH)
    poses = torch.from_numpy(np.stack([pose(cfg, f) for f in range(5)]))
    k4 = geometry.scale_intrinsics(
        torch.from_numpy(intrinsics(cfg))[None], 0.25)
    dv = torch.linspace(DEPTH_MIN, DEPTH_MAX, NDEPTHS)[None]
    return poses.to(dev), k4.to(dev), dv.to(dev)


def _compare(name: str, kernel_out, plain_out) -> dict:
    err = (kernel_out - plain_out).abs().max().item()
    scale = plain_out.abs().max().item()
    rel = err / scale
    if not rel < REL_TOL:
        raise AssertionError(f"{name}: kernel vs plain max rel err {rel}")
    return {"max_abs_err": err, "max_rel_err": rel}


def _timed_with(m: dict, fns: list, library, yardstick) -> None:
    """Time fns (the kernel first) in turns with `library()` and the
    yardstick's call where given: m["ms"] (and "f32_ms_same_run" for a
    second fn), m["library_ms"] (None without one) and m["yardstick"]."""
    extra = [f for f in (library, yardstick and yardstick[1]) if f]
    times = list(turns_ms(*fns, *extra) if len(fns) + len(extra) > 1
                 else [batch_ms(fns[0])])
    m["ms"] = times.pop(0)
    if len(fns) > 1:
        m["f32_ms_same_run"] = times.pop(0)
    m["library_ms"] = times.pop(0) if library else None
    if yardstick:
        m["yardstick"] = {"call": yardstick[0], "ms": times.pop(0)}


def _measure(name: str, kern, plain, moved: int, flops: float,
             library=None, exact: bool = False, yardstick=None) -> dict:
    """kern() against plain() under REL_TOL (with `exact`, bit for bit),
    both timed, kern() in turns with `library()` and the yardstick
    (label, call) where given, and the bound of `moved` bytes and `flops`
    float32 operations with the rate and the share of it that the kernel
    reached."""
    out_k, out_p = kern(), plain()
    m = {"shape": list(out_k.shape), **_compare(name, out_k, out_p)}
    if exact:
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version at {m['shape']}")
        m["bit_equal"] = True
    del out_k, out_p
    _timed_with(m, [kern], library, yardstick)
    m["plain_ms"] = batch_ms(plain, reps=3)
    m["bound_ms"], m["bound_by"] = bound_ms(moved, flops)
    m["tb_per_s"] = moved / m["ms"] * 1e3 / 1e12
    m["bound_share"] = m["bound_ms"] / m["ms"]
    return m


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _bf16_entry(name: str, kern, plain, f32_kern, moved: int,
                flops: float, library=None, yardstick=None) -> dict:
    """A kernel's bf16 instance at the shapes of its row: kern() (bf16
    inputs) against plain() (the plain bf16 version: upcast, the float32
    plain version, one rounding), bit for bit for kernels 1 to 4 and
    within one bf16 ulp of the output's scale for the attention kernel,
    whose float32 sums run in another order; timed in turns with the
    float32 instance f32_kern() on the float32 inputs of the row and,
    where one is given, the PyTorch call library() on the bf16 inputs
    (bf16, f32, library, library, f32, bf16 in every round), and the
    bound of its `moved` bytes (the volume's halve, the float32
    coordinates' do not); the yardstick (label, call on the bf16 inputs)
    in the same turns where given."""
    out_k, out_p = kern(), plain()
    if not out_k.dtype == out_p.dtype == torch.bfloat16:
        raise AssertionError(f"{name} bf16: {out_k.dtype}, {out_p.dtype}")
    err = (out_k.float() - out_p.float()).abs().max().item()
    m = {"shape": list(out_k.shape), "max_abs_err": err,
         "max_rel_err": err / out_p.float().abs().max().item()}
    if name == "epipolar_attention":
        # the two float32 sums differ in their last bits, and where a
        # value cancels to near zero that is more than its own ulp: held
        # to one bf16 ulp at the output's scale
        ulp = _bf16_ulp(out_p.float().abs().max().item())
        m["max_err_in_ulps_of_scale"] = err / ulp
        if not err <= ulp:
            raise AssertionError(f"{name} bf16: {err} from its plain "
                                 f"version, more than one ulp ({ulp})")
    else:
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{name} bf16: kernel differs from its "
                                 f"plain version at {m['shape']}")
        m["bit_equal"] = True
    del out_k, out_p
    _timed_with(m, [kern, f32_kern], library, yardstick)
    m["plain_ms"] = batch_ms(plain, reps=3)
    m["bound_ms"], m["bound_by"] = bound_ms(moved, flops)
    m["tb_per_s"] = moved / m["ms"] * 1e3 / 1e12
    m["bound_share"] = m["bound_ms"] / m["ms"]
    return m


def _plane_sweep_case(gen, poses, k4, dv, src_frames, ref_frames) -> dict:
    """Kernel 1 on one random feature map per entry of src_frames, swept
    into the frustum of the matching entry of ref_frames."""
    dev = poses.device
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    b = len(src_frames)
    src = torch.randn(b, h, w, c, generator=gen).to(dev)
    proj = geometry.camera_projection(k4.expand(len(poses), 3, 3), poses)
    x, y = warp.plane_sweep_coords(proj[src_frames], proj[ref_frames],
                                   dv.expand(b, d), h, w)
    out_numel, voxels = b * d * h * w * c, b * d * h * w
    flops = out_numel * 9 + voxels * 20
    m = _measure(
        "plane_sweep_warp",
        lambda: plane_warp.plane_sweep_sample(src, x, y),
        lambda: plane_warp.plane_sweep_sample_plain(src, x, y),
        nbytes(src, x, y) + 4 * out_numel, flops,
        library=_grid_sample(src, x, y), exact=True)
    src16 = src.bfloat16()
    m["bf16"] = _bf16_entry(
        "plane_sweep_warp",
        lambda: plane_warp.plane_sweep_sample(src16, x, y),
        lambda: plane_warp.plane_sweep_sample_plain(src16, x, y),
        lambda: plane_warp.plane_sweep_sample(src, x, y),
        nbytes(src16, x, y) + 2 * out_numel, flops,
        library=_grid_sample(src16, x, y))
    return m


def _grid_sample(src, x, y):
    """One F.grid_sample call over the same coordinates (a softer edge
    rule than the port's hard mask): timed here, used nowhere. The grid
    takes src's dtype, as grid_sample requires."""
    b, h, w, _ = src.shape
    nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], -1)
    grid = grid.reshape(b, -1, w, 2).to(src.dtype)
    return lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def _two_pass_inputs(gen, poses, k4, dv, src_frames, ref_frames):
    """One random feature map per entry of src_frames with the line
    coefficients and exact coordinates of its sweep into ref_frames."""
    dev = poses.device
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    b = len(src_frames)
    src = torch.randn(b, h, w, c, generator=gen).to(dev)
    proj = geometry.camera_projection(k4.expand(len(poses), 3, 3), poses)
    rot, trans = geometry.relative_projection(proj[src_frames],
                                              proj[ref_frames])
    ab = warp.plane_sweep_line_coeffs(rot, trans, dv.expand(b, d), w)
    x, y = warp.plane_sweep_coords(proj[src_frames], proj[ref_frames],
                                   dv.expand(b, d), h, w)
    return src, ab, x.reshape(b * d, h * w), y.reshape(b * d, h * w)


def _two_pass_case(gen, poses, k4, dv, src_frames, ref_frames,
                   planes_per_map: int = NDEPTHS) -> dict:
    """Kernel 3 on the plane sweep of src_frames into ref_frames. With
    planes_per_map = 1 every plane reads a map of its own (the frustum
    modes' second stage), at the same coordinates."""
    src, ab, x, y = _two_pass_inputs(gen, poses, k4, dv, src_frames,
                                     ref_frames)
    b, h, w, c = src.shape
    if planes_per_map == 1:
        src = torch.randn(ab.shape[0], h, w, c, generator=gen).to(src.device)
    out_numel = ab.shape[0] * h * w * c
    # grid_sample computes the exact sample, not the two-pass function: a
    # yardstick of the same memory work
    library = (_grid_sample(src, x.reshape(b, -1), y.reshape(b, -1))
               if planes_per_map > 1 else None)
    flops = out_numel * 9 + out_numel // c * 24
    m = _measure(
        "two_pass_resample",
        lambda: two_pass.two_pass_resample(src, ab, x, y, planes_per_map),
        lambda: two_pass.two_pass_resample_plain(src, ab, x, y,
                                                 planes_per_map),
        nbytes(src, ab, x, y) + 4 * out_numel, flops, library=library,
        exact=True)
    src16 = src.bfloat16()
    m["bf16"] = _bf16_entry(
        "two_pass_resample",
        lambda: two_pass.two_pass_resample(src16, ab, x, y, planes_per_map),
        lambda: two_pass.two_pass_resample_plain(src16, ab, x, y,
                                                 planes_per_map),
        lambda: two_pass.two_pass_resample(src, ab, x, y, planes_per_map),
        nbytes(src16, ab, x, y) + 2 * out_numel, flops,
        library=(_grid_sample(src16, x.reshape(b, -1), y.reshape(b, -1))
                 if planes_per_map > 1 else None))
    m["planes_per_map"] = planes_per_map
    if planes_per_map > 1:
        # how far the two-pass form is from the exact bilinear sample
        # (kernel 1) on this scene; no limit, a property of the function
        exact = plane_warp.plane_sweep_sample(src, x.reshape(b, -1),
                                              y.reshape(b, -1))
        got = two_pass.two_pass_resample(src, ab, x, y, planes_per_map)
        m["max_abs_dev_from_exact_sample"] = (
            got.reshape(exact.shape) - exact).abs().max().item()
    return m


# The 5-D yardstick of kernels 2 and 4 (timed, used nowhere in the port)
YARDSTICK_5D = ("F.grid_sample 5-D, trilinear, align_corners=True, on the "
                "same volume at (x, y, z*): another function (zeros padding "
                "fades each corner, one z for all four), a yardstick of the "
                "same 8-tap memory work")
# a pose that rolls 0.5 rad about the optical axis and moves 1.0 forward:
# the images of a tile's rows are slanted and magnified, and more voxels
# leave the image
ROLL_RAD, ROLL_FORWARD = 0.5, 1.0


def _rolled(rel: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, device=rel.device)
    m[0, 0] = m[1, 1] = float(np.cos(ROLL_RAD))
    m[0, 1], m[1, 0] = -float(np.sin(ROLL_RAD)), float(np.sin(ROLL_RAD))
    m[2, 3] = ROLL_FORWARD
    return torch.matmul(m, rel)


def _grid_sample_3d(vol, x, y, z, dint):
    """One F.grid_sample call on the volume [B, D, H, W, C] at (x, y, z*)
    with z* = (z - DEPTH_MIN) / dint, in the volume's dtype."""
    b, d, h, w, _ = vol.shape
    ncdhw = vol.permute(0, 4, 1, 2, 3).contiguous()
    zs = (z - DEPTH_MIN) / dint
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1,
                        zs / (d - 1) * 2 - 1], -1)
    grid = grid.reshape(b, d, h, w, 3).to(vol.dtype)
    return lambda: F.grid_sample(ncdhw, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def _frustum_inputs(gen, poses, k4, dv, neighbour_frames, target_frame,
                    rolled: bool = False):
    """A random volume per neighbour frame and the coordinates and zi
    field of its warp into target_frame's frustum."""
    dev = poses.device
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    dint = (DEPTH_MAX - DEPTH_MIN) / (NDEPTHS - 1)
    b = len(neighbour_frames)
    vol = torch.randn(b, d, h, w, c, generator=gen).to(dev)
    rel = torch.matmul(poses[neighbour_frames],
                       torch.linalg.inv(poses[[target_frame] * b]))
    if rolled:
        rel = _rolled(rel)
    t, grid_px, x, y, z = warp.frustum_coords(rel, k4.expand(b, 3, 3),
                                             dv.expand(b, d), h, w)
    zi = zi_field(t, k4.expand(b, 3, 3), dv.expand(b, d), DEPTH_MIN, dint,
                  grid_px)
    return vol, zi, x, y, z, dint


def _frustum_kernel(name: str, zi, x, y, z, dint):
    """(kernel wrapper, plain version) of kernel 2 or 4 on these inputs;
    both take the volume."""
    if name == "frustum_warp_exact_z":
        return (lambda v: plane_warp_exact_z.exact_z_resample(
                    v, zi, x, y, z, DEPTH_MIN, dint),
                lambda v: resample_exact_z(v, zi, x, y, z, DEPTH_MIN, dint))
    return (lambda v: plane_mix.plane_mix_resample(v, zi, x, y),
            lambda v: plane_mix.plane_mix_resample_plain(v, zi, x, y))


def _valid_share(out: torch.Tensor) -> float:
    """Share of the voxels of `out` [..., C] with a non-zero channel."""
    return (out.abs().amax(-1) > 0).float().mean().item()


def _frustum_case(name: str, gen, poses, k4, dv, neighbour_frames,
                  target_frame, flops_per_value: int,
                  flops_per_voxel: int) -> tuple[dict, tuple]:
    """Kernel 2 or 4 on one random volume per neighbour frame warped into
    target_frame's frustum, in float32 and bf16: bit for bit against the
    plain version, timed in turns with the 5-D yardstick, and the same
    bit-for-bit check at the rolled pose. Returns the entry
    and the outputs of both instances."""
    vol, zi, x, y, z, dint = _frustum_inputs(gen, poses, k4, dv,
                                             neighbour_frames, target_frame)
    kern, plain = _frustum_kernel(name, zi, x, y, z, dint)
    moved = nbytes(vol, zi, x, y) + nbytes(vol)
    if name == "frustum_warp_exact_z":
        moved += nbytes(z)
    flops = vol.numel() * flops_per_value + vol.numel() // CHANNELS * (
        flops_per_voxel)
    m = _measure(name, lambda: kern(vol), lambda: plain(vol), moved, flops,
                 exact=True,
                 yardstick=(YARDSTICK_5D,
                            _grid_sample_3d(vol, x, y, z, dint)))
    m["valid_share"] = _valid_share(plain(vol))
    vol16 = vol.bfloat16()
    m["bf16"] = _bf16_entry(
        name, lambda: kern(vol16), lambda: plain(vol16), lambda: kern(vol),
        moved - nbytes(vol16) * 2, flops,
        yardstick=(YARDSTICK_5D, _grid_sample_3d(vol16, x, y, z, dint)))
    outs = kern(vol), kern(vol16)
    del vol16
    # the rolled pose
    vol, zi, x, y, z, dint = _frustum_inputs(
        gen, poses, k4, dv, neighbour_frames, target_frame, rolled=True)
    kern, plain = _frustum_kernel(name, zi, x, y, z, dint)
    rolled = {"roll_rad": ROLL_RAD, "forward": ROLL_FORWARD}
    for key, v in (("f32", vol), ("bf16", vol.bfloat16())):
        out_p = plain(v)
        if not torch.equal(kern(v), out_p):
            raise AssertionError(f"{name} {key}: kernel differs from its "
                                 f"plain version at the rolled pose")
        rolled[key] = {"bit_equal": True, "valid_share": _valid_share(out_p)}
    m["rolled"] = rolled
    return m, outs


def _kernel_reports(names: list[str]) -> dict:
    """tools/kernel_report's rows of csrc/<name>.cu for each name (one
    nvcc each, all at once)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_report_") as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            rows = pool.map(
                lambda n: kernel_report.report(n, Path(tmp)), names)
            return dict(zip(names, rows))


def _instance_report(rows: list[dict], vol: torch.Tensor) -> dict:
    """Registers, spills and shared memory of the instance that runs on
    `vol` (its element type and vectors per voxel, 32-bit offsets)."""
    c = vol.shape[-1]
    elem = "float" if vol.dtype == torch.float32 else "__nv_bfloat16"
    cv = c * vol.dtype.itemsize // build.VECTOR_BYTES
    row = next(r for r in rows if f"<{elem}," in r["kernel"]
               and f", {cv}, int>(" in r["kernel"])
    return {"kernel": row["kernel"], "registers": row["registers"],
            "spill_bytes": row.get("spill_bytes", 0),
            "smem_bytes": row.get("smem_bytes", 0),
            "instructions": row.get("instructions")}


def phase_kernels() -> list[dict]:
    """Each kernel against its plain version at the flagship shapes of
    every main path that launches it. Kernels 1 and 2 run on both paths:
    their row's own numbers are taken at the ESTM step's shapes and its
    "joint" entry at the Joint window's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    poses, k4, dv = _scene_geometry(dev)
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    dint = (DEPTH_MAX - DEPTH_MIN) / (NDEPTHS - 1)
    rows = []

    # kernel 1. ESTM: target frame 1 swept against neighbours 0 and 2.
    # Joint: targets 1, 2, 3 of a 5-frame window, each against the frames
    # before and after it (B = 6).
    rows.append({
        "name": "plane_sweep_warp", "route": "cuda",
        "source": "estdepth_tpu_torch/csrc/plane_sweep_warp.cu",
        "replaces": "estdepth_tpu/ops/pallas/plane_warp.py:588",
        **_plane_sweep_case(gen, poses, k4, dv, [0, 2], [1, 1]),
        "joint": _plane_sweep_case(gen, poses, k4, dv, *WINDOW_SWEEPS)})

    # kernel 2. ESTM: target frame 2 against memory frames 1 and 0.
    # Joint: target frame 1 against in-window targets 0 and 2 and the
    # memory frame 3 (B = 3), the poses of kernel 4's row.
    estm, _ = _frustum_case("frustum_warp_exact_z", gen, poses, k4, dv,
                            [1, 0], 2, 32, 30)
    joint, _ = _frustum_case("frustum_warp_exact_z", gen, poses, k4, dv,
                             [0, 2, 3], 1, 32, 30)
    rows.append({
        "name": "frustum_warp_exact_z", "route": "cuda",
        "source": "estdepth_tpu_torch/csrc/frustum_warp_exact_z.cu",
        "replaces": "estdepth_tpu/ops/pallas/plane_warp_exact_z.py:281",
        **estm, "joint": joint})

    # kernel 3. Its row's own numbers at the training window's plane sweep
    # (6 maps, 64 planes each), "estm" at the ESTM step's (2 maps), and
    # once with a map per plane.
    rows.append({
        "name": "two_pass_resample", "route": "cuda",
        "source": "estdepth_tpu_torch/csrc/two_pass_resample.cu",
        "replaces": "estdepth_tpu/ops/pallas/plane_warp.py:305",
        **_two_pass_case(gen, poses, k4, dv, *WINDOW_SWEEPS),
        "estm": _two_pass_case(gen, poses, k4, dv, [0, 2], [1, 1]),
        "map_per_plane": _two_pass_case(gen, poses, k4, dv, [0], [1], 1)})

    # kernel 4, Joint window: target frame 1 against in-window targets 0
    # and 2 and the memory frame 3, keys and values concatenated
    n = JOINT_NEIGHBOURS
    row, (warped, warped16) = _frustum_case(
        "frustum_warp_plane_mix", gen, poses, k4, dv, [0, 2, 3], 1, 21, 40)
    rows.append({"name": "frustum_warp_plane_mix", "route": "cuda",
                 "source": "estdepth_tpu_torch/csrc/frustum_warp_plane_mix.cu",
                 "replaces": "estdepth_tpu/ops/pallas/plane_warp.py:533",
                 **row})
    # registers, spills and shared memory of the instances above
    reports = _kernel_reports(["frustum_warp_exact_z",
                               "frustum_warp_plane_mix"])
    for r in (r for r in rows if r["name"] in reports):
        for entry, vol_dtype in ((r, torch.float32),
                                 (r["bf16"], torch.bfloat16)):
            vol = torch.empty(1, d, h, w, c, dtype=vol_dtype, device="meta")
            entry["report"] = _instance_report(reports[r["name"]], vol)

    # kernel 5, Joint window: the target's key against the K and V halves
    # of the volume kernel 4 just wrote, read in place as the fusion does
    ck = c // 2
    tk = torch.randn(1, d, h, w, ck, generator=gen).to(dev)
    view = warped.reshape(1, n, d, h, w, c).transpose(0, 1)
    wk, wv = view[..., :ck], view[..., ck:]
    valid = torch.ones(n, 1, dtype=torch.bool, device=dev)

    def kern():
        return epipolar_attention.epipolar_attention(tk, wk, wv, valid)

    def plain():
        return epipolar_attention.epipolar_attention_plain(tk, wk, wv, valid)

    out_k, out_p = kern(), plain()
    row = {"name": "epipolar_attention", "route": "cuda",
           "source": "estdepth_tpu_torch/csrc/epipolar_attention.cu",
           "replaces": "estdepth_tpu/ops/pallas/epipolar_attention.py:100",
           **_compare("epipolar_attention", out_k, out_p)}
    # the tolerance the JAX package holds its TPU kernel to
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-6)
    row["plain_ms"] = batch_ms(plain, reps=3)
    # one library call for the same function with every neighbour valid:
    # attention of 1 query over N keys per voxel, then the mean's 1 / N
    voxels = d * h * w
    # (voxels as 8 batches of heads: both stay under the 65535 grid limit)
    q = tk.reshape(8, voxels // 8, 1, ck)
    k_lib, v_lib = (m.permute(1, 2, 3, 4, 0, 5).reshape(8, voxels // 8, n, ck)
                    for m in (wk, wv))

    def library():
        return F.scaled_dot_product_attention(q, k_lib, v_lib, scale=1.0) / n

    lib_err = (library().reshape(out_p.shape) - out_p).abs().max().item()
    if not lib_err < 1e-4:
        raise AssertionError(f"library attention differs by {lib_err}")
    row["ms"], row["library_ms"] = turns_ms(kern, library)
    flops = voxels * (n * 64 + n * 20)
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(tk, out_k) + 2 * n * nbytes(tk), flops)
    # bf16: the target key and the K and V halves of kernel 4's bf16
    # volume, read in place
    tk16 = tk.bfloat16()
    view16 = warped16.reshape(1, n, d, h, w, c).transpose(0, 1)
    wk16, wv16 = view16[..., :ck], view16[..., ck:]
    q16 = tk16.reshape(q.shape)
    k16_lib, v16_lib = (
        m.permute(1, 2, 3, 4, 0, 5).reshape(8, voxels // 8, n, ck)
        for m in (wk16, wv16))

    def library16():
        return F.scaled_dot_product_attention(q16, k16_lib, v16_lib,
                                              scale=1.0) / n

    # the same function in bf16, rounded at other places than the plain
    # version: held to a few ulps of the output's scale, the measure of
    # the kernel's own check
    plain16 = epipolar_attention.epipolar_attention_plain(tk16, wk16, wv16,
                                                          valid).float()
    lib16_err = (library16().reshape(plain16.shape).float()
                 - plain16).abs().max().item()
    lib16_ulps = lib16_err / _bf16_ulp(plain16.abs().max().item())
    if not lib16_ulps <= 4:
        raise AssertionError(f"bf16 library attention differs by "
                             f"{lib16_ulps} ulps of the output's scale")
    del plain16
    row["bf16"] = _bf16_entry(
        "epipolar_attention",
        lambda: epipolar_attention.epipolar_attention(tk16, wk16, wv16,
                                                      valid),
        lambda: epipolar_attention.epipolar_attention_plain(tk16, wk16,
                                                            wv16, valid),
        kern, nbytes(tk16) * (2 + 2 * n), flops, library=library16)
    row["bf16"]["library_err_in_ulps_of_scale"] = lib16_ulps
    rows.append(row)
    for r in rows:
        log("kernel", **r)
    return rows


def phase_geometry(dev=torch.device("cuda")) -> None:
    """Plane-sweep frames 0 and 4 of the synthetic scene (textured slanted
    plane at ~2.5 m, ~0.33 m baseline: ~2 px of shift per plane at D = 64)
    at full resolution through kernel 1; the argmin over planes of the
    5x5 box-filtered |ref - warped| must recover the analytic depth's plane
    index within +-1 on >= 80% of the pixels seen in both views."""
    cfg = SyntheticSceneConfig(height=HEIGHT, width=WIDTH)
    rgb0, depth0 = render(cfg, pose(cfg, 0))
    rgb4, _ = render(cfg, pose(cfg, 4))

    def rgbx(rgb):  # pad to 4 channels: the kernel takes C % 4 == 0
        return torch.from_numpy(np.pad(rgb, ((0, 0), (0, 0), (0, 1))))

    ref, src = rgbx(rgb0).to(dev), rgbx(rgb4)[None].to(dev)
    k = torch.from_numpy(intrinsics(cfg))[None].to(dev)
    proj_ref = geometry.camera_projection(
        k, torch.from_numpy(pose(cfg, 0))[None].to(dev))
    proj_src = geometry.camera_projection(
        k, torch.from_numpy(pose(cfg, 4))[None].to(dev))
    dv = torch.linspace(DEPTH_MIN, DEPTH_MAX, NDEPTHS, device=dev)[None]
    x, y = warp.plane_sweep_coords(proj_src, proj_ref, dv, HEIGHT, WIDTH)
    warped = plane_warp.plane_sweep_sample(src, x, y)  # [1, D, H, W, 4]
    cost = (warped[0] - ref).abs().sum(-1)  # [D, H, W]
    cost = F.avg_pool2d(cost[None], 5, stride=1, padding=2)[0]
    est = cost.argmin(0).cpu().numpy()
    dint = (DEPTH_MAX - DEPTH_MIN) / (NDEPTHS - 1)
    gt = np.clip(np.rint((depth0 - DEPTH_MIN) / dint), 0, NDEPTHS - 1)
    gt = gt.astype(np.int64)
    xs = x.reshape(NDEPTHS, HEIGHT, WIDTH).cpu().numpy()
    ys = y.reshape(NDEPTHS, HEIGHT, WIDTH).cpu().numpy()
    xg = np.take_along_axis(xs, gt[None], 0)[0]
    yg = np.take_along_axis(ys, gt[None], 0)[0]
    seen = ((xg >= 0) & (xg <= WIDTH - 1) & (yg >= 0) & (yg <= HEIGHT - 1)
            & (depth0 > DEPTH_MIN))
    hit = float(np.mean(np.abs(est - gt)[seen] <= 1))
    log("geometry", seen_share=float(seen.mean()), within_one_plane=hit,
        gt_planes=[int(gt[seen].min()), int(gt[seen].max())])
    if not hit >= 0.8:
        raise AssertionError(f"plane-sweep depth recovery {hit} < 0.8")


def _pitched_frames(n: int, full_width: bool = False):
    """Small synthetic stream (or, `full_width`, the flagship's 256x320
    scene) with a seeded pitch and lift on the camera path, so that no
    warp coordinate sits exactly on the image border, where float noise
    would decide the hard out-of-range mask."""
    if full_width:
        frames = list(synthetic_stream(SyntheticSceneConfig(), n, DEPTH_MIN,
                                       DEPTH_MAX))
    else:
        cfg = SyntheticSceneConfig(height=64, width=96, focal=80.0)
        frames = list(synthetic_stream(cfg, n, 0.5, 8.0))
    for i, f in enumerate(frames):
        a = 0.013 * i + 0.002
        rx = np.eye(4, dtype=np.float32)
        rx[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        f["cam_pose"] = (f["cam_pose"] @ rx).astype(np.float32)
        f["cam_pose"][1, 3] += 0.011 * i
    return frames


def _stream(model, frames, dev) -> list:
    """An ESTMRunner (lwindow 3, memory 2) over frames: the 4 depth scales
    of each output on the host."""
    runner = ESTMRunner(model, 64, 96, device=dev)
    return [out.cpu() for f in frames if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]


def _joint_chain(model, frames, dev, windows: int) -> list:
    """A JointRunner over `windows` windows of frames: each window's
    depth [1, 3, 4, H, W] on the host."""
    stride = SEQ_LENGTH - 2
    imgs = np.stack([f["img"] for f in frames])[None]
    poses = np.stack([f["cam_pose"] for f in frames])[None]
    runner = eval_joint.JointRunner(model, device=dev)
    return [runner.run_window(
        imgs[:, wi * stride:wi * stride + SEQ_LENGTH],
        poses[:, wi * stride:wi * stride + SEQ_LENGTH],
        frames[0]["cam_intr"][None])[0].cpu() for wi in range(windows)]


def _max_err(a: list, b: list) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def phase_reference() -> None:
    """A small ESTM stream (ndepths 8, 64x96, ResNet-18, 5 windows) through
    the kernels on the card against the plain PyTorch path on the CPU,
    same weights: all 4 depth scales within the chain tolerance 8e-3."""
    frames = _pitched_frames(7)
    cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18)
    outs = {dev: _stream(DepthNetHybrid(cfg, seed=0), frames, dev)
            for dev in ("cpu", "cuda")}
    err = _max_err(outs["cpu"], outs["cuda"])
    log("reference", windows=len(outs["cuda"]), max_abs_err=err, atol=8e-3)
    if not (len(outs["cuda"]) == 5 and err < 8e-3):
        raise AssertionError(f"card vs CPU stream: max abs err {err}")


def phase_reference_bf16() -> None:
    """A small bf16 ESTM stream (ndepths 8, 64x96, ResNet-18, 5 windows)
    through the kernels' bf16 instances on the card against the same bf16
    model on the CPU, same weights: all 4 depth scales within twice the
    card's own bf16-against-float32 distance on the same frames (bf16
    rounds at other places in the two devices' convolutions)."""
    frames = _pitched_frames(7)
    outs = {}
    for dtype, dev in (("float32", "cuda"), ("bfloat16", "cuda"),
                       ("bfloat16", "cpu")):
        cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
                          compute_dtype=dtype)
        counts = _read_bf16_counts()
        runner = ESTMRunner(DepthNetHybrid(cfg, seed=0), 64, 96, device=dev)
        outs[dtype, dev] = [out.cpu() for f in frames if (
            out := runner.push_frame(f["img"], f["cam_pose"],
                                     f["cam_intr"])) is not None]
        if runner.memory.keys.dtype != torch_dtype(dtype):
            raise AssertionError(f"memory {runner.memory.keys.dtype}")
        launched = {k: n - counts[k] for k, n in _read_bf16_counts().items()}
        if dtype == "bfloat16" and dev == "cuda" and launched != {
                **dict.fromkeys(KERNELS, 0), "plane_sweep_warp": 5,
                "frustum_warp_exact_z": 4}:
            raise AssertionError(f"small bf16 stream launches {launched}")

    def dist(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    own = dist(outs["bfloat16", "cuda"], outs["float32", "cuda"])
    err = dist(outs["bfloat16", "cuda"], outs["bfloat16", "cpu"])
    log("reference_bf16", windows=len(outs["bfloat16", "cuda"]),
        max_abs_err=err, bf16_against_f32=own, ratio=err / own)
    if not (len(outs["bfloat16", "cuda"]) == 5 and err <= 2 * own):
        raise AssertionError(f"card vs CPU bf16 stream: max abs err {err} "
                             f"against the card's bf16-vs-f32 {own}")


def _reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = k.launches_bf16 = 0


def _read_counts() -> dict:
    """Launches of each kernel, both instances."""
    return {name: k.launches for name, k in KERNELS.items()}


def _read_bf16_counts() -> dict:
    """Launches of each kernel's bfloat16 instance."""
    return {name: k.launches_bf16 for name, k in KERNELS.items()}


def phase_reference_joint() -> None:
    """A small Joint chain (ndepths 8, 64x96, ResNet-18, seq_length 5, 3
    windows) on the card through the kernels against the plain PyTorch path
    on the CPU, same weights, once in the default mode (exact-z warp) and
    once with the plane-mix warp and the attention kernel: all 4 depth
    scales within the chain tolerance 8e-3."""
    windows, stride = 3, SEQ_LENGTH - 2
    frames = _pitched_frames((windows - 1) * stride + SEQ_LENGTH)
    fused = (windows - 1) * stride  # one warp per target of an EST window
    modes = {
        "plane_mix_exact_z": (dict(), {"frustum_warp_exact_z": fused}),
        "plane_mix": (dict(frustum_mode="plane_mix",
                           use_fused_attention=True),
                      {"frustum_warp_plane_mix": fused,
                       "epipolar_attention": fused}),
    }
    for mode, (options, expected) in modes.items():
        cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
                          **options)
        counts = _read_counts()
        outs = {dev: _joint_chain(DepthNetHybrid(cfg, seed=0), frames, dev,
                                  windows) for dev in ("cpu", "cuda")}
        launched = {name: n - counts[name]
                    for name, n in _read_counts().items()}
        err = _max_err(outs["cpu"], outs["cuda"])
        log("reference_joint", frustum_mode=mode, windows=windows,
            launches=launched, max_abs_err=err, atol=8e-3)
        if not (outs["cuda"][0].shape == (1, 3, 4, 64, 96) and err < 8e-3):
            raise AssertionError(f"card vs CPU Joint chain ({mode}): max abs "
                                 f"err {err}")
        if launched != {**dict.fromkeys(KERNELS, 0),
                        "plane_sweep_warp": windows, **expected}:
            raise AssertionError(f"small Joint chain ({mode}) launches "
                                 f"{launched}")


def _backward_ms(make_out, leaf, ct, reps: int = 5) -> float:
    """Median device time in ms of the backward alone: a fresh forward
    before each timed `autograd.grad`."""
    times = []
    for i in range(reps + 1):
        out = make_out()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, leaf, ct)
        end.record()
        end.synchronize()
        if i:  # the first call warms up
            times.append(start.elapsed_time(end))
        del out
    return statistics.median(times)


def _gradient_case(name, wrapper, plain, volume, coords, seed) -> dict:
    """The wrapper's volume gradient on the card (kernel forward, autograd
    of the plain version backward) against autograd of `plain` called
    directly, for one random cotangent from a seeded generator. The
    coordinates require grad too and must get none."""
    kernel = KERNELS[name]
    vol = volume.clone().requires_grad_()
    cs = [c.clone().requires_grad_() for c in coords]
    before = kernel.launches
    out = wrapper(vol, *cs)
    if kernel.launches != before + 1:
        raise AssertionError(f"{name}: the forward did not launch its kernel")
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)
                     ).to(out.device)
    out.backward(ct)
    if any(c.grad is not None for c in cs):
        raise AssertionError(f"{name}: a coordinate input got a gradient")
    got = vol.grad
    ref = volume.clone().requires_grad_()
    (want,) = torch.autograd.grad(plain(ref, *coords), ref, ct)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not (scale > 0 and err < GRAD_TOL * scale):
        raise AssertionError(f"{name}: gradient max abs err {err} at scale "
                             f"{scale}")
    del out, got, want
    leaf = volume.clone().requires_grad_()
    return {"name": name, "shape": list(volume.shape), "max_abs_err": err,
            "scale": scale, "backward_ms": _backward_ms(
                lambda: wrapper(leaf, *coords), leaf, ct)}


def phase_gradients(rows: list[dict]) -> None:
    """Kernels 1 to 4 under autograd at the training window's shapes: 6
    plane sweeps; 2 in-window neighbours warped into a target's frustum."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    poses, k4, dv = _scene_geometry(dev)
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    dint = (DEPTH_MAX - DEPTH_MIN) / (NDEPTHS - 1)
    src, ab, x, y = _two_pass_inputs(gen, poses, k4, dv, *WINDOW_SWEEPS)
    b = src.shape[0]

    def exact(s, _ab, xs, ys):  # the two-pass kernel's backward function
        return plane_warp.plane_sweep_sample_plain(
            s, xs.reshape(b, -1), ys.reshape(b, -1)).reshape(-1, h, w, c)

    cases = [_gradient_case(
        "plane_sweep_warp", plane_warp.plane_sweep_sample,
        plane_warp.plane_sweep_sample_plain, src,
        (x.reshape(b, -1), y.reshape(b, -1)), 0)]
    cases.append(_gradient_case(
        "two_pass_resample",
        lambda s, *cs: two_pass.two_pass_resample(s, *cs, NDEPTHS), exact,
        src, (ab, x, y), 1))
    del src, ab, x, y
    n = 2
    vol = torch.randn(n, d, h, w, c, generator=gen).to(dev)
    rel = torch.matmul(poses[[0, 2]], torch.linalg.inv(poses[[1, 1]]))
    t, grid_px, x, y, z = warp.frustum_coords(rel, k4.expand(n, 3, 3),
                                             dv.expand(n, d), h, w)
    zi = zi_field(t, k4.expand(n, 3, 3), dv.expand(n, d), DEPTH_MIN, dint,
                  grid_px)
    cases.append(_gradient_case(
        "frustum_warp_exact_z",
        lambda v, *cs: plane_warp_exact_z.exact_z_resample(
            v, *cs, DEPTH_MIN, dint),
        lambda v, *cs: resample_exact_z(v, *cs, DEPTH_MIN, dint), vol,
        (zi, x, y, z), 2))
    cases.append(_gradient_case(
        "frustum_warp_plane_mix", plane_mix.plane_mix_resample,
        plane_mix.plane_mix_resample_plain, vol, (zi, x, y), 3))
    by_name = {row["name"]: row for row in rows}
    for case in cases:
        log("gradient", **case)
        by_name[case["name"]]["backward_ms"] = case["backward_ms"]
        by_name[case["name"]]["grad_max_abs_err"] = case["max_abs_err"]
    by_name["epipolar_attention"]["backward_ms"] = None  # forward-only
    torch.cuda.empty_cache()


def phase_reference_train() -> None:
    """3 training steps at a small size (ndepths 8, 64x96, ResNet-18,
    4-frame windows: 2 targets, so the EST fusion warps) on the card
    through the kernels against the plain PyTorch path on the CPU, from
    the same seeded state and batches, once per plane-sweep route: the
    loss of each step at rtol 3e-3 and every BatchNorm running statistic
    at rtol 5e-3 (atol 5e-4), the PARITY.md trajectory tolerances."""
    frames = _pitched_frames(7)
    windows = [(0, 4), (2, 6), (3, 7)]

    def batch(lo, hi, dev):
        arrays = {
            "imgs": np.stack([f["img"] for f in frames[lo:hi]])[None],
            "cam_poses": np.stack([f["cam_pose"] for f in frames[lo:hi]])[
                None],
            "cam_intr": frames[0]["cam_intr"][None],
            "dmaps": np.stack([f["dmap"] for f in frames[lo + 1:hi - 1]])[
                None],
            "dmasks": np.stack([f["dmask"] for f in frames[lo + 1:hi - 1]])[
                None]}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in arrays.items()}

    for two_pass_warp in (False, True):
        cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
                          two_pass_warp=two_pass_warp)
        counts = _read_counts()
        losses, stats = {}, {}
        for dev in ("cpu", "cuda"):
            model = DepthNetHybrid(cfg, seed=0).to(dev)
            optimizer, scheduler = make_optimizer(
                model.named_parameters(),
                warmup_multistep_schedule(4e-5, steps_per_epoch=10**6))
            step = make_train_step(model, optimizer, scheduler, 0.5, 8.0)
            losses[dev] = [float(step(batch(lo, hi, dev), 10.0)["loss"])
                           for lo, hi in windows]
            stats[dev] = {k: v.cpu() for k, v in model.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}
        launched = {name: n - counts[name]
                    for name, n in _read_counts().items()}
        sweep = "two_pass_resample" if two_pass_warp else "plane_sweep_warp"
        # per step: one sweep; one frustum warp per target of the window
        if launched != {**dict.fromkeys(KERNELS, 0), sweep: len(windows),
                        "frustum_warp_exact_z": 2 * len(windows)}:
            raise AssertionError(f"small training steps launches {launched}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=3e-3)
        worst = 0.0
        for k, want in stats["cpu"].items():
            np.testing.assert_allclose(stats["cuda"][k].numpy(), want.numpy(),
                                       rtol=5e-3, atol=5e-4, err_msg=k)
            worst = max(worst, (stats["cuda"][k] - want).abs().max().item())
        log("reference_train", two_pass_warp=two_pass_warp,
            losses_cuda=losses["cuda"], losses_cpu=losses["cpu"],
            bn_stats=len(stats["cpu"]), bn_max_abs_err=worst,
            launches=launched)


def phase_main_path(rows: list[dict]) -> float:
    """The ESTM streaming step at the flagship width through the kernels:
    every kernel's count is set to 0 just before and read just after.
    Returns the steady-state ms per frame."""
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = run_synthetic(HEIGHT, WIDTH, NDEPTHS, DEPTH_MIN, DEPTH_MAX,
                        resnet=50, lwindow=LWINDOW, memory_size=MEMORY,
                        scenes=1, n_frames=FRAMES, seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = FRAMES - LWINDOW + 1
    maps = np.stack(res["maps"])
    if maps.shape != (steps, 2, HEIGHT, WIDTH):
        raise AssertionError(f"outputs {maps.shape}")
    if not (np.isfinite(maps).all() and maps.min() >= 0
            and maps.max() <= DEPTH_MAX):
        raise AssertionError("depths not finite or outside [0, depth_max]")
    # one plane-sweep launch per step; one frustum launch per EST step
    # (every step after the first window)
    if launches != {**dict.fromkeys(KERNELS, 0), "plane_sweep_warp": steps,
                    "frustum_warp_exact_z": steps - 1}:
        raise AssertionError(f"kernel launches {launches}")
    steady = res["times"][2:]
    ms = 1e3 * statistics.median(steady)
    log("main_path", frames=FRAMES, outputs=steps, launches=launches,
        ms_per_frame=ms, frames_per_s=1e3 / ms,
        times_ms=[1e3 * t for t in res["times"]],
        max_memory_allocated=peak, depth_range=[float(maps.min()),
                                                float(maps.max())])
    for row in rows:
        row["launches_by_path"] = {"estm": launches[row["name"]]}
    return ms


def phase_joint_path(rows: list[dict]) -> None:
    """The Joint window chain at the flagship width through
    tools.eval_joint.run_synthetic, 5 windows (17 frames): once with the
    default warp (exact-z) and once with the plane-mix warp and the
    attention kernel. Every kernel's count is set to 0 just before each
    run and read just after."""
    targets = SEQ_LENGTH - 2
    est_windows = JOINT_WINDOWS - 1  # the first window runs without EST
    # sequential fusion: one frustum warp (and attention call) per target
    fused = est_windows * targets
    runs = {
        "joint": (dict(), {"plane_sweep_warp": JOINT_WINDOWS,
                           "frustum_warp_exact_z": fused}),
        "joint_plane_mix_fused_attention": (
            dict(frustum_mode="plane_mix", fused_attention=True),
            {"plane_sweep_warp": JOINT_WINDOWS,
             "frustum_warp_plane_mix": fused, "epipolar_attention": fused}),
    }
    for path, (options, expected) in runs.items():
        expected = {**dict.fromkeys(KERNELS, 0), **expected}
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = eval_joint.run_synthetic(
            HEIGHT, WIDTH, NDEPTHS, DEPTH_MIN, DEPTH_MAX, resnet=50,
            seq_length=SEQ_LENGTH, windows=JOINT_WINDOWS, seed=0,
            device="cuda", **options)
        torch.cuda.synchronize()
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        maps = res["maps"]
        if maps.shape != (JOINT_WINDOWS, targets, 2, HEIGHT, WIDTH):
            raise AssertionError(f"{path}: outputs {maps.shape}")
        if not (np.isfinite(maps).all() and maps.min() >= 0
                and maps.max() <= DEPTH_MAX):
            raise AssertionError(f"{path}: depths not finite or outside "
                                 f"[0, depth_max]")
        if launches != expected:
            raise AssertionError(f"{path}: kernel launches {launches}, "
                                 f"expected {expected}")
        # steady state: the EST windows after the first, which also pays
        # for cuDNN's choice of algorithms at the fusion's shapes
        ms = 1e3 * statistics.median(res["times"][2:])
        log("joint_path", path=path, windows=JOINT_WINDOWS,
            targets_per_window=targets, launches=launches, ms_per_window=ms,
            targets_per_s=targets * 1e3 / ms,
            times_ms=[1e3 * t for t in res["times"]],
            max_memory_allocated=peak,
            depth_range=[float(maps.min()), float(maps.max())])
        for row in rows:
            row["launches_by_path"][path] = launches[row["name"]]


def _launched(path: str, dtype: str, expected: dict) -> tuple[dict, dict]:
    """The launches since the last reset against `expected` (every kernel
    not named there: 0); a bf16 run launches only bf16 instances and a
    float32 run none. Returns (launches, bf16 launches)."""
    torch.cuda.synchronize()
    launches, bf16 = _read_counts(), _read_bf16_counts()
    if launches != {**dict.fromkeys(KERNELS, 0), **expected}:
        raise AssertionError(f"{path} {dtype}: kernel launches {launches}, "
                             f"expected {expected}")
    want_bf16 = launches if dtype == "bfloat16" else dict.fromkeys(KERNELS,
                                                                   0)
    if bf16 != want_bf16:
        raise AssertionError(f"{path} {dtype}: bf16 instance launches "
                             f"{bf16} of {launches}")
    return launches, bf16


def _in_turns(path: str, rows: list[dict], run, expected: dict) -> dict:
    """run(dtype) -> (ms per step or frame, summary) for the bf16 model and
    the float32 one in turns (bf16, f32, f32, bf16), each between a reset
    and a check of the kernel counts: the median of each dtype's two ms,
    their ratio, and the first bf16 run's summary and launches, which the
    kernel rows record under `path`."""
    ms = {"bfloat16": [], "float32": []}
    summary = None
    for dtype in ("bfloat16", "float32", "float32", "bfloat16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t, info = run(dtype)
        launches, bf16 = _launched(path, dtype, expected)
        info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        ms[dtype].append(t)
        if dtype == "bfloat16" and summary is None:
            summary = {"launches": launches, **info}
            for row in rows:
                row["launches_by_path"][path] = launches[row["name"]]
                row["bf16"]["launches_by_path"][path] = bf16[row["name"]]
        elif dtype == "float32":
            summary.setdefault("f32", info)
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {"ms_bf16": med["bfloat16"], "ms_f32": med["float32"],
            "ratio_bf16_to_f32": med["bfloat16"] / med["float32"],
            "ms_runs": ms, **summary}


def _check_depths(path: str, maps: np.ndarray, shape: tuple) -> list:
    if maps.shape != shape:
        raise AssertionError(f"{path}: outputs {maps.shape}")
    if not (np.isfinite(maps).all() and maps.min() >= 0
            and maps.max() <= DEPTH_MAX):
        raise AssertionError(f"{path}: depths not finite or outside "
                             f"[0, depth_max]")
    return [float(maps.min()), float(maps.max())]


def phase_bf16_paths(rows: list[dict]) -> None:
    """The bf16 model (ModelConfig.compute_dtype="bfloat16", the tools'
    --bf16) at the flagship width (256x320, D = 64, ResNet-50, random
    weights from seed 0) through the kernels' bf16 instances, each path in
    turns with the float32 model in the same run (bf16, f32, f32, bf16):
    the ESTM stream (8 frames, ms per frame), the Joint chain with the
    default warp and with the plane-mix warp and the attention kernel (5
    windows, ms per window), 4 training steps of tools/train.py (ms per
    step, peak memory; once more in bf16 through the two-pass sweep,
    kernel 3), and a bf16 stream artifact exported on the card by
    `export_serving --bf16`, loaded back and streamed beside the live bf16
    runner. Every kernel's count is set to 0 just before each run and read
    just after; a bf16 run launches only bf16 instances."""
    for row in rows:
        row["bf16"]["launches_by_path"] = {}
    steps = FRAMES - LWINDOW + 1

    def estm(dtype):
        res = run_synthetic(HEIGHT, WIDTH, NDEPTHS, DEPTH_MIN, DEPTH_MAX,
                            resnet=50, lwindow=LWINDOW, memory_size=MEMORY,
                            scenes=1, n_frames=FRAMES, seed=0, device="cuda",
                            compute_dtype=dtype)
        maps = np.stack(res["maps"])
        return 1e3 * statistics.median(res["times"][2:]), {
            "times_ms": [1e3 * t for t in res["times"]],
            "depth_range": _check_depths("estm_bf16", maps,
                                         (steps, 2, HEIGHT, WIDTH)),
            "abs_rel": statistics.mean(e["abs_relative"]
                                       for e in res["errors"])}

    log("bf16_path", path="estm_bf16", **_in_turns(
        "estm_bf16", rows, estm, {"plane_sweep_warp": steps,
                                  "frustum_warp_exact_z": steps - 1}))

    targets = SEQ_LENGTH - 2
    fused = (JOINT_WINDOWS - 1) * targets
    for path, options, expected in (
            ("joint_bf16", {}, {"frustum_warp_exact_z": fused}),
            ("joint_plane_mix_fused_attention_bf16",
             dict(frustum_mode="plane_mix", fused_attention=True),
             {"frustum_warp_plane_mix": fused,
              "epipolar_attention": fused})):
        def joint(dtype, path=path, options=options):
            res = eval_joint.run_synthetic(
                HEIGHT, WIDTH, NDEPTHS, DEPTH_MIN, DEPTH_MAX, resnet=50,
                seq_length=SEQ_LENGTH, windows=JOINT_WINDOWS, seed=0,
                device="cuda", compute_dtype=dtype, **options)
            return 1e3 * statistics.median(res["times"][2:]), {
                "times_ms": [1e3 * t for t in res["times"]],
                "depth_range": _check_depths(
                    path, res["maps"],
                    (JOINT_WINDOWS, targets, 2, HEIGHT, WIDTH))}

        log("bf16_path", path=path, **_in_turns(
            path, rows, joint,
            {"plane_sweep_warp": JOINT_WINDOWS, **expected}))

    def train(dtype, flags=()):
        with tempfile.TemporaryDirectory() as logdir:
            args = train_tool.parse_args([
                "--synthetic", "--steps", str(TRAIN_STEPS), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--ndepths",
                str(NDEPTHS), "--depth-min", str(DEPTH_MIN), "--depth-max",
                str(DEPTH_MAX), "--resnet", "50", "--n-frames",
                str(TRAIN_FRAMES), "--batch-per-device", "1",
                "--summary-freq", "1", "--seed", "0", "--logdir", logdir,
                "--ckpt-steps", str(10 * TRAIN_STEPS), *flags,
                *(["--bf16"] if dtype == "bfloat16" else [])])
            res = train_tool.run(args)
        records = res["records"]
        state = res["state"]
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                   for r in records):
            raise AssertionError(f"train {dtype}: {records}")
        if not all(t.dtype == torch.float32
                   for t in (*state.model.parameters(),
                             *(v for st in state.optimizer.state.values()
                               for v in st.values()
                               if v.is_floating_point()))):
            raise AssertionError("bf16 training: a parameter or an Adam "
                                 "moment is not float32")
        return 1e3 * statistics.median(r["seconds"] for r in records[1:]), {
            "times_ms": [1e3 * r["seconds"] for r in records],
            "losses": [r["loss"] for r in records]}

    per_step = {"frustum_warp_exact_z": (TRAIN_FRAMES - 2) * TRAIN_STEPS}
    log("bf16_path", path="train_bf16", **_in_turns(
        "train_bf16", rows, train,
        {"plane_sweep_warp": TRAIN_STEPS, **per_step}))
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, info = train("bfloat16", ["--two-pass-warp"])
    launches, bf16 = _launched("train_two_pass_warp_bf16", "bfloat16", {
        "two_pass_resample": TRAIN_STEPS, **per_step})
    log("bf16_path", path="train_two_pass_warp_bf16", ms_bf16=ms,
        launches=launches,
        max_memory_allocated=torch.cuda.max_memory_allocated(), **info)
    for row in rows:
        row["launches_by_path"]["train_two_pass_warp_bf16"] = launches[
            row["name"]]
        row["bf16"]["launches_by_path"]["train_two_pass_warp_bf16"] = bf16[
            row["name"]]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        path = "serving_stream_bf16"
        art = _exported(os.path.join(tmp, path),
                        ["--bf16", "--verify", str(VERIFY_FRAMES),
                         *_export_flags()])
        runner = art.pop("runner")
        if runner.manifest["memory_dtype"] != "bfloat16":
            raise AssertionError(f"{path}: manifest {runner.manifest}")
        live = ESTMRunner(DepthNetHybrid(ModelConfig(
            ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
            resnet=50, compute_dtype="bfloat16"), seed=0), HEIGHT, WIDTH,
            LWINDOW, MEMORY, output_scales=SERVING_SCALES, device="cuda")
        res = _artifact_against_live(
            path, runner, live, list(synthetic_stream(
                SyntheticSceneConfig(height=HEIGHT, width=WIDTH, seed=0),
                FRAMES, DEPTH_MIN, DEPTH_MAX)),
            {"plane_sweep_warp": steps, "frustum_warp_exact_z": steps - 1},
            bf16=True)
        log("serving", path=path, **art, **res)
        for row in rows:
            row["launches_by_path"][path] = res["launches"][row["name"]]
            row["bf16"]["launches_by_path"][path] = res["launches"][
                row["name"]]
    torch.cuda.empty_cache()


def _timed_outputs(runner, frames) -> tuple[list, list]:
    """Frames through `runner.push_frame` after a reset: per output, the
    seconds from the first push since the previous output to the fetched
    maps (the uploads of a window's new frames, its step and the fetch),
    and the maps on the host."""
    runner.reset()
    times, maps, t0 = [], [], None
    for f in frames:
        if t0 is None:
            t0 = time.perf_counter()
        out = runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        if out is None:
            continue
        maps.append(out.float().cpu())  # waits for the step
        times.append(time.perf_counter() - t0)
        t0 = None
    return times, maps


class _JointFeed:
    """tools/eval_joint's JointRunner fed frame by frame: each completed
    window (seq_length frames, advancing by seq_length - 2) goes through
    `run_window` and returns the depths of `scales`."""

    def __init__(self, runner, seq_length: int, scales):
        self.runner, self.seq_length = runner, seq_length
        self.scales = list(scales)
        self.frames = []

    def reset(self) -> None:
        self.runner.reset()
        self.frames = []

    def push_frame(self, img, pose, intr):
        self.frames.append((img, pose))
        if len(self.frames) < self.seq_length:
            return None
        imgs = np.stack([f[0] for f in self.frames])[None]
        poses = np.stack([f[1] for f in self.frames])[None]
        depth = self.runner.run_window(imgs, poses, intr[None])[0]
        del self.frames[:self.seq_length - 2]
        return depth[:, :, self.scales]


def _artifact_against_live(path: str, artifact, live, frames,
                           expected: dict, bf16: bool = False) -> dict:
    """A loaded artifact and its live runner over the same frames in turns
    (artifact, live, live, artifact): the artifact's first pass between a
    reset and a read of the kernel counts (with `bf16`, every launch of
    the kernels' bf16 instances), max |artifact - live| over its maps, and
    each runner's steady-state ms per output (the median of the outputs
    after the first two, over both of its passes)."""
    _reset_counts()
    a1, maps = _timed_outputs(artifact, frames)
    torch.cuda.synchronize()
    launches = _read_counts()
    if launches != {**dict.fromkeys(KERNELS, 0), **expected}:
        raise AssertionError(f"{path}: kernel launches {launches}, "
                             f"expected {expected}")
    if bf16 and _read_bf16_counts() != launches:
        raise AssertionError(f"{path}: float32 instances launched: "
                             f"{launches}, bf16 {_read_bf16_counts()}")
    l1, want = _timed_outputs(live, frames)
    l2, _ = _timed_outputs(live, frames)
    a2, _ = _timed_outputs(artifact, frames)
    err = max((a - b).abs().max().item() for a, b in zip(maps, want))
    if not (len(maps) == len(want) and all(torch.isfinite(m).all()
                                           for m in maps)):
        raise AssertionError(f"{path}: {len(maps)} maps against "
                             f"{len(want)}, or not finite")
    ms = {name: 1e3 * statistics.median(t[2:] + u[2:])
          for name, t, u in (("artifact", a1, a2), ("live", l1, l2))}
    return {"launches": launches, "outputs": len(maps), "max_abs_err": err,
            "ms_artifact": ms["artifact"], "ms_live": ms["live"],
            "ratio_artifact_to_live": ms["artifact"] / ms["live"],
            "times_ms": {"artifact": [1e3 * t for t in a1 + a2],
                         "live": [1e3 * t for t in l1 + l2]}}


def _export_flags(seed: int = 0) -> list[str]:
    return ["--height", str(HEIGHT), "--width", str(WIDTH), "--ndepths",
            str(NDEPTHS), "--depth-min", str(DEPTH_MIN), "--depth-max",
            str(DEPTH_MAX), "--resnet", "50", "--seed", str(seed),
            "--scales", ",".join(map(str, SERVING_SCALES))]


def _exported(out: str, argv: list[str]) -> dict:
    """export_serving's main on the card, then the artifact loaded back
    (timed apart): the tool's numbers with the load's seconds."""
    res = export_serving.main(["--out", out, *argv])
    t0 = time.perf_counter()
    load = serving.load_joint if "--joint" in argv else serving.load_stream
    runner = load(out)
    return {"export_s": res["export_s"], "artifact_mb": res["bytes"] / 1e6,
            "load_s": time.perf_counter() - t0,
            "verify_max_abs_delta": res["max_abs_delta"], "runner": runner}


def phase_serving(rows: list[dict]) -> None:
    """Serving artifacts on the card (estdepth_tpu_torch/serving.py), at
    the flagship width, random weights from seed 0, through
    tools/export_serving.py's own `main` (exported on the card, verified
    by the tool, loaded back), so that all five kernels launch from loaded
    programs:

      * the ESTM stream step (`--verify 8`), streamed over phase_main_path's
        8-frame scene beside an ESTMRunner in turns;
      * the Joint window step (`--joint --verify 2`), once at the default
        warp and once with `--no-exact-z --fused-attention`, over the
        17-frame scene of phase_joint_path beside a JointRunner;
      * the stream step with the two-pass plane sweep (kernel 3);
      * no hidden fallback: a small artifact exported on the CPU (ResNet-18,
        D = 8, 64x96) and loaded onto the card launches kernels 1 and 2 and
        gives a card ESTMRunner's maps within 1e-5.

    Every kernel's count is set to 0 just before an artifact's first pass
    and read just after."""
    cfg = SyntheticSceneConfig(height=HEIGHT, width=WIDTH, seed=0)
    targets = SEQ_LENGTH - 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        runs = {"serving_stream": (
            ["--verify", str(VERIFY_FRAMES)], FRAMES,
            {"plane_sweep_warp": FRAMES - LWINDOW + 1,
             "frustum_warp_exact_z": FRAMES - LWINDOW})}
        est_windows = (JOINT_WINDOWS - 1) * targets
        joint_frames = (JOINT_WINDOWS - 1) * targets + SEQ_LENGTH
        runs["serving_joint"] = (
            ["--joint", "--verify", str(VERIFY_WINDOWS)], joint_frames,
            {"plane_sweep_warp": JOINT_WINDOWS,
             "frustum_warp_exact_z": est_windows})
        runs["serving_joint_plane_mix_fused_attention"] = (
            ["--joint", "--verify", str(VERIFY_WINDOWS), "--no-exact-z",
             "--fused-attention"], joint_frames,
            {"plane_sweep_warp": JOINT_WINDOWS,
             "frustum_warp_plane_mix": est_windows,
             "epipolar_attention": est_windows})
        for path, (argv, n_frames, expected) in runs.items():
            out = os.path.join(tmp, path)
            art = _exported(out, argv + _export_flags())
            model = DepthNetHybrid(ModelConfig(
                ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
                resnet=50,
                frustum_mode=("plane_mix" if "--no-exact-z" in argv
                              else "plane_mix_exact_z"),
                use_fused_attention="--fused-attention" in argv), seed=0)
            if "--joint" in argv:
                live = _JointFeed(eval_joint.JointRunner(model,
                                                         device="cuda"),
                                  SEQ_LENGTH, SERVING_SCALES)
            else:
                live = ESTMRunner(model, HEIGHT, WIDTH, LWINDOW, MEMORY,
                                  output_scales=SERVING_SCALES,
                                  device="cuda")
            frames = list(synthetic_stream(cfg, n_frames, DEPTH_MIN,
                                           DEPTH_MAX))
            res = _artifact_against_live(path, art.pop("runner"), live,
                                         frames, expected)
            log("serving", path=path, **art, **res)
            for row in rows:
                row["launches_by_path"][path] = res["launches"][row["name"]]
            del live, model
            shutil.rmtree(out)
            torch.cuda.empty_cache()
        _two_pass_artifact(rows, os.path.join(tmp, "two_pass"), cfg)
        _cpu_exported_artifact(os.path.join(tmp, "cpu_exported"))


def _two_pass_artifact(rows: list[dict], out: str, cfg) -> None:
    """The stream step with the two-pass plane sweep (kernel 3), which the
    export tool has no flag for: exported on the card through
    serving.export_stream, loaded back and streamed beside an ESTMRunner
    of the same model."""
    path = "serving_stream_two_pass_warp"
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50, two_pass_warp=True), seed=0)
    t0 = time.perf_counter()
    nbytes = serving.export_stream(model, height=HEIGHT, width=WIDTH,
                                   output_scales=SERVING_SCALES).save(out)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = serving.load_stream(out)
    load_s = time.perf_counter() - t0
    live = ESTMRunner(model, HEIGHT, WIDTH, LWINDOW, MEMORY,
                      output_scales=SERVING_SCALES, device="cuda")
    res = _artifact_against_live(
        path, runner, live,
        list(synthetic_stream(cfg, FRAMES, DEPTH_MIN, DEPTH_MAX)),
        {"two_pass_resample": FRAMES - LWINDOW + 1,
         "frustum_warp_exact_z": FRAMES - LWINDOW})
    log("serving", path=path, export_s=export_s, artifact_mb=nbytes / 1e6,
        load_s=load_s, **res)
    for row in rows:
        row["launches_by_path"][path] = res["launches"][row["name"]]


def _cpu_exported_artifact(out: str) -> None:
    """The small stream artifact exported on the CPU, loaded onto the card
    (torch.export's move to the device), against a card ESTMRunner."""
    cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18)
    t0 = time.perf_counter()
    serving.export_stream(DepthNetHybrid(cfg, seed=0), height=64, width=96,
                          output_scales=SERVING_SCALES, device="cpu").save(
        out)
    export_s = time.perf_counter() - t0
    runner = serving.load_stream(out, device="cuda")
    live = ESTMRunner(DepthNetHybrid(cfg, seed=0), 64, 96,
                      output_scales=SERVING_SCALES, device="cuda")
    frames = _pitched_frames(7)
    before = _read_counts()
    _, maps = _timed_outputs(runner, frames)
    torch.cuda.synchronize()
    grown = {k: n - before[k] for k, n in _read_counts().items()}
    _, want = _timed_outputs(live, frames)
    err = max((a - b).abs().max().item() for a, b in zip(maps, want))
    expected = {**dict.fromkeys(KERNELS, 0), "plane_sweep_warp": 5,
                "frustum_warp_exact_z": 4}
    log("serving_cpu_exported", manifest_device=runner.manifest["device"],
        export_s=export_s, launches=grown, max_abs_err=err, atol=1e-5)
    if grown != expected:
        raise AssertionError(f"CPU-exported artifact on the card: launches "
                             f"{grown}, expected {expected}")
    if not (len(maps) == len(want) == 5 and err <= 1e-5):
        raise AssertionError(f"CPU-exported artifact on the card: max abs "
                             f"err {err} over {len(maps)} maps")


def phase_release(rows: list[dict], train_ckpt: str) -> None:
    """The release flow on the card: phase_train_path's checkpoint (4
    flagship steps of tools/train.py) through tools/export_torch.py into a
    reference .ckpt, that .ckpt through `export_serving --ckpt --verify 4`,
    and the rehearsal's convert, eval (`eval_estm --ckpt --save-maps`) and
    score steps on the ScanNet-layout scene of phase_dataset_path. Every
    kernel's count is set to 0 just before the rehearsal and read just
    after."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_release_") as tmp:
        ckpt = os.path.join(tmp, "model.ckpt")
        exported = export_torch.main(["--ckpt", train_ckpt, "--out", ckpt])
        state = load_reference_checkpoint(ckpt, strict=True)[0]
        art = _exported(os.path.join(tmp, "estm"),
                        ["--ckpt", ckpt, "--verify",
                         str(RELEASE_VERIFY_FRAMES), *_export_flags()])
        del art["runner"]
        data, _ = _write_dataset(tmp)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with _without_opencv():
            summary = rehearse_release_ckpt.main([
                "--ckpt", ckpt, "--datapath", data, "--frame-interval",
                str(SCENE_INTERVAL), "--outdir", os.path.join(tmp, "out"),
                "--height", str(HEIGHT), "--width", str(WIDTH),
                "--ndepths", str(NDEPTHS), "--depth-min", str(DEPTH_MIN),
                "--depth-max", str(DEPTH_MAX), "--resnet", "50",
                "--max-frames", "100"])
        torch.cuda.synchronize()
        launches = _read_counts()
    steps = SCENE_FRAMES // SCENE_INTERVAL - 1 - LWINDOW + 1
    if launches != {**dict.fromkeys(KERNELS, 0), "plane_sweep_warp": steps,
                    "frustum_warp_exact_z": steps - 1}:
        raise AssertionError(f"release: kernel launches {launches}")
    if summary["eval"]["frames"] != steps:
        raise AssertionError(f"release: {summary['eval']['frames']} frames")
    for k in ("abs_relative", "rmse"):
        tool, offline = summary["eval"]["metrics"][k], summary["score"][k]
        if not abs(offline - tool) <= DUMP_REL_TOL * tool:
            raise AssertionError(f"release: score_offline {k} {offline} "
                                 f"against the tool's {tool}")
    log("release", export_torch=exported, tensors=len(state),
        convert=summary["convert"], **art, launches=launches,
        eval_metrics=summary["eval"]["metrics"],
        score_offline={k: summary["score"][k] for k in
                       ("abs_relative", "rmse")})
    for row in rows:
        row["launches_by_path"]["release"] = launches[row["name"]]


def phase_train_path(rows: list[dict], keep_ckpt: str) -> dict:
    """The training step at the flagship width through tools/train.py's own
    loop (`run`): 256x320, D = 64, ResNet-50, 5-frame windows, batch 1, EST
    on, 1 warm-up step and 3 timed ones, once with the default plane sweep
    (kernel 1) and once through the two-pass resample (kernel 3). Every
    kernel's count is set to 0 just before each run and read just after.
    The default run's checkpoint directory is copied to `keep_ckpt`.
    Returns each run's ms per step."""
    moved_prefixes = ("matchingFeature", "semanticFeature", "CostRegNet",
                      "pre0")
    targets = TRAIN_FRAMES - 2
    ms_per_step = {}
    for path, flags in (("train", []),
                        ("train_two_pass_warp", ["--two-pass-warp"])):
        with tempfile.TemporaryDirectory() as logdir:
            args = train_tool.parse_args([
                "--synthetic", "--steps", str(TRAIN_STEPS), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--ndepths",
                str(NDEPTHS), "--depth-min", str(DEPTH_MIN), "--depth-max",
                str(DEPTH_MAX), "--resnet", "50", "--n-frames",
                str(TRAIN_FRAMES), "--batch-per-device", "1",
                "--summary-freq", "1", "--seed", "0", "--logdir", logdir,
                *flags])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            res = train_tool.run(args)
            torch.cuda.synchronize()
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated()
            if not flags:
                shutil.copytree(os.path.join(logdir, "ckpt"), keep_ckpt)
        records = res["records"]
        if [r["step"] for r in records] != list(range(1, TRAIN_STEPS + 1)):
            raise AssertionError(f"{path}: steps {records}")
        for r in records:
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"{path}: step {r['step']} loss "
                                     f"{r['loss']} grad_norm "
                                     f"{r['grad_norm']}")
        # per step: one sweep of the window's 6 pairs, and one frustum warp
        # per target of the sequential EST fusion
        sweep = "two_pass_resample" if flags else "plane_sweep_warp"
        expected = {**dict.fromkeys(KERNELS, 0), sweep: TRAIN_STEPS,
                    "frustum_warp_exact_z": targets * TRAIN_STEPS}
        if launches != expected:
            raise AssertionError(f"{path}: kernel launches {launches}, "
                                 f"expected {expected}")
        start = train_tool.build(args, "cpu")[0].model.state_dict()
        final = res["state"].model.state_dict()
        for prefix in moved_prefixes:
            if not any(not torch.equal(v.cpu(), start[k])
                       for k, v in final.items()
                       if k.startswith(prefix) and k.endswith("weight")):
                raise AssertionError(f"{path}: no weight of {prefix} moved")
        ms = 1e3 * statistics.median(r["seconds"] for r in records[1:])
        ms_per_step[path] = ms
        log("train_path", path=path, steps=TRAIN_STEPS, remat=False,
            launches=launches,
            launches_per_step={k: n // TRAIN_STEPS
                               for k, n in launches.items()},
            ms_per_step=ms, times_ms=[1e3 * r["seconds"] for r in records],
            losses=[r["loss"] for r in records],
            grad_norms=[r["grad_norm"] for r in records],
            max_memory_allocated=peak)
        for row in rows:
            row["launches_by_path"][path] = launches[row["name"]]
        del res
    return ms_per_step


def _write_dataset(tmp: str) -> tuple[str, str]:
    """The dataset phase's inputs: a ScanNet-layout scene rendered at
    ScanNet's 640x480 and focal, and the seed-0 model's weights as a
    reference checkpoint (`module.` names under "model")."""
    cfg = SyntheticSceneConfig(height=480, width=640, focal=577.87)
    poses = [pose(cfg, i) for i in range(SCENE_FRAMES)]
    poses[NONFINITE_FRAME][:3, 3] = np.nan
    data = os.path.join(tmp, "scannet")
    write_scannet_scene(os.path.join(data, SCENE), cfg, poses)
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50), seed=0)
    ckpt = os.path.join(tmp, "model.ckpt")
    torch.save({"epoch": 0, "model": {f"module.{k}": v for k, v in
                                      model.state_dict().items()}}, ckpt)
    return data, ckpt


def _check_maps(path: str, maps: np.ndarray, shape: tuple) -> None:
    if maps.shape != shape:
        raise AssertionError(f"{path}: outputs {maps.shape}, expected "
                             f"{shape}")
    if not (np.isfinite(maps).all() and maps.min() >= 0
            and maps.max() <= DEPTH_MAX):
        raise AssertionError(f"{path}: depths not finite or outside "
                             f"[0, depth_max]")


def _dumps(outdir: str) -> int:
    return len([f for f in os.listdir(outdir) if f.endswith(".npy")])


@contextlib.contextmanager
def _without_opencv():
    """The port's readers and image writer as on a machine without OpenCV
    (data/png.py and io_utils.resize_linear), whether or not cv2 imports."""
    saved = io_utils.HAVE_CV2, viz.HAVE_CV2
    io_utils.HAVE_CV2 = viz.HAVE_CV2 = False
    try:
        yield
    finally:
        io_utils.HAVE_CV2, viz.HAVE_CV2 = saved


def _readers_against_opencv(data: str, frames: int = 3):
    """Where cv2 imports: the stream's first frames read by the port's own
    decoder and resize against cv2's. Depth must be equal and colour within
    1 grey level (the tolerance the CPU tests allow; they measure equality
    with the cv2 there). None without cv2."""
    if not io_utils.HAVE_CV2:
        return None
    got = []
    for ctx in (contextlib.nullcontext, _without_opencv):
        ds = StreamEvalDataset(data, HEIGHT, WIDTH,
                               frame_interval=SCENE_INTERVAL)
        ds.reset(SCENE)
        with ctx():
            got.append([f for _, f in zip(range(frames), ds)])
    diff = np.stack([np.abs(a["img"].astype(int) - b["img"])
                     for a, b in zip(*got)])
    if not (diff.max() <= 1 and all(
            np.array_equal(a[k], b[k]) for a, b in zip(*got)
            for k in ("dmap", "dmask"))):
        raise AssertionError(f"the port's reader differs from cv2 (colour "
                             f"by up to {diff.max()})")
    return {"cv2": _cv2_version(), "frames": frames,
            "img_max_abs_diff": int(diff.max()),
            "img_diff_share": float((diff > 0).mean()), "depth_equal": True}


def _cv2_version():
    return io_utils.cv2.__version__ if io_utils.HAVE_CV2 else None


def phase_dataset_path(rows: list[dict], main_ms: float) -> None:
    """The eval tools on a recorded scene at the flagship width: a scene in
    ScanNet's layout and a reference checkpoint through tools/eval_estm.py
    and tools/eval_joint.py (`run`, maps saved; Joint once with the default
    warp and once with the plane-mix warp and the attention kernel), then
    tools/score_offline.py on the ESTM dump, all with the readers of a
    machine without OpenCV (where cv2 imports, they are first held against
    it). Every kernel's count is set to 0 just before each tool run and
    read just after."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_") as tmp:
        t0 = time.perf_counter()
        data, ckpt = _write_dataset(tmp)
        write_s = time.perf_counter() - t0
        against_opencv = _readers_against_opencv(data)
        with _without_opencv():
            res, joint, offline, launches, peak = _dataset_runs(
                rows, data, ckpt, tmp)
    ms = 1e3 * statistics.median(res["times"][2:])
    host = sum(res["host"].values())
    steps = len(res["maps"])
    maps = np.stack(res["maps"])
    log("dataset_path", scene=[480, 640], frames=steps + LWINDOW - 1,
        outputs=steps, write_scene_s=write_s, opencv=_cv2_version(),
        readers_against_opencv=against_opencv, launches=launches,
        ms_per_frame=ms, main_path_ms_per_frame=main_ms,
        ratio_to_main_path=ms / main_ms,
        times_ms=[1e3 * t for t in res["times"]],
        wall_ms_per_frame=1e3 * res["seconds"] / steps,
        host_ms_per_frame={k: 1e3 * v / steps for k, v in
                           res["host"].items()},
        host_share=host / res["seconds"], max_memory_allocated=peak,
        bit_equal_to_runner=True, score_offline=offline, joint=joint,
        depth_range=[float(maps.min()), float(maps.max())])


def _dataset_runs(rows: list[dict], data: str, ckpt: str, tmp: str):
    """phase_dataset_path's tool runs and their checks: (ESTM result,
    Joint summaries, score_offline against the ESTM tool, ESTM launches,
    ESTM peak memory)."""
    flags = ["--datapath", data, "--eval-dataset", "scannet", "--ckpt",
             ckpt, "--frame-interval", str(SCENE_INTERVAL),
             "--save-maps", "--height", str(HEIGHT), "--width",
             str(WIDTH), "--ndepths", str(NDEPTHS), "--depth-min",
             str(DEPTH_MIN), "--depth-max", str(DEPTH_MAX), "--resnet",
             "50"]

    # ESTM through the tool, then the same frames through a runner
    estm_dir = os.path.join(tmp, "estm")
    args = eval_estm.parse_args(flags + ["--outdir", estm_dir])
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = eval_estm.run(args, keep_maps=True)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    ds = StreamEvalDataset(data, HEIGHT, WIDTH, depth_min=DEPTH_MIN,
                           depth_max=min(DEPTH_MAX, 5.0),
                           frame_interval=SCENE_INTERVAL)
    ds.reset(SCENE)
    frames = SCENE_FRAMES // SCENE_INTERVAL - 1  # one pose skipped
    steps = frames - LWINDOW + 1
    if len(ds) != frames:
        raise AssertionError(f"stream of {len(ds)} frames")
    maps = np.stack(res["maps"])
    _check_maps("estm_dataset", maps, (steps, 2, HEIGHT, WIDTH))
    if launches != {**dict.fromkeys(KERNELS, 0),
                    "plane_sweep_warp": steps,
                    "frustum_warp_exact_z": steps - 1}:
        raise AssertionError(f"estm_dataset: kernel launches {launches}")
    if _dumps(estm_dir) != 2 * steps:
        raise AssertionError(f"estm_dataset: {_dumps(estm_dir)} maps")
    for row in rows:
        row["launches_by_path"]["estm_dataset"] = launches[row["name"]]
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50))
    model.load_state_dict(load_reference_checkpoint(ckpt)[0])
    runner = ESTMRunner(model, HEIGHT, WIDTH, LWINDOW, MEMORY,
                        output_scales=(0, 2), device="cuda")
    ref = [out[0].cpu().numpy() for f in ds if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    if not (len(ref) == steps and all(
            np.array_equal(a, b) for a, b in zip(maps, ref))):
        raise AssertionError("estm_dataset: the tool's maps differ from "
                             "an ESTMRunner's on the same frames")
    del runner, model

    # the dump rescored offline
    scores = score_offline.main([
        "--preddir", estm_dir, "--datapath", data, "--frame-interval",
        str(SCENE_INTERVAL), "--height", str(HEIGHT), "--width",
        str(WIDTH), "--json", os.path.join(tmp, "scores.json")])
    offline = {}
    for k in ("abs_relative", "rmse"):
        tool = float(np.mean([e[k] for e in res["errors"]]))
        offline[k] = {"tool": tool, "score_offline":
                      scores["overall"][k]}
        if not abs(scores["overall"][k] - tool) <= DUMP_REL_TOL * tool:
            raise AssertionError(f"score_offline {k} "
                                 f"{scores['overall'][k]} against the "
                                 f"tool's {tool}")

    # Joint: 5-frame windows; the one holding the bad pose is skipped
    wds = WindowEvalDataset(data, HEIGHT, WIDTH, seq_length=SEQ_LENGTH,
                            frame_interval=SCENE_INTERVAL,
                            scannet_layout=True)
    wds.reset(SCENE)
    windows, targets = len(wds), SEQ_LENGTH - 2
    fused = (windows - 1) * targets
    joint = {}
    for path, extra, expected in (
            ("joint_dataset", [], {"frustum_warp_exact_z": fused}),
            ("joint_dataset_plane_mix_fused_attention",
             ["--no-exact-z", "--fused-attention"],
             {"frustum_warp_plane_mix": fused,
              "epipolar_attention": fused})):
        outdir = os.path.join(tmp, path)
        jargs = eval_joint.parse_args(
            flags + ["--save-probs", "--outdir", outdir] + extra)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        jres = eval_joint.run(jargs, keep_maps=True)
        torch.cuda.synchronize()
        jl = _read_counts()
        jmaps = np.stack(jres["maps"])
        _check_maps(path, jmaps, (windows, targets, 2, HEIGHT, WIDTH))
        expected = {**dict.fromkeys(KERNELS, 0),
                    "plane_sweep_warp": windows, **expected}
        if jl != expected:
            raise AssertionError(f"{path}: kernel launches {jl}, "
                                 f"expected {expected}")
        # per target: refined and fused depth, init and refined prob
        if _dumps(outdir) != 4 * targets * windows:
            raise AssertionError(f"{path}: {_dumps(outdir)} maps")
        for row in rows:
            row["launches_by_path"][path] = jl[row["name"]]
        jms = 1e3 * statistics.median(jres["times"][2:])
        joint[path] = {
            "windows": windows, "launches": jl, "ms_per_window": jms,
            "targets_per_s": targets * 1e3 / jms,
            "times_ms": [1e3 * t for t in jres["times"]],
            "host_ms_per_window": {k: 1e3 * v / windows for k, v in
                                   jres["host"].items()},
            "wall_ms_per_window": 1e3 * jres["seconds"] / windows,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return res, joint, offline, launches, peak


def _torchvision_pth(path: str, depth: int, seed: int) -> dict:
    """A seeded state dict in torchvision's resnet<depth> layout (the
    encoder's names, num_batches_tracked and the fc head), saved to `path`
    as a .pth: a stand-in for ImageNet weights. Returns it."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, v in ResNetEncoder(depth).encoder.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.tensor(100)
        elif v.dim() == 4:  # conv: He normal
            state[name] = torch.randn(v.shape, generator=gen) * (
                2.0 / v[0].numel()) ** 0.5
        elif name.endswith("running_var"):
            state[name] = 0.5 + torch.rand(v.shape, generator=gen)
        elif name.endswith("weight"):
            state[name] = 0.5 + 0.5 * torch.rand(v.shape, generator=gen)
        else:  # bias, running_mean
            state[name] = 0.1 * torch.randn(v.shape, generator=gen)
    width = 512 * (4 if depth > 34 else 1)
    state["fc.weight"] = 0.01 * torch.randn(1000, width, generator=gen)
    state["fc.bias"] = torch.zeros(1000)
    torch.save(state, path)
    return state


def _write_train_dataset(tmp: str) -> tuple[str, str]:
    """phase_train_dataset's scene: ScanNet's training layout at 640x480
    and its focal, 200 pose ids with colour (JPEG) and depth for every
    10th, the first JPEG cut inside its header. Returns (data root, the
    corrupt JPEG's path)."""
    cfg = SyntheticSceneConfig(height=480, width=640, focal=577.87)
    poses = [pose(cfg, k // TRAIN_SCENE_INTERVAL)
             for k in range(TRAIN_SCENE_IDS)]
    data = os.path.join(tmp, "scannet_train")
    jpegs = write_scannet_train_scene(os.path.join(data, SCENE), cfg, poses,
                                      TRAIN_SCENE_INTERVAL)
    with open(jpegs[0], "rb") as f:
        head = f.read(300)
    with open(jpegs[0], "wb") as f:
        f.write(head)
    return data, jpegs[0]


def _native_against_opencv(window: dict) -> dict:
    """The native reader against cv2 on one window of the scene, at the
    JAX package's tolerances (tests/test_native_loader.py); the build's
    error where it did not build."""
    if not native.available():
        return {"built": False, "build_error": native.build_error()}
    imgs, depths, poses = native.read_window(
        window["images"], window["depths"], window["poses"], WIDTH, HEIGHT)
    img_err = np.stack([np.abs(imgs[i] - io_utils.read_image_rgb(
        p, WIDTH, HEIGHT)) for i, p in enumerate(window["images"])])
    depth_err = max(float(np.abs(depths[i] - io_utils.read_depth_mm(
        p, WIDTH, HEIGHT)).max()) for i, p in enumerate(window["depths"]))
    for i, p in enumerate(window["poses"]):
        np.testing.assert_allclose(poses[i], io_utils.read_pose(p),
                                   rtol=1e-6)
    if not (img_err.mean() < 1.0 and img_err.max() < 16.0
            and depth_err < 0.02):
        raise AssertionError(f"native reader against cv2: colour mean "
                             f"{img_err.mean()} max {img_err.max()}, "
                             f"depth {depth_err} m")
    return {"built": True, "frames": len(window["images"]),
            "img_mean_abs_diff": float(img_err.mean()),
            "img_max_abs_diff": float(img_err.max()),
            "depth_max_abs_diff_m": depth_err, "poses_rtol": 1e-6}


def _train_on_scene(data: str, logdir: str, resnet: int, pth: str,
                    steps: int) -> tuple[dict, dict, int]:
    """tools/train.py's `run` on the written scene at the flagship width:
    (result, launches, peak bytes). Every kernel's count is set to 0 just
    before the run and read just after."""
    args = train_tool.parse_args([
        "--datapath", data, "--steps", str(steps), "--height", str(HEIGHT),
        "--width", str(WIDTH), "--ndepths", str(NDEPTHS), "--depth-min",
        str(DEPTH_MIN), "--depth-max", str(DEPTH_MAX), "--resnet",
        str(resnet), "--n-frames", str(TRAIN_FRAMES), "--batch-per-device",
        "1", "--summary-freq", "1", "--seed", "0", "--num-workers",
        str(TRAIN_WORKERS), "--image-freq", str(IMAGE_FREQ),
        "--pretrained-encoder", pth, "--logdir", logdir])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = train_tool.run(args)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    records = res["records"]
    if [r["step"] for r in records] != list(range(1, steps + 1)):
        raise AssertionError(f"resnet {resnet}: steps {records}")
    for r in records:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"resnet {resnet}: step {r['step']} loss "
                                 f"{r['loss']} grad_norm {r['grad_norm']}")
    # per step one plane sweep and one frustum warp per target; each image
    # dump runs an eval-mode forward: one more plane sweep, no EST fusion
    dumps = steps // IMAGE_FREQ
    expected = {**dict.fromkeys(KERNELS, 0),
                "plane_sweep_warp": steps + dumps,
                "frustum_warp_exact_z": (TRAIN_FRAMES - 2) * steps}
    if launches != expected:
        raise AssertionError(f"resnet {resnet}: kernel launches {launches}, "
                             f"expected {expected}")
    img_dir = os.path.join(logdir, "images")
    images = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []
    want = sorted(f"{kind}_{step:07d}.jpg" for kind in ("depth", "prob", "gt")
                  for step in range(IMAGE_FREQ, steps + 1, IMAGE_FREQ))
    if images != want:
        raise AssertionError(f"resnet {resnet}: image dumps {images}")
    return res, launches, peak


def phase_train_dataset(rows: list[dict], train_ms: float) -> None:
    """Training from a recorded scene through tools/train.py at the
    flagship width (256x320, D = 64, ResNet-50, 5-frame windows, batch 1):
    `--datapath` on a written ScanNet training scene with one corrupt JPEG,
    `--pretrained-encoder` from a seeded torchvision-layout .pth, 4 decode
    threads, an image dump every 3 steps, 6 steps; then 2 steps of
    ResNet-101 from its own .pth. The native reader is first held against
    cv2 on the scene where it builds. Reports ms per step beside
    phase_train_path's in the same run, the loop's wait on the loader, and
    peak memory."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        data, corrupt = _write_train_dataset(tmp)
        write_s = time.perf_counter() - t0
        args = train_tool.parse_args(["--datapath", data])
        dataset = train_tool.make_dataset(args)
        if len(dataset) != 5:
            raise AssertionError(f"{len(dataset)} training windows")
        against_opencv = _native_against_opencv(dataset.index[1])
        pth = os.path.join(tmp, "resnet50.pth")
        encoder = _torchvision_pth(pth, 50, seed=0)
        logdir = os.path.join(tmp, "logs")
        res, launches, peak = _train_on_scene(
            data, logdir, 50, pth, TRAIN_DATASET_STEPS)
        # the encoder started from the .pth: a few Adam steps at a warm-up
        # rate of ~1e-5 move no weight by 1e-3, a fresh init by ~0.1
        final = res["state"].model.state_dict()
        moved = max(float((final[f"semanticFeature.encoder.{k}"].cpu()
                           - v).abs().max())
                    for k, v in encoder.items()
                    if k.endswith("weight") and not k.startswith("fc."))
        if not moved < 1e-3:
            raise AssertionError(f"the encoder is {moved} from the .pth")
        del res["state"]
        pth101 = os.path.join(tmp, "resnet101.pth")
        _torchvision_pth(pth101, 101, seed=1)
        res101, launches101, peak101 = _train_on_scene(
            data, os.path.join(tmp, "logs101"), 101, pth101, 2)
        del res101["state"]
    records = res["records"]
    ms = 1e3 * statistics.median(r["seconds"] for r in records[1:])
    waits = [1e3 * r["loader_seconds"] for r in records]
    log("train_dataset", scene=[480, 640], windows=len(dataset),
        corrupt_jpeg=os.path.basename(corrupt), backend=dataset.backend,
        write_scene_s=write_s, native_against_opencv=against_opencv,
        opencv=_cv2_version(), steps=TRAIN_DATASET_STEPS,
        num_workers=TRAIN_WORKERS, launches=launches,
        ms_per_step=ms, train_path_ms_per_step=train_ms,
        ratio_to_train_path=ms / train_ms,
        times_ms=[1e3 * r["seconds"] for r in records],
        loader_wait_ms=waits,
        loader_wait_ms_per_step=statistics.mean(waits[1:]),
        losses=[r["loss"] for r in records], encoder_max_moved=moved,
        max_memory_allocated=peak,
        resnet101={"launches": launches101,
                   "times_ms": [1e3 * r["seconds"]
                                for r in res101["records"]],
                   "loader_wait_ms": [1e3 * r["loader_seconds"]
                                      for r in res101["records"]],
                   "losses": [r["loss"] for r in res101["records"]],
                   "max_memory_allocated": peak101})
    for row in rows:
        row["launches_by_path"]["train_dataset"] = launches[row["name"]]
        row["launches_by_path"]["train_dataset_resnet101"] = launches101[
            row["name"]]


def _ddp_flags(logdir: str, dtype: str) -> list[str]:
    """tools/train.py at the flagship width: 5-frame windows, batch 1 per
    process, EST on, seed 0, DDP_STEPS steps."""
    return ["--synthetic", "--steps", str(DDP_STEPS), "--height",
            str(HEIGHT), "--width", str(WIDTH), "--ndepths", str(NDEPTHS),
            "--depth-min", str(DEPTH_MIN), "--depth-max", str(DEPTH_MAX),
            "--resnet", "50", "--n-frames", str(TRAIN_FRAMES),
            "--batch-per-device", "1", "--summary-freq", "1", "--seed", "0",
            "--num-workers", "2", "--ckpt-steps", str(10 * DDP_STEPS),
            "--image-freq", str(10 * DDP_STEPS), "--logdir", logdir,
            *(["--bf16"] if dtype == "bfloat16" else [])]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bn_stats(model) -> dict:
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _trajectory(path: str, losses, want_losses, stats, want_stats,
                f32_stats=None) -> dict:
    """Losses at rtol 3e-3 and BN statistics at rtol 5e-3 (atol 5e-4), the
    PARITY.md trajectory tolerances. In bf16 (`f32_stats`: the float32
    run's statistics from the same start) the statistics are held by the
    port's bf16 rule instead, as reference_bf16: within 2x the bf16 run's
    own largest distance from float32. Returns the largest errors."""
    np.testing.assert_allclose(losses, want_losses, rtol=3e-3,
                               err_msg=f"{path}: losses")
    worst, outside = 0.0, 0
    for k, want in want_stats.items():
        if f32_stats is None:
            np.testing.assert_allclose(stats[k].numpy(), want.numpy(),
                                       rtol=5e-3, atol=5e-4,
                                       err_msg=f"{path}: {k}")
        outside += int((~torch.isclose(stats[k], want, rtol=5e-3,
                                       atol=5e-4)).sum())
        worst = max(worst, float((stats[k] - want).abs().max()))
    errs = {"loss_max_rel_err": float(np.max(np.abs(
        np.subtract(losses, want_losses)) / np.abs(want_losses))),
        "bn_max_abs_err": worst, "bn_stats": len(want_stats),
        "bn_elements_outside_5e-3": outside}
    if f32_stats is not None:
        own = max(float((want_stats[k] - v).abs().max())
                  for k, v in f32_stats.items())
        errs["bn_bf16_to_f32_max_abs"] = own
        if not worst <= 2 * own:
            raise AssertionError(f"{path}: BN statistics {worst} from the "
                                 f"reference run, 2x bf16's own {own}")
    return errs


def _ddp_one_rank(rows: list[dict], dtype: str, f32_stats=None) -> dict:
    """Case (a): tools/train.py --multihost on one NCCL rank (the data mesh
    of one process: DDP, synced BatchNorm, the scalars' all-reduce) in
    turns with the one-device run of the same tool (one, ddp, ddp, one),
    the same weights and windows. Every kernel's count is set to 0 just
    before each run and read just after. Returns the one-device run's BN
    statistics; bf16 takes the float32 ones as `f32_stats`."""
    runs = {"one": [], "ddp": []}
    for kind in ("one", "ddp", "ddp", "one"):
        extra = [] if kind == "one" else [
            "--multihost", "--coordinator", f"localhost:{_free_port()}",
            "--num-processes", "1", "--process-id", "0"]
        with tempfile.TemporaryDirectory() as logdir:
            args = train_tool.parse_args(_ddp_flags(logdir, dtype) + extra)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            res = train_tool.run(args)
            torch.cuda.synchronize()
            launches, bf16 = _read_counts(), _read_bf16_counts()
        records = res["records"]
        if [r["step"] for r in records] != list(range(1, DDP_STEPS + 1)):
            raise AssertionError(f"train_ddp {kind}: steps {records}")
        runs[kind].append({
            "losses": [r["loss"] for r in records],
            "ms": 1e3 * statistics.median(r["seconds"] for r in records[1:]),
            "times_ms": [1e3 * r["seconds"] for r in records],
            "stats": _bn_stats(res["state"].model), "launches": launches,
            "bf16": bf16, "peak": torch.cuda.max_memory_allocated()})
        del res
    one, ddp = runs["one"][0], runs["ddp"][0]
    errs = _trajectory(f"train_ddp {dtype}", ddp["losses"], one["losses"],
                       ddp["stats"], one["stats"], f32_stats)
    per_step = {"plane_sweep_warp": DDP_STEPS,
                "frustum_warp_exact_z": (TRAIN_FRAMES - 2) * DDP_STEPS}
    for kind, rs in runs.items():
        for r in rs:
            _launched_equal(f"train_ddp {dtype} {kind}", r, per_step, dtype)
    ms = {k: statistics.median(r["ms"] for r in rs) for k, rs in runs.items()}
    log("train_ddp", case="one_rank_nccl", dtype=dtype, steps=DDP_STEPS,
        ms_per_step_ddp=ms["ddp"], ms_per_step_one_device=ms["one"],
        ratio_ddp_to_one_device=ms["ddp"] / ms["one"],
        times_ms={k: [r["times_ms"] for r in rs] for k, rs in runs.items()},
        losses_ddp=ddp["losses"], losses_one_device=one["losses"], **errs,
        launches_per_step={k: n // DDP_STEPS
                           for k, n in ddp["launches"].items()},
        max_memory_allocated_ddp=max(r["peak"] for r in runs["ddp"]),
        max_memory_allocated_one_device=max(r["peak"] for r in runs["one"]),
        nvidia_smi=nvidia_smi())
    path = "train_ddp_nccl" + ("_bf16" if dtype == "bfloat16" else "")
    for row in rows:
        row["launches_by_path"][path] = ddp["launches"][row["name"]]
        if dtype == "bfloat16":
            row["bf16"]["launches_by_path"][path] = ddp["bf16"][row["name"]]
    return one["stats"]


def _launched_equal(path: str, run: dict, expected: dict, dtype: str):
    want = {**dict.fromkeys(KERNELS, 0), **expected}
    if run["launches"] != want:
        raise AssertionError(f"{path}: kernel launches {run['launches']}, "
                             f"expected {want}")
    if run["bf16"] != (want if dtype == "bfloat16"
                       else dict.fromkeys(KERNELS, 0)):
        raise AssertionError(f"{path}: bf16 instance launches {run['bf16']}")


def _ddp_windows(rank: int, size: int):
    """This rank's first DDP_STEPS batches of the tool's synthetic
    windows, sharded as tools/train.py shards them (one loader shard per
    rank, batch 1); with size 1 and batch `2`, both ranks' in one batch."""
    ds = train_tool.SyntheticTrainDataset(256, HEIGHT, WIDTH, TRAIN_FRAMES,
                                          DEPTH_MIN, DEPTH_MAX)
    loader = TrainLoader(ds, 2 if size == 1 else 1, shard_index=rank,
                         num_shards=size, num_workers=2, seed=0)
    with contextlib.closing(loader.epoch(0)) as source:
        return [b for _, b in zip(range(DDP_STEPS), source)]


def _ddp_model(mesh=None):
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50), seed=0).cuda()
    if mesh is not None:
        convert_sync_batchnorm(model, mesh)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(),
        warmup_multistep_schedule(4e-5, steps_per_epoch=10**6))
    step = make_train_step(model, optimizer, scheduler, DEPTH_MIN, DEPTH_MAX,
                           mesh=mesh)
    return model, optimizer, scheduler, step


def _union_share(spans, t0: float, t1: float) -> float:
    """Share of [t0, t1] covered by the union of the (start, end) spans."""
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy, end = busy + b - a, b
    return busy / (t1 - t0)


def ddp_rank(rank: int, port: int, out: str) -> None:
    """Case (b), one of two ranks on the one card over gloo (NCCL refuses
    two ranks on one device): parallel.mesh and the trainer driven
    directly, 3 steps of this rank's windows. Times every collective of
    the step: the synced BatchNorm's and the scalars' all-reduces (each
    after a device synchronize, so its span is the exchange) and DDP's
    bucket all-reduces (from issue to completion, through a timing
    communication hook of the same arithmetic as DDP's default). Writes
    out/rank<r>.json; rank 0's checkpoint goes to out/ckpt."""
    set_fp32_numerics()
    dev = init_distributed(f"localhost:{port}", 2, rank, device="cuda:0",
                           backend="gloo")
    mesh = create_mesh(device=dev)
    spans = []
    all_reduce = torch.distributed.all_reduce

    def timed_all_reduce(tensor, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = all_reduce(tensor, *a, **k)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter()))
        return res

    def timed_hook(state, bucket):
        t0 = time.perf_counter()
        buf = bucket.buffer().div_(mesh.size)
        fut = all_reduce(buf, group=mesh.group, async_op=True).get_future()

        def done(f):
            spans.append((t0, time.perf_counter()))
            return f.value()[0]

        return fut.then(done)

    def replicate_timed(*a, **k):
        replica = parallel_mesh.replicate(*a, **k)
        replica.register_comm_hook(None, timed_hook)
        return replica

    torch.distributed.all_reduce = timed_all_reduce
    trainer.replicate = replicate_timed
    model, optimizer, scheduler, step = _ddp_model(mesh)
    batches = _ddp_windows(rank, 2)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, shares, steps = [], [], [], []
    for batch in batches:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        spans.clear()
        t0 = time.perf_counter()
        losses.append(float(step(batch, 10.0)["loss"]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        shares.append(_union_share(spans, t0, t1))
        steps.append(len(spans))
    torch.distributed.all_reduce = all_reduce
    launches = _read_counts()
    worst = 0.0  # max |this rank - rank 0| of every parameter and statistic
    for t in model.state_dict().values():
        ref = t.clone()
        torch.distributed.broadcast(ref, 0)
        worst = max(worst, float((t.double() - ref.double()).abs().max()))
    CheckpointManager(os.path.join(out, "ckpt")).save(
        DDP_STEPS, TrainState(model, optimizer, scheduler, DDP_STEPS))
    if rank == 0:
        torch.save(_bn_stats(model), os.path.join(out, "stats.pt"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "times_ms": [1e3 * t for t in times],
                   "collective_share": shares, "collectives": steps,
                   "launches": launches, "max_abs_param_spread": worst,
                   "max_memory_allocated":
                       torch.cuda.max_memory_allocated()}, f)
    shutdown()


def _ddp_two_ranks() -> None:
    """Case (b): two ranks on the one card over gloo, each its own
    process (`chip_smoke.py --ddp-rank R`), 3 float32 steps; then the
    one-process step on the batch of both ranks' windows, from the same
    weights, and rank 0's checkpoint into a one-device model."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-rank",
             str(r), "--port", str(port), "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DDP_RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"ddp rank {r} exited {p.returncode}:"
                                     f"\n{text[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        stats = torch.load(os.path.join(out, "stats.pt"), weights_only=True)
        ckpt = CheckpointManager(os.path.join(out, "ckpt"))
        if ckpt.steps() != [DDP_STEPS]:
            raise AssertionError(f"ddp checkpoint steps {ckpt.steps()}")
        blob = torch.load(ckpt.path(DDP_STEPS), weights_only=True)
        DepthNetHybrid(ModelConfig(ndepths=NDEPTHS, resnet=50)
                       ).load_state_dict(blob["model"], strict=True)
    r0, r1 = ranks
    if r0["losses"] != r1["losses"]:
        raise AssertionError(f"ddp ranks' losses {r0['losses']} "
                             f"{r1['losses']}")
    if r1["max_abs_param_spread"] != 0.0:
        raise AssertionError(f"ddp ranks' parameters differ by "
                             f"{r1['max_abs_param_spread']}")
    per_step = {"plane_sweep_warp": DDP_STEPS,
                "frustum_warp_exact_z": (TRAIN_FRAMES - 2) * DDP_STEPS}
    for r in ranks:
        if r["launches"] != {**dict.fromkeys(KERNELS, 0), **per_step}:
            raise AssertionError(f"ddp rank launches {r['launches']}")
    # the function sync-BN makes the two ranks compute: one process, the
    # batch of both windows, plain BatchNorm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, _, _, step = _ddp_model()
    losses = []
    times = []
    for batch in _ddp_windows(0, 1):
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch, 10.0)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    errs = _trajectory("train_ddp two ranks", r0["losses"], losses, stats,
                       _bn_stats(model))
    ms = statistics.median(max(a, b) for a, b in zip(r0["times_ms"][1:],
                                                     r1["times_ms"][1:]))
    log("train_ddp", case="two_ranks_gloo_one_card", dtype="float32",
        steps=DDP_STEPS, ms_per_step=ms,
        times_ms=[r["times_ms"] for r in ranks],
        collective_share=[r["collective_share"] for r in ranks],
        collective_share_median=statistics.median(
            r0["collective_share"][1:] + r1["collective_share"][1:]),
        collectives_per_step=r0["collectives"], losses=r0["losses"],
        max_abs_param_spread=r1["max_abs_param_spread"],
        batch2_losses=losses, batch2_ms_per_step=1e3 * statistics.median(
            times[1:]),
        batch2_max_memory_allocated=torch.cuda.max_memory_allocated(),
        **errs, launches_per_step={k: n // DDP_STEPS
                                   for k, n in r0["launches"].items()},
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        checkpoint_strict_load=True, nvidia_smi=nvidia_smi())
    del model


def phase_train_ddp(rows: list[dict]) -> None:
    """Data-parallel training at the flagship width (256x320, D = 64,
    ResNet-50, 5-frame windows, batch 1 per rank, EST on, random weights
    from seed 0, synthetic windows): (a) one NCCL rank through the tool in
    float32 and bf16, (b) two gloo ranks on the one card."""
    f32_stats = _ddp_one_rank(rows, "float32")
    _ddp_one_rank(rows, "bfloat16", f32_stats)
    _ddp_two_ranks()


def _spatial_inputs(dev):
    """The pitched full-width stream of phase_spatial_shard on `dev`:
    imgs [1, F, H, W, 3], poses [1, F, 4, 4], intr [1, 3, 3]."""
    frames = _pitched_frames(SPATIAL_FRAMES, full_width=True)
    return (torch.from_numpy(np.stack([f["img"] for f in frames]))[None]
            .to(dev), torch.from_numpy(np.stack(
                [f["cam_pose"] for f in frames]))[None].to(dev),
            torch.from_numpy(frames[0]["cam_intr"])[None].to(dev))


def spatial_rank(rank: int, port: int, out: str) -> None:
    """One of the two ranks of phase_spatial_shard on the one card over
    gloo: make_spatial_window_fn over this rank's 160 columns, in turns
    with the unsharded model on rank 0 (rank 1 waits at a barrier, so a
    sharded turn starts on both ranks together). The ESTM stream (4
    windows of 3 frames, the first without EST, a 2-entry memory carried
    as each path's own state), a 5-frame Joint window twice, and one
    plane-mix window with the memory; then one more ESTM and one more
    Joint window with every collective timed (a device synchronize on
    each side of each, which the other turns do not pay), for the share
    of a window with a collective in flight. Writes out/rank<r>.json: per
    sharded call its ms, collectives, bytes, peak memory and kernel
    launches, and on the timed calls the collective share and each kind's
    ms per call; on rank 0 the one-device ms and the gathered maps' max
    |Δ| from the one-device maps."""
    set_fp32_numerics()
    dev = init_distributed(f"localhost:{port}", SPATIAL_RANKS, rank,
                           device="cuda:0", backend="gloo")
    mesh = create_mesh(device=dev)
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50), seed=0).to(dev)
    imgs, poses, intr = _spatial_inputs(dev)
    shards = WidthShards(mesh, WIDTH)
    mine = shards.shard_width(imgs, 3)
    fns = {False: make_spatial_window_fn(model, mesh),
           True: make_spatial_window_fn(model, mesh, with_memory=True)}
    res = {"calls": [], "one_device_ms": [], "errors": {}}

    def sharded(path, frames, memory, timed=False):
        fn = fns[memory is not None]
        fn.stats.reset()
        fn.stats.timed = timed
        torch.distributed.barrier()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, state = fn(mine[:, frames], poses[:, frames], intr,
                         *([memory] if memory is not None else []))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        call = {"path": path, "ms": 1e3 * (t1 - t0),
                "collectives": dict(fn.stats.calls),
                "bytes": dict(fn.stats.bytes),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": _read_counts()}
        if timed:
            spans = fn.stats.spans
            call["collective_share"] = _union_share(
                [(a, b) for _, a, b in spans], t0, t1)
            call["ms_per_call"] = {
                kind: 1e3 * sum(b - a for k, a, b in spans if k == kind) / n
                for kind, n in fn.stats.calls.items()}
        res["calls"].append(call)
        return ({k: shards.gather_width(v, -1) for k, v in outs.items()},
                state)

    def one_device(frames, memory):
        torch.distributed.barrier()
        if rank != 0:
            return None, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs, state = model(imgs[:, frames], poses[:, frames], intr,
                                memory=memory, use_est=memory is not None)
        torch.cuda.synchronize()
        res["one_device_ms"].append(1e3 * (time.perf_counter() - t0))
        return outs, state

    def compare(name, got, want):
        if rank == 0:
            res["errors"].setdefault(name, []).append(max(
                float((got[k].float() - want[k].float()).abs().max())
                for k in want))

    # the ESTM stream: one-device first in even windows, sharded in odd
    w4 = mine.shape[3] // 4
    memories = {"sharded": ESTMemory.create(1, MEMORY, NDEPTHS, HEIGHT // 4,
                                            w4, device=dev),
                "one": ESTMemory.create(1, MEMORY, NDEPTHS, HEIGHT // 4,
                                        WIDTH // 4, device=dev)}
    for i in range(SPATIAL_FRAMES - LWINDOW + 1):
        frames = list(range(i, i + LWINDOW))
        use = {k: (m if i > 0 else None) for k, m in memories.items()}
        turns = ["one", "sharded"] if i % 2 == 0 else ["sharded", "one"]
        outs = {}
        for turn in turns:
            if turn == "sharded":
                outs[turn], state = sharded("spatial_estm", frames,
                                            use[turn])
            else:
                outs[turn], state = one_device(frames, use[turn])
            if state is not None:
                memories[turn] = memories[turn].push(*state)
        compare("estm", outs["sharded"], outs["one"])
    # one 5-frame Joint window without memory: one, sharded, sharded, one
    joint = list(range(SEQ_LENGTH))
    for turn in ("one", "sharded", "sharded", "one"):
        if turn == "sharded":
            got, _ = sharded("spatial_joint", joint, None)
        else:
            want, _ = one_device(joint, None)
    compare("joint", got, want)
    # the timed turns: one steady ESTM window with the memory, one Joint
    sharded("spatial_estm_timed", list(range(2, 2 + LWINDOW)),
            memories["sharded"], timed=True)
    sharded("spatial_joint_timed", joint, None, timed=True)
    # the plane-mix frustum warp (kernel 4) with each path's memory
    last = list(range(SPATIAL_FRAMES - LWINDOW, SPATIAL_FRAMES))
    model.CostRegNet.frustum_mode = "plane_mix"
    got, _ = sharded("spatial_plane_mix", last, memories["sharded"])
    want, _ = one_device(last, memories["one"])
    compare("plane_mix", got, want)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    shutdown()


def _spatial_kernel_windows() -> dict:
    """Kernels 1, 2 and 4 at each rank's output columns of the ESTM step's
    shapes, both instances: `torch.equal` to the whole launch's columns
    and to the plain version on the same window coordinates."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    poses, k4, dv = _scene_geometry(dev)
    h, w, d = HEIGHT // 4, WIDTH // 4, NDEPTHS
    proj = geometry.camera_projection(k4.expand(len(poses), 3, 3), poses)
    src = torch.randn(2, h, w, CHANNELS, generator=gen).to(dev)
    sx, sy = warp.plane_sweep_coords(proj[[0, 2]], proj[[1, 1]],
                                     dv.expand(2, d), h, w)
    vol, zi, x, y, z, dint = _frustum_inputs(gen, poses, k4, dv, [1, 0], 2)
    equal = {}
    for dtype in (torch.float32, torch.bfloat16):
        s, v = src.to(dtype), vol.to(dtype)
        cases = {
            "plane_sweep_warp": (
                lambda q: plane_warp.plane_sweep_sample(s, *q),
                lambda q: plane_warp.plane_sweep_sample_plain(s, *q),
                (sx, sy)),
            "frustum_warp_exact_z": (
                lambda q: plane_warp_exact_z.exact_z_resample(
                    v, zi, *q, DEPTH_MIN, dint),
                lambda q: resample_exact_z(v, zi, *q, DEPTH_MIN, dint),
                (x, y, z)),
            "frustum_warp_plane_mix": (
                lambda q: plane_mix.plane_mix_resample(v, zi, *q),
                lambda q: plane_mix.plane_mix_resample_plain(v, zi, *q),
                (x, y))}
        for name, (run, plain, coords) in cases.items():
            whole = run(coords)
            for r, bounds in enumerate(shard_bounds(WIDTH, SPATIAL_RANKS)):
                lo, hi = (c // 4 for c in bounds)
                window = [q.reshape(2, d, h, w)[..., lo:hi].contiguous()
                          for q in coords]
                got = run(window)
                key = f"{name}_{str(dtype)[6:]}_rank{r}"
                equal[key] = {"whole": torch.equal(got, whole[..., lo:hi, :]),
                              "plain": torch.equal(got, plain(window))}
    if not all(all(v.values()) for v in equal.values()):
        raise AssertionError(f"kernels at a rank's window: {equal}")
    return equal


def phase_spatial_shard(rows: list[dict]) -> None:
    """The width-sharded forward (parallel/spatial.make_spatial_window_fn)
    at the flagship width (256x320, D = 64, ResNet-50, float32 with TF32
    off, random weights from seed 0, EST on) on two gloo ranks on the one
    card, each a process of this script (`--spatial-rank R --port P --out
    DIR`), 160 columns each, in turns with the one-device model: the ESTM
    stream (6 frames: 4 windows, a 2-entry memory carried as each rank's
    K/V columns), one 5-frame Joint window without memory, one plane-mix
    window. The gathered maps (4 depth scales and both probabilities)
    within SPATIAL_TOL of the one-device maps; kernels 1, 2 and 4 at each
    rank's output window `torch.equal` to the whole launch's columns and
    to their plain versions on the window's coordinates, both instances.
    Launches of both ranks count under the `spatial_*` paths; ms per
    window come from untimed turns, the collective share from one timed
    ESTM and one timed Joint window."""
    t_phase = time.perf_counter()
    windows_equal = _spatial_kernel_windows()
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--spatial-rank",
             str(r), "--port", str(port), "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(SPATIAL_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=SPATIAL_RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"spatial rank {r} exited "
                                     f"{p.returncode}:\n{text[-3000:]}")
        ranks = []
        for r in range(SPATIAL_RANKS):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    errors = ranks[0]["errors"]
    worst = max(max(v) for v in errors.values())
    if not worst <= SPATIAL_TOL:
        raise AssertionError(f"sharded vs one-device maps: {errors}")
    # per rank: kernel 1 once per window, kernel 2 once per EST window of
    # the stream, kernel 4 once in the plane-mix window
    windows = SPATIAL_FRAMES - LWINDOW + 1
    expected = {"spatial_estm": {"plane_sweep_warp": windows,
                                 "frustum_warp_exact_z": windows - 1},
                "spatial_joint": {"plane_sweep_warp": 2},
                "spatial_plane_mix": {"plane_sweep_warp": 1,
                                      "frustum_warp_plane_mix": 1}}
    launches = {}
    for path, want in expected.items():
        per_rank = [{k: sum(c["launches"][k] for c in r["calls"]
                            if c["path"] == path) for k in KERNELS}
                    for r in ranks]
        if any(got != {**dict.fromkeys(KERNELS, 0), **want}
               for got in per_rank):
            raise AssertionError(f"{path} launches {per_rank}")
        launches[path] = {k: sum(got[k] for got in per_rank)
                          for k in KERNELS}
    for row in rows:
        for path, counts in launches.items():
            row["launches_by_path"][path] = counts[row["name"]]
    # each sharded call on both ranks; ms of the slower rank
    pairs = list(zip(*(r["calls"] for r in ranks)))
    ms = {path: [max(c["ms"] for c in pair) for pair in pairs
                 if pair[0]["path"] == path] for path in expected}
    one = ranks[0]["one_device_ms"]  # stream, Joint twice, plane-mix
    steady = slice(2, windows)  # EST on, after the first EST window
    last = {pair[0]["path"]: pair[0] for pair in pairs}  # rank 0's
    # the timed turns (every collective synchronized on each side)
    timed = {path: [pair for pair in pairs if pair[0]["path"] == path][0]
             for path in ("spatial_estm_timed", "spatial_joint_timed")}
    log("spatial_shard", ranks=SPATIAL_RANKS, backend="gloo",
        columns=[hi - lo for lo, hi in shard_bounds(WIDTH, SPATIAL_RANKS)],
        estm_ms_per_window_sharded=statistics.median(
            ms["spatial_estm"][steady]),
        estm_ms_per_window_one_device=statistics.median(
            one[:windows][steady]),
        estm_ms_sharded=ms["spatial_estm"], estm_ms_one_device=one[:windows],
        joint_ms_sharded=ms["spatial_joint"],
        joint_ms_one_device=one[windows:windows + 2],
        plane_mix_ms_sharded=ms["spatial_plane_mix"],
        plane_mix_ms_one_device=one[-1:],
        collectives_per_window={p: last[p]["collectives"] for p in expected},
        bytes_per_window={p: last[p]["bytes"] for p in expected},
        collective_share={p: [c["collective_share"] for c in pair]
                          for p, pair in timed.items()},
        collective_ms_per_call={p: [c["ms_per_call"] for c in pair]
                                for p, pair in timed.items()},
        timed_ms={p: max(c["ms"] for c in pair) for p, pair in timed.items()},
        max_memory_allocated=[max(c["max_memory_allocated"]
                                  for c in r["calls"]) for r in ranks],
        max_abs_err=errors, tol=SPATIAL_TOL, launches=launches,
        kernels_at_rank_windows_equal=windows_equal,
        phase_s=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi())


# The SENet model (phase_senet_path) and --scene-batch (phase_scene_batch)
SENET_TRAIN_STEPS = 3  # the first warms up
# phase_scene_batch: the frames of the five ScanNet-layout scenes both eval
# tools read (frame interval 1; ESTM: 5, 10, 6, 4 and 7 windows, Joint: 1,
# 3, 1, 1 and 2), written at 240x320 with ScanNet's focal halved and
# resized to 256x320 by the tools
SCAN_SCENE_FRAMES = (7, 12, 8, 6, 9)
SCENE_BATCH, SCENE_BATCH_TOL = 4, 1e-3
PROCESSOR_SPAN = "chip_smoke.processor"  # the scan processors' calls


def _senet_small() -> dict:
    """(a) of phase_senet_path: the SENet model at the small size on the
    card against the CPU: a 5-window ESTM stream and a 3-window Joint
    chain in float32 within 8e-3, and the bf16 stream within twice the
    card's own bf16-against-float32 distance (the bf16 rule)."""
    windows = 3
    frames = _pitched_frames((windows - 1) * (SEQ_LENGTH - 2) + SEQ_LENGTH)
    out = {}

    def model(dtype="float32"):
        return DepthNetHybrid(ModelConfig(
            ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
            feature_net="senet", compute_dtype=dtype), seed=0)

    streams = {(dtype, dev): _stream(model(dtype), frames[:7], dev)
               for dtype, dev in (("float32", "cpu"), ("float32", "cuda"),
                                  ("bfloat16", "cuda"),
                                  ("bfloat16", "cpu"))}
    out["estm_max_abs_err"] = _max_err(streams["float32", "cpu"],
                                       streams["float32", "cuda"])
    joint = {dev: _joint_chain(model(), frames, dev, windows)
             for dev in ("cpu", "cuda")}
    out["joint_max_abs_err"] = _max_err(joint["cpu"], joint["cuda"])
    own = _max_err(streams["bfloat16", "cuda"], streams["float32", "cuda"])
    out["bf16_max_abs_err"] = _max_err(streams["bfloat16", "cuda"],
                                       streams["bfloat16", "cpu"])
    out["bf16_against_f32"] = own
    if not (len(streams["float32", "cuda"]) == 5
            and out["estm_max_abs_err"] < 8e-3
            and out["joint_max_abs_err"] < 8e-3
            and out["bf16_max_abs_err"] <= 2 * own):
        raise AssertionError(f"SENet model, card vs CPU: {out}")
    return out


def _senet_full_width(rows: list[dict]) -> dict:
    """(b) of phase_senet_path: the ESTM stream and the Joint chain at the
    flagship width, the SENet and the PSM model in turns (psm, senet,
    senet, psm) in each dtype: ms per frame and window, peak memory, and
    the kernel launches, which must be the PSM model's."""
    steps = FRAMES - LWINDOW + 1
    frames = list(synthetic_stream(SyntheticSceneConfig(
        height=HEIGHT, width=WIDTH, seed=0), FRAMES, DEPTH_MIN, DEPTH_MAX))
    cfg = SyntheticSceneConfig(height=HEIGHT, width=WIDTH)
    stride = SEQ_LENGTH - 2
    samples = [synthetic_window(cfg, SEQ_LENGTH, wi * stride, DEPTH_MIN,
                                DEPTH_MAX) for wi in range(JOINT_WINDOWS)]
    fused = (JOINT_WINDOWS - 1) * stride
    expected = {"estm": {"plane_sweep_warp": steps,
                         "frustum_warp_exact_z": steps - 1},
                "joint": {"plane_sweep_warp": JOINT_WINDOWS,
                          "frustum_warp_exact_z": fused}}

    def estm(model):
        runner = ESTMRunner(model, HEIGHT, WIDTH, LWINDOW, MEMORY,
                            output_scales=SERVING_SCALES, device="cuda")
        times, maps, _ = eval_estm.stream_scene(runner, frames, LWINDOW)
        return times, np.stack(maps)

    def joint(model):
        runner = eval_joint.JointRunner(model, device="cuda")
        times, maps = [], []
        for s in samples:
            t0 = time.perf_counter()
            depth, _ = runner.run_window(s["imgs"], s["cam_poses"],
                                         s["cam_intr"])
            maps.append(depth[0][:, list(SERVING_SCALES)].cpu().numpy())
            times.append(time.perf_counter() - t0)
        return times, np.stack(maps)

    out = {}
    for dtype in ("float32", "bfloat16"):
        suffix = "" if dtype == "float32" else "_bf16"
        models = {net: DepthNetHybrid(ModelConfig(
            ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
            resnet=50, feature_net=net, compute_dtype=dtype), seed=0)
            for net in ("psm", "senet")}
        for protocol, run, shape in (
                ("estm", estm, (steps, 2, HEIGHT, WIDTH)),
                ("joint", joint, (JOINT_WINDOWS, stride, 2, HEIGHT,
                                  WIDTH))):
            ms = {"psm": [], "senet": []}
            info = {}
            for net in ("psm", "senet", "senet", "psm"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                times, maps = run(models[net])
                path = f"senet_{protocol}{suffix}"
                launches, bf16 = _launched(path, dtype, expected[protocol])
                ms[net].append(1e3 * statistics.median(times[2:]))
                if net not in info:
                    info[net] = {
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(),
                        "depth_range": _check_depths(path, maps, shape),
                        "launches": launches}
                    if net == "senet":
                        for row in rows:
                            row["launches_by_path"][path] = launches[
                                row["name"]]
                            if dtype == "bfloat16":
                                row["bf16"]["launches_by_path"][path] = bf16[
                                    row["name"]]
            med = {k: statistics.median(v) for k, v in ms.items()}
            out[f"{protocol}{suffix}"] = {
                "ms_senet": med["senet"], "ms_psm": med["psm"],
                "ratio_senet_to_psm": med["senet"] / med["psm"],
                "ms_runs": ms, **info}
        del models
    return out


def _senet_train() -> dict:
    """(c) of phase_senet_path: 3 training steps of the SENet model at the
    flagship width (5-frame windows, batch 1, EST on; the trainer's step,
    float32): finite losses, ms per step after the first, peak memory and
    the launches per step (one sweep, one exact-z warp per target)."""
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50, feature_net="senet"), seed=0).cuda()
    optimizer, scheduler = make_optimizer(
        model.named_parameters(),
        warmup_multistep_schedule(4e-5, steps_per_epoch=10**6))
    step = make_train_step(model, optimizer, scheduler, DEPTH_MIN, DEPTH_MAX)
    cfg = SyntheticSceneConfig(height=HEIGHT, width=WIDTH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, losses = [], []
    for i in range(SENET_TRAIN_STEPS):
        window = synthetic_window(cfg, TRAIN_FRAMES, 2 * i, DEPTH_MIN,
                                  DEPTH_MAX)
        batch = {k: torch.from_numpy(v).cuda() for k, v in window.items()}
        t0 = time.perf_counter()
        losses.append(float(step(batch, 10.0)["loss"]))  # waits
        times.append(time.perf_counter() - t0)
    launches, _ = _launched("senet_train", "float32", {
        "plane_sweep_warp": SENET_TRAIN_STEPS,
        "frustum_warp_exact_z": (TRAIN_FRAMES - 2) * SENET_TRAIN_STEPS})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"senet_train: losses {losses}")
    return {"steps": SENET_TRAIN_STEPS, "losses": losses,
            "times_ms": [1e3 * t for t in times],
            "ms_per_step": 1e3 * statistics.median(times[1:]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches}


def phase_senet_path(rows: list[dict]) -> None:
    """The SENet model (ModelConfig.feature_net="senet": SEFeatureNet as
    the matching encoder), random weights from seed 0: (a) at the small
    size on the card against the CPU, (b) the ESTM stream and the Joint
    chain at the flagship width in turns with the PSM model, float32 and
    bf16, (c) 3 training steps at the flagship width. Every kernel's count
    is set to 0 just before each run of (b) and (c) and read just after."""
    start = time.perf_counter()
    small = _senet_small()
    full = _senet_full_width(rows)
    train = _senet_train()
    for row in rows:
        row["launches_by_path"]["senet_train"] = train["launches"][
            row["name"]]
    log("senet_path", small=small, full_width=full, train=train,
        seconds=time.perf_counter() - start, nvidia_smi=nvidia_smi())
    torch.cuda.empty_cache()


def _write_scenes(root: str) -> None:
    """phase_scene_batch's ScanNet-layout scenes: seeded textures, frame
    counts SCAN_SCENE_FRAMES, 240x320 with ScanNet's focal halved."""
    for seed, n in enumerate(SCAN_SCENE_FRAMES):
        cfg = SyntheticSceneConfig(height=240, width=320, focal=288.935,
                                   seed=seed)
        write_scannet_scene(os.path.join(root, f"scene{seed:04d}_00"), cfg,
                            [pose(cfg, i) for i in range(n)])


@contextlib.contextmanager
def _processor_spans():
    """Each call of the eval tools' scan processors
    (SequenceProcessor.process_scenes, the callable that
    eval_joint.make_joint_processor returns) inside
    record_function(PROCESSOR_SPAN), closed after a synchronize, so every
    device op a call launches ends inside its span."""
    from torch.profiler import record_function

    def spanned(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(PROCESSOR_SPAN):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return call

    method = eval_estm.SequenceProcessor.process_scenes
    factory = eval_joint.make_joint_processor
    eval_estm.SequenceProcessor.process_scenes = spanned(method)
    eval_joint.make_joint_processor = (
        lambda *args, **kwargs: spanned(factory(*args, **kwargs)))
    try:
        yield
    finally:
        eval_estm.SequenceProcessor.process_scenes = method
        eval_joint.make_joint_processor = factory


def _idle_share(prof) -> dict:
    """The device's idle share inside the processor calls of one profiled
    tool run (_processor_spans): 1 - (time in which a kernel, copy or fill
    ran on the card within the PROCESSOR_SPAN ranges) / (the ranges'
    length). Device intervals are merged before they are summed, so
    overlapping streams count once. Read from the profiler's raw events
    (no event tree is built). The profiler slows the host, so the share
    is an upper bound."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.name() == PROCESSOR_SPAN and e.device_type() == cpu]
    merged = []
    for lo, hi in sorted((e.start_ns(), e.end_ns()) for e in events
                         if e.device_type() == cuda
                         and not e.is_user_annotation()):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    span_ns = sum(hi - lo for lo, hi in spans)
    busy_ns = sum(max(0, min(hi, b) - max(lo, a))
                  for a, b in spans for lo, hi in merged)
    if not (spans and 0 < busy_ns <= span_ns):
        raise AssertionError(f"profile: {len(spans)} processor spans of "
                             f"{span_ns} ns, {busy_ns} ns busy")
    return {"idle_share": 1.0 - busy_ns / span_ns,
            "processor_s": span_ns / 1e9, "device_busy_s": busy_ns / 1e9}


@contextlib.contextmanager
def _first_inputs(store: dict, *names: str):
    """The arguments of the first call of each of ops/warp.py's kernel
    wrappers `names`, kept cloned in store[name]; the calls go through."""
    wrappers = {name: getattr(warp, name) for name in names}

    def recorder(name):
        def record(*args):
            if name not in store:
                store[name] = [a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args]
            return wrappers[name](*args)
        return record

    for name in names:
        setattr(warp, name, recorder(name))
    try:
        yield
    finally:
        for name, wrapper in wrappers.items():
            setattr(warp, name, wrapper)


def _batch4_kernels_equal_plain(inputs: dict) -> dict:
    """Kernels 1 and 2 against their plain versions on the inputs of the
    first window of a batch-4 group: torch.equal."""
    src, x, y = inputs["plane_sweep_sample"]
    vol, *coords = inputs["exact_z_resample"]
    pairs = {"plane_sweep_warp": (
                 lambda: plane_warp.plane_sweep_sample(src, x, y),
                 lambda: plane_warp.plane_sweep_sample_plain(src, x, y)),
             "frustum_warp_exact_z": (
                 lambda: plane_warp_exact_z.exact_z_resample(vol, *coords),
                 lambda: resample_exact_z(vol, *coords))}
    out = {}
    for name, (kern, plain) in pairs.items():
        got = kern()
        if not torch.equal(got, plain()):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version at the batch-4 shape")
        out[name] = {"shape": list(got.shape), "dtype": str(got.dtype),
                     "bit_equal": True}
    return out


def phase_scene_batch(rows: list[dict]) -> None:
    """`--scan --scene-batch` on both eval tools at the flagship width
    (256x320, D = 64, ResNet-50, random weights from seed 0) over five
    ScanNet-layout scenes of unequal lengths (--datapath): (a)
    eval_estm.run, (b) eval_joint.run, each at --scene-batch 1 and 4 (a
    group of four and a partial group of one) in turns (1, 4, 4, 1),
    float32 and bf16; the last two turns run under torch.profiler for the
    device's idle share inside the processor calls. Checks: the batch-4
    maps against the batch-1 maps within 1e-3 (bf16: within twice their
    batch-1 maps' distance from float32's); one scene's scan maps against
    an ESTMRunner / JointRunner on the frames the tool read, within 1e-3;
    launches of a group equal to one scene's (the batch folds into each
    launch); kernels 1 and 2 bit-equal to their plain versions on the
    batch-4 inputs of one window. Reports frames (targets) per second
    inside the processor calls from the two turns without the profiler,
    and peak memory. Every kernel's count is set to 0 just before each
    tool run and read just after."""
    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scenes_") as root:
        _write_scenes(root)
        common = ["--datapath", root, "--frame-interval", "1",
                  "--height", str(HEIGHT), "--width", str(WIDTH),
                  "--ndepths", str(NDEPTHS), "--depth-min", str(DEPTH_MIN),
                  "--depth-max", str(DEPTH_MAX), "--resnet", "50", "--scan",
                  "--device", "cuda", "--seed", "0"]

        def tool_run(tool):
            def run(batch, dtype):
                args = tool.parse_args(common + [
                    "--scene-batch", str(batch),
                    *(["--bf16"] if dtype == "bfloat16" else [])])
                return tool.run(args, keep_maps=True)
            return run

        stride = SEQ_LENGTH - 2
        estm_windows = [n - LWINDOW + 1 for n in SCAN_SCENE_FRAMES]
        joint_windows = [len(range(0, n - SEQ_LENGTH, stride))
                         for n in SCAN_SCENE_FRAMES]

        def groups(counts, batch):
            return [max(counts[i:i + batch])
                    for i in range(0, len(counts), batch)]

        def estm_expected(batch):  # one launch per window step of a group
            w = groups(estm_windows, batch)
            return {"plane_sweep_warp": sum(w),
                    "frustum_warp_exact_z": sum(n - 1 for n in w)}

        def joint_expected(batch):  # EST: one warp per target
            w = groups(joint_windows, batch)
            return {"plane_sweep_warp": sum(w),
                    "frustum_warp_exact_z": sum((n - 1) * stride
                                                for n in w)}

        out = {"scene_frames": list(SCAN_SCENE_FRAMES)}
        f32_maps = {}  # each protocol's float32 batch-1 maps
        for protocol, run, expected, units in (
                ("estm", tool_run(eval_estm), estm_expected,
                 sum(estm_windows)),
                ("joint", tool_run(eval_joint), joint_expected,
                 stride * sum(joint_windows))):
            for dtype in ("float32", "bfloat16"):
                suffix = "" if dtype == "float32" else "_bf16"
                runs = {1: [], SCENE_BATCH: []}
                first, inputs, idle = {}, {}, {}
                for turn, batch in enumerate((1, SCENE_BATCH, SCENE_BATCH,
                                              1)):
                    path = (f"scan_{protocol}{suffix}" if batch == 1 else
                            f"scene_batch_{protocol}{suffix}")
                    profiled = turn >= 2
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    _reset_counts()
                    capture = (_first_inputs(inputs, "plane_sweep_sample",
                                             "exact_z_resample")
                               if turn == 1 else contextlib.nullcontext())
                    prof = (profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                            if profiled else contextlib.nullcontext())
                    t0 = time.perf_counter()
                    with capture, prof, (_processor_spans() if profiled
                                         else contextlib.nullcontext()):
                        res = run(batch, dtype)
                    wall = time.perf_counter() - t0
                    launches, bf16 = _launched(path, dtype, expected(batch))
                    if profiled:
                        idle[batch] = {**_idle_share(prof),
                                       "per_s": units / sum(res["times"])}
                        continue
                    runs[batch].append(units / sum(res["times"]))
                    first[batch] = {
                        "maps": np.stack(res["maps"]),
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(),
                        "wall_s": wall, "launches": launches}
                    for row in rows:
                        row["launches_by_path"][path] = launches[row["name"]]
                        if dtype == "bfloat16":
                            row["bf16"]["launches_by_path"][path] = bf16[
                                row["name"]]
                one, four = first[1].pop("maps"), first[SCENE_BATCH].pop(
                    "maps")
                err = float(np.abs(four - one).max())
                # float32: 1e-3; bf16: twice the bf16 maps' own distance
                # from the float32 ones (bf16 rounds at other places
                # when cuDNN picks another algorithm at another batch)
                if dtype == "float32":
                    f32_maps[protocol] = one
                tol = (SCENE_BATCH_TOL if dtype == "float32" else
                       2 * float(np.abs(one - f32_maps[protocol]).max()))
                if not (len(one) == len(four) and err <= tol):
                    raise AssertionError(f"{protocol}{suffix}: scene batch "
                                         f"4 vs 1 max abs err {err} > {tol}")
                entry = {
                    "per_s_batch1": runs[1][0],
                    "per_s_batch4": runs[SCENE_BATCH][0],
                    "speedup_batch4": runs[SCENE_BATCH][0] / runs[1][0],
                    "batch4_vs_batch1_max_abs_err": err,
                    "batch4_vs_batch1_tol": tol,
                    "batch1": first[1], "batch4": first[SCENE_BATCH],
                    "kernels_at_batch4": _batch4_kernels_equal_plain(inputs),
                    "idle_share_batch1": idle[1]["idle_share"],
                    "idle_share_batch4": idle[SCENE_BATCH]["idle_share"],
                    "profiled": idle}
                if dtype == "float32":
                    entry["against_runner_max_abs_err"] = (
                        _scan_against_runner(protocol, four, common))
                out[f"{protocol}{suffix}"] = entry
        log("scene_batch", unit_per_s={"estm": "frames", "joint": "targets"},
            **out, seconds=time.perf_counter() - start,
            nvidia_smi=nvidia_smi())
    torch.cuda.empty_cache()


def _scan_against_runner(protocol: str, maps: np.ndarray,
                         common: list) -> float:
    """The batch-4 scan maps of the first scene against a runner streaming
    the frames the tool read for it (the same seed-0 model): max |Δ|,
    within 1e-3."""
    args = eval_estm.parse_args(common)
    model = DepthNetHybrid(ModelConfig(
        ndepths=NDEPTHS, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
        resnet=50), seed=0)
    if protocol == "estm":
        _, frames = next(eval_estm.scenes(args))
        runner = ESTMRunner(model, HEIGHT, WIDTH, LWINDOW, MEMORY,
                            output_scales=SERVING_SCALES, device="cuda")
        ref = np.stack([out[0].cpu().numpy() for f in frames if (
            out := runner.push_frame(f["img"], f["cam_pose"],
                                     f["cam_intr"])) is not None])
    else:
        wds = WindowEvalDataset(args.datapath, HEIGHT, WIDTH,
                                seq_length=SEQ_LENGTH, frame_interval=1,
                                scannet_layout=True)
        wds.reset("scene0000_00")
        runner = eval_joint.JointRunner(model, device="cuda")
        ref = np.stack([runner.run_window(
            wds[i]["imgs"], wds[i]["cam_poses"], wds[i]["cam_intr"])[0][0][
                :, list(SERVING_SCALES)].cpu().numpy()
            for i in range(len(wds))])
    got = maps[:len(ref)]
    err = float(np.abs(got - ref).max())
    if not (got.shape == ref.shape and err <= SCENE_BATCH_TOL):
        raise AssertionError(f"{protocol}: scan maps vs runner {err}")
    return err


def main() -> None:
    dev_info = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_gradients(rows)
    phase_geometry()
    phase_reference()
    phase_reference_joint()
    phase_reference_train()
    phase_reference_bf16()
    main_ms = phase_main_path(rows)
    phase_joint_path(rows)
    phase_serving(rows)
    phase_bf16_paths(rows)
    phase_senet_path(rows)
    phase_scene_batch(rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        train_ckpt = os.path.join(tmp, "ckpt")
        train_ms = phase_train_path(rows, train_ckpt)
        phase_dataset_path(rows, main_ms)
        phase_train_dataset(rows, train_ms["train"])
        phase_release(rows, train_ckpt)
    phase_train_ddp(rows)
    phase_spatial_shard(rows)
    for row in rows:  # every kernel ran on a main path, in both dtypes
        row["op"] = OPS[row["name"]]
        row["launches"] = sum(row["launches_by_path"].values())
        row["bf16"]["launches"] = sum(
            row["bf16"]["launches_by_path"].values())
        if not (row["launches"] > 0 and row["bf16"]["launches"] > 0):
            raise AssertionError(f"{row['name']}: never launched on a main "
                                 f"path ({row['launches']}, bf16 "
                                 f"{row['bf16']['launches']})")
    print(json.dumps({"kernels": rows}))
    print(dev_info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1:  # one rank of phase_train_ddp's case (b), or of
        # phase_spatial_shard
        flags = argparse.ArgumentParser()
        flags.add_argument("--ddp-rank", type=int)
        flags.add_argument("--spatial-rank", type=int)
        flags.add_argument("--port", type=int, required=True)
        flags.add_argument("--out", required=True)
        a = flags.parse_args()
        if a.ddp_rank is not None:
            ddp_rank(a.ddp_rank, a.port, a.out)
        else:
            spatial_rank(a.spatial_rank, a.port, a.out)
    else:
        main()
