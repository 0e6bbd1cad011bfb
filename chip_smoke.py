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
random weights from a seed) through the kernels: the ESTM streaming step
(lwindow 3, memory 2), the Joint window chain (5 frames in, 3 depth maps
out, a 1-entry memory; once with the default warp and once with the
plane-mix warp and the attention kernel), and the training step of
tools/train.py (5-frame windows, batch 1, EST on; once with the default
plane sweep and once through the fused two-pass resample). Last, the
dataset path: a scene written in ScanNet's layout (640x480 PNGs, one
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
ResNet-101. Every phase prints one line; any failure raises and exits
non-zero. The last line is {"ok": true, "device": {...}}.

A kernel's time is device ms per call, from runs of 20 back-to-back calls
queued while the device is held busy, one CUDA event pair per run; where a
PyTorch call computes the same memory work (F.grid_sample,
scaled_dot_product_attention) the kernel and that call are timed in turns.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from estdepth_tpu_torch.config import ModelConfig, set_fp32_numerics
from estdepth_tpu_torch.data import io_utils, native
from estdepth_tpu_torch.data.eval_stream import StreamEvalDataset
from estdepth_tpu_torch.data.eval_windows import WindowEvalDataset
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, intrinsics, pose, render, synthetic_stream,
    write_scannet_scene, write_scannet_train_scene,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.resnet import ResNetEncoder
from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import (
    build, epipolar_attention, plane_mix, plane_warp, plane_warp_exact_z,
    two_pass,
)
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field
from estdepth_tpu_torch.tools import eval_estm, eval_joint, score_offline
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.tools.eval_estm import run_synthetic
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step
from estdepth_tpu_torch.utils import viz
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
WINDOW_SWEEPS = ([0, 2, 1, 3, 2, 4], [1, 1, 2, 2, 3, 3])  # (src, ref) frames
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


def turns_ms(kern, library, launches: int = LAUNCHES,
             rounds: int = 5) -> tuple[float, float]:
    """Device ms per call of kern() and of library(), timed in turns in
    runs of `launches` calls (kernel, library, library, kernel in every
    round) so that both see the same clocks: the medians of each."""
    host = {fn: _host_ms(fn, launches) for fn in (kern, library)}
    times = {kern: [], library: []}
    for _ in range(rounds):
        for fn in (kern, library, library, kern):
            times[fn].append(_batch(fn, launches, host[fn]))
    return statistics.median(times[kern]), statistics.median(times[library])


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


def _measure(name: str, kern, plain, moved: int, flops: float,
             library=None, exact: bool = False) -> dict:
    """kern() against plain() under REL_TOL (with `exact`, bit for bit),
    both timed, kern() in turns with `library()` where one is given, and
    the bound of `moved` bytes and `flops` float32 operations with the
    rate and the share of it that the kernel reached."""
    out_k, out_p = kern(), plain()
    m = {"shape": list(out_k.shape), **_compare(name, out_k, out_p)}
    if exact:
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version at {m['shape']}")
        m["bit_equal"] = True
    del out_k, out_p
    if library is None:
        m["ms"], m["library_ms"] = batch_ms(kern), None
    else:
        m["ms"], m["library_ms"] = turns_ms(kern, library)
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
    return _measure(
        "plane_sweep_warp",
        lambda: plane_warp.plane_sweep_sample(src, x, y),
        lambda: plane_warp.plane_sweep_sample_plain(src, x, y),
        nbytes(src, x, y) + 4 * out_numel, out_numel * 9 + voxels * 20,
        library=_grid_sample(src, x, y), exact=True)


def _grid_sample(src, x, y):
    """One F.grid_sample call over the same coordinates (a softer edge
    rule than the port's hard mask): timed here, used nowhere."""
    b, h, w, _ = src.shape
    nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], -1)
    grid = grid.reshape(b, -1, w, 2)
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
    m = _measure(
        "two_pass_resample",
        lambda: two_pass.two_pass_resample(src, ab, x, y, planes_per_map),
        lambda: two_pass.two_pass_resample_plain(src, ab, x, y,
                                                 planes_per_map),
        nbytes(src, ab, x, y) + 4 * out_numel,
        out_numel * 9 + out_numel // c * 24, library=library, exact=True)
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


def _exact_z_case(gen, poses, k4, dv, neighbour_frames, target_frame) -> dict:
    """Kernel 2 on one random K/V volume per entry of neighbour_frames,
    warped into the frustum of target_frame."""
    dev = poses.device
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    dint = (DEPTH_MAX - DEPTH_MIN) / (NDEPTHS - 1)
    b = len(neighbour_frames)
    vol = torch.randn(b, d, h, w, c, generator=gen).to(dev)
    rel = torch.matmul(poses[neighbour_frames],
                       torch.linalg.inv(poses[[target_frame] * b]))
    t, grid_px, x, y, z = warp.frustum_coords(rel, k4.expand(b, 3, 3),
                                             dv.expand(b, d), h, w)
    zi = zi_field(t, k4.expand(b, 3, 3), dv.expand(b, d), DEPTH_MIN, dint,
                  grid_px)

    def plain():
        return resample_exact_z(vol, zi, x, y, z, DEPTH_MIN, dint)

    m = _measure(
        "frustum_warp_exact_z",
        lambda: plane_warp_exact_z.exact_z_resample(vol, zi, x, y, z,
                                                    DEPTH_MIN, dint),
        plain, nbytes(vol, zi, x, y, z) + nbytes(vol),
        vol.numel() * 32 + vol.numel() // c * 30)
    m["valid_share"] = (plain().abs().amax(-1) > 0).float().mean().item()
    return m


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
    rows.append({
        "name": "frustum_warp_exact_z", "route": "cuda",
        "source": "estdepth_tpu_torch/csrc/frustum_warp_exact_z.cu",
        "replaces": "estdepth_tpu/ops/pallas/plane_warp_exact_z.py:281",
        **_exact_z_case(gen, poses, k4, dv, [1, 0], 2),
        "joint": _exact_z_case(gen, poses, k4, dv, [0, 2, 3], 1)})

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
    vol = torch.randn(n, d, h, w, c, generator=gen).to(dev)
    rel = torch.matmul(poses[[0, 2, 3]], torch.linalg.inv(poses[[1, 1, 1]]))
    t, grid_px, x, y, _ = warp.frustum_coords(rel, k4.expand(n, 3, 3),
                                             dv.expand(n, d), h, w)
    zi = zi_field(t, k4.expand(n, 3, 3), dv.expand(n, d), DEPTH_MIN, dint,
                  grid_px)

    def kern():
        return plane_mix.plane_mix_resample(vol, zi, x, y)

    def plain():
        return plane_mix.plane_mix_resample_plain(vol, zi, x, y)

    warped, out_p = kern(), plain()
    row = {"name": "frustum_warp_plane_mix", "route": "cuda",
           "source": "estdepth_tpu_torch/csrc/frustum_warp_plane_mix.cu",
           "replaces": "estdepth_tpu/ops/pallas/plane_warp.py:533",
           **_compare("frustum_warp_plane_mix", warped, out_p)}
    row["ms"] = batch_ms(kern)
    row["plain_ms"] = batch_ms(plain, reps=3)
    row["library_ms"] = None
    voxels = warped.numel() // c
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(vol, zi, x, y, warped), warped.numel() * 21 + voxels * 40)
    row["valid_share"] = (out_p.abs().amax(-1) > 0).float().mean().item()
    rows.append(row)
    del vol, out_p

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
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(tk, out_k) + 2 * n * nbytes(tk), voxels * (n * 64 + n * 20))
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


def _pitched_frames(n: int):
    """Small synthetic stream with a seeded pitch and lift on the camera
    path, so that no warp coordinate sits exactly on the image border,
    where float noise would decide the hard out-of-range mask."""
    cfg = SyntheticSceneConfig(height=64, width=96, focal=80.0)
    frames = list(synthetic_stream(cfg, n, 0.5, 8.0))
    for i, f in enumerate(frames):
        a = 0.013 * i + 0.002
        rx = np.eye(4, dtype=np.float32)
        rx[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        f["cam_pose"] = (f["cam_pose"] @ rx).astype(np.float32)
        f["cam_pose"][1, 3] += 0.011 * i
    return frames


def phase_reference() -> None:
    """A small ESTM stream (ndepths 8, 64x96, ResNet-18, 5 windows) through
    the kernels on the card against the plain PyTorch path on the CPU,
    same weights: all 4 depth scales within the chain tolerance 8e-3."""
    frames = _pitched_frames(7)
    cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18)
    outs = {}
    for dev in ("cpu", "cuda"):
        runner = ESTMRunner(DepthNetHybrid(cfg, seed=0), 64, 96, device=dev)
        outs[dev] = [out.cpu() for f in frames if (out := runner.push_frame(
            f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    err = max((a - b).abs().max().item()
              for a, b in zip(outs["cpu"], outs["cuda"]))
    log("reference", windows=len(outs["cuda"]), max_abs_err=err, atol=8e-3)
    if not (len(outs["cuda"]) == 5 and err < 8e-3):
        raise AssertionError(f"card vs CPU stream: max abs err {err}")


def _reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _read_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def phase_reference_joint() -> None:
    """A small Joint chain (ndepths 8, 64x96, ResNet-18, seq_length 5, 3
    windows) on the card through the kernels against the plain PyTorch path
    on the CPU, same weights, once in the default mode (exact-z warp) and
    once with the plane-mix warp and the attention kernel: all 4 depth
    scales within the chain tolerance 8e-3."""
    windows, stride = 3, SEQ_LENGTH - 2
    frames = _pitched_frames((windows - 1) * stride + SEQ_LENGTH)
    imgs = np.stack([f["img"] for f in frames])[None]
    poses = np.stack([f["cam_pose"] for f in frames])[None]
    intr = frames[0]["cam_intr"][None]
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
        outs = {}
        for dev in ("cpu", "cuda"):
            runner = eval_joint.JointRunner(DepthNetHybrid(cfg, seed=0),
                                            device=dev)
            outs[dev] = [runner.run_window(
                imgs[:, wi * stride:wi * stride + SEQ_LENGTH],
                poses[:, wi * stride:wi * stride + SEQ_LENGTH],
                intr)[0].cpu() for wi in range(windows)]
        launched = {name: n - counts[name]
                    for name, n in _read_counts().items()}
        err = max((a - b).abs().max().item()
                  for a, b in zip(outs["cpu"], outs["cuda"]))
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


def phase_train_path(rows: list[dict]) -> dict:
    """The training step at the flagship width through tools/train.py's own
    loop (`run`): 256x320, D = 64, ResNet-50, 5-frame windows, batch 1, EST
    on, 1 warm-up step and 3 timed ones, once with the default plane sweep
    (kernel 1) and once through the two-pass resample (kernel 3). Every
    kernel's count is set to 0 just before each run and read just after.
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


def main() -> None:
    dev_info = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_gradients(rows)
    phase_geometry()
    phase_reference()
    phase_reference_joint()
    phase_reference_train()
    main_ms = phase_main_path(rows)
    phase_joint_path(rows)
    train_ms = phase_train_path(rows)
    phase_dataset_path(rows, main_ms)
    phase_train_dataset(rows, train_ms["train"])
    for row in rows:  # every kernel ran on a main path
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']}: never launched on a main "
                                 f"path")
    print(json.dumps({"kernels": rows}))
    print(dev_info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
