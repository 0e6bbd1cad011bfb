#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from estdepth_tpu_torch/csrc, holds each
against its plain PyTorch version at the flagship ESTM shapes, checks the
plane-sweep kernel against the analytic depth of a synthetic scene, and
drives the ESTM streaming step (256x320, D = 64, ResNet-50, lwindow 3,
memory 2, float32, random weights from a seed) through the kernels. Every
phase prints one line; any failure raises and exits non-zero. The last
line is {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from estdepth_tpu_torch.config import ModelConfig, set_fp32_numerics
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, intrinsics, pose, render, synthetic_stream,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import build, plane_warp, plane_warp_exact_z
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field
from estdepth_tpu_torch.tools.eval_estm import run_synthetic

# Flagship ESTM shapes: 256x320 frames, cost volume 64x80, D = 64 planes,
# 32 matching channels, 2 plane-sweep neighbours and 2 memory neighbours.
HEIGHT, WIDTH, NDEPTHS, CHANNELS = 256, 320, 64, 32
DEPTH_MIN, DEPTH_MAX = 0.01, 10.0
REL_TOL = 1e-5  # max |kernel - plain| / max |plain|
LWINDOW, MEMORY, FRAMES = 3, 2, 12
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


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    """Poses of frames 0..2 of the synthetic scene and K at 1/4 res."""
    cfg = SyntheticSceneConfig(height=HEIGHT, width=WIDTH)
    poses = torch.from_numpy(np.stack([pose(cfg, f) for f in range(3)]))
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


def phase_kernels() -> list[dict]:
    """Each kernel against its plain version at the flagship shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    poses, k4, dv = _scene_geometry(dev)
    h, w, c, d = HEIGHT // 4, WIDTH // 4, CHANNELS, NDEPTHS
    dint = (DEPTH_MAX - DEPTH_MIN) / (NDEPTHS - 1)
    rows = []

    # kernel 1: target frame 1 swept against neighbours 0 and 2
    src = torch.randn(2, h, w, c, generator=gen).to(dev)
    proj = geometry.camera_projection(k4.expand(3, 3, 3), poses)
    x, y = warp.plane_sweep_coords(proj[[0, 2]], proj[[1, 1]],
                                   dv.expand(2, d), h, w)
    out_k = plane_warp.plane_sweep_sample(src, x, y)
    out_p = plane_warp.plane_sweep_sample_plain(src, x, y)
    row = {"name": "plane_sweep_warp", "route": "cuda",
           "source": "estdepth_tpu_torch/csrc/plane_sweep_warp.cu",
           "replaces": "estdepth_tpu/ops/pallas/plane_warp.py:588",
           **_compare("plane_sweep_warp", out_k, out_p)}
    row["ms"] = cuda_ms(lambda: plane_warp.plane_sweep_sample(src, x, y))
    row["plain_ms"] = cuda_ms(
        lambda: plane_warp.plane_sweep_sample_plain(src, x, y), reps=10)
    nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], -1)
    grid = grid.reshape(2, d * h, w, 2)
    row["library_ms"] = cuda_ms(lambda: F.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))
    voxels = out_k.numel() // c
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(src, x, y, out_k), out_k.numel() * 9 + voxels * 20)
    rows.append(row)

    # kernel 2: target frame 2 against memory frames 1 and 0
    vol = torch.randn(2, d, h, w, c, generator=gen).to(dev)
    rel = torch.matmul(poses[[1, 0]], torch.linalg.inv(poses[[2, 2]]))
    t, grid_px, x, y, z = warp.frustum_coords(rel, k4.expand(2, 3, 3),
                                             dv.expand(2, d), h, w)
    zi = zi_field(t, k4.expand(2, 3, 3), dv.expand(2, d), DEPTH_MIN, dint,
                  grid_px)

    def kern():
        return plane_warp_exact_z.exact_z_resample(vol, zi, x, y, z,
                                                   DEPTH_MIN, dint)

    def plain():
        return resample_exact_z(vol, zi, x, y, z, DEPTH_MIN, dint)

    out_k, out_p = kern(), plain()
    row = {"name": "frustum_warp_exact_z", "route": "cuda",
           "source": "estdepth_tpu_torch/csrc/frustum_warp_exact_z.cu",
           "replaces": "estdepth_tpu/ops/pallas/plane_warp_exact_z.py:281",
           **_compare("frustum_warp_exact_z", out_k, out_p)}
    row["ms"] = cuda_ms(kern)
    row["plain_ms"] = cuda_ms(plain, reps=10)
    row["library_ms"] = None
    voxels = out_k.numel() // c
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(vol, zi, x, y, z, out_k), out_k.numel() * 32 + voxels * 30)
    row["valid_share"] = (out_p.abs().amax(-1) > 0).float().mean().item()
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


def phase_main_path(rows: list[dict]) -> None:
    """The ESTM streaming step at the flagship width through the kernels:
    every kernel's count is set to 0 just before and read just after."""
    kernels = {"plane_sweep_warp": plane_warp.KERNEL,
               "frustum_warp_exact_z": plane_warp_exact_z.KERNEL}
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    res = run_synthetic(HEIGHT, WIDTH, NDEPTHS, DEPTH_MIN, DEPTH_MAX,
                        resnet=50, lwindow=LWINDOW, memory_size=MEMORY,
                        scenes=1, n_frames=FRAMES, seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
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
    if launches != {"plane_sweep_warp": steps,
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
        row["launches"] = launches[row["name"]]


def main() -> None:
    dev_info = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_geometry()
    phase_reference()
    phase_main_path(rows)
    print(json.dumps({"kernels": rows}))
    print(dev_info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
