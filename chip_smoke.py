#!/usr/bin/env python3
"""The port's CUDA kernels on one NVIDIA GPU: the table of kernels.

    python3 chip_smoke.py

Builds the kernels from estdepth_tpu_torch/csrc, then holds each against
its plain PyTorch version at the flagship shapes (256x320 frames, D = 64)
of the ESTM step and the Joint and training window, in both instances
(float32 and bf16), and times it there. Kernels 1 to 4 are held bit for
bit (the frustum warps, kernels 2 and 4, also at a rolled pose), the
attention kernel at rtol 1e-5 in float32 and within one bf16 ulp of the
output's scale in bf16. The warps' gradients (forward through the
kernel, backward through autograd of the plain version) are held against
autograd of the plain version called directly and their backward timed.
Prints one line per kernel (`"phase": "kernel"`) and per gradient, then
{"kernels": [...]}, one row per kernel: the numbers of PERF.md's table
of TPU kernels. CasMVSNet's sweep (kernel 1 at per-pixel hypotheses) is
held only by the `cuda` tests, at one stage's shape. The port's own
variance kernel (CasMVSNet's cost volume, which replaces no TPU kernel)
is held bit for bit and timed at the three DTU stages' shapes, with
every instance's registers and spills; so is the port's own correlation
kernel (TransMVSNet's cost volume, one swept source view a call), held
to 4 C 2^-23 mean_c |warped_c ref_c| of its plain version at every
voxel, since it sums the channels in another order. The last row is the
port's own GroupNorm-and-activation kernel (the EST GRU's norms) at the
GRU's two calls, held to 4 float32 ulps of the output's scale of its
plain version (one bf16 ulp in bf16) and timed in turns with it, which
is ATen's group norm and activation.

Then it drives, once each at the flagship width (ResNet-50), the routes
that no benchmark cell runs: the Joint chain with the plane-mix warp and
the attention kernel, training through the two-pass sweep, and in bf16
the stream, both Joint chains and both training routes (ROUTES). Each
kernel's launches are counted over each run and held to the route's
(a bf16 run launches only bf16 instances), and the depths must be finite
and in range, the training losses finite. Untimed: a path's time is a
benchmark cell's. The last line is {"ok": true, "device": {...}}; any
failure raises and exits non-zero.

A kernel's time is device ms per call, from runs of 20 back-to-back calls
queued while the device is held busy, one CUDA event pair per run; where a
PyTorch call computes the same memory work (F.grid_sample,
scaled_dot_product_attention) the kernel and that call are timed in turns.
The two frustum warps (one body: csrc/frustum_gather.cuh) are timed in
turns with a 5-D F.grid_sample at (x, y, z*) (another function, a
yardstick of the same 8-tap memory work), with their instances'
registers and shared memory (tools/kernel_report). Each row's bound is its
bytes at the card's memory rate or its operations at the float32 rate,
whichever is longer (bound_ms, nbytes: portbench/harness/rooflines.py
counts kernels 1 and 2 the same way).

To compare a parent commit's kernels with this tree's, unpack the parent
into an ignored directory and run each tree's own phases in turns
(parent, change, change, parent) in one call:

    python -c "import chip_smoke as c; c.phase_device(); c.phase_build();
               c.phase_kernels()"

The paths on the card are held against the CPU by the `cuda` tests
(tests/test_torch_port_cuda.py, tests/test_torch_port_bn_fold.py, at a
small size) and by the benchmark's output check, and timed by the
benchmark's cells (portbench/, BENCHMARK.json).

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from estdepth_tpu_torch.config import set_fp32_numerics
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, intrinsics, pose,
)
from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import (
    build, epipolar_attention, plane_mix, plane_warp,
    group_norm_act, plane_warp_exact_z, two_pass, view_correlation,
    view_variance,
)
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field
from estdepth_tpu_torch.tools import eval_joint, kernel_report
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.tools.eval_estm import run_synthetic

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
JOINT_NEIGHBOURS = 3
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
# The full-width routes that no benchmark cell drives (every cell runs
# float32 through the exact-z frustum warp and the one-pass sweep), with
# each route's launches: an 8-frame ESTM stream (6 window steps, EST from
# the second); 5 Joint windows of 5 frames (one sweep a window, one
# frustum warp and one attention call a target of each window after the
# first); 3 training steps on 5-frame windows (one sweep or two-pass
# resample a step, one exact-z warp a target).
FRAMES, JOINT_WINDOWS, TRAIN_STEPS = 8, 5, 3
_FUSED = (JOINT_WINDOWS - 1) * 3
_TRAIN = {"frustum_warp_exact_z": 3 * TRAIN_STEPS}
ROUTES = {
    "estm": ({}, {"plane_sweep_warp": FRAMES - 2,
                  "frustum_warp_exact_z": FRAMES - 3}),
    "joint": ({}, {"plane_sweep_warp": JOINT_WINDOWS,
                   "frustum_warp_exact_z": _FUSED}),
    "joint_plane_mix_fused_attention": (
        dict(frustum_mode="plane_mix", fused_attention=True),
        {"plane_sweep_warp": JOINT_WINDOWS, "frustum_warp_plane_mix": _FUSED,
         "epipolar_attention": _FUSED}),
    "train": ([], {"plane_sweep_warp": TRAIN_STEPS, **_TRAIN}),
    "train_two_pass_warp": (["--two-pass-warp"],
                            {"two_pass_resample": TRAIN_STEPS, **_TRAIN}),
}
ROUTE_RUNS = [("joint_plane_mix_fused_attention", "float32"),
              ("train_two_pass_warp", "float32"),
              *((route, "bfloat16") for route in ROUTES)]


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
    rows.append(_view_variance_row(dev))
    rows.append(_view_correlation_row(dev))
    rows.append(_group_norm_act_row(dev))
    for r in rows:
        log("kernel", **r)
    return rows


# CasMVSNet's stages at the DTU setting (models/casmvsnet.py): h, w, C, D
MVS_STAGES = [(288, 400, 32, 48), (576, 800, 16, 32), (1152, 1600, 8, 8)]
MVS_SOURCES = 4  # a reference view and its 4 source views


def _view_variance_row(dev) -> dict:
    """The port's own variance kernel (CasMVSNet's cost volume, no TPU
    counterpart) at each DTU stage's shape, on random features and
    volumes: bit for bit its plain version, timed against its bytes (each
    input read once, the NCDHW output written once; no operation
    counted) and beside the plain version; with every instance's
    registers, spills and shared memory."""
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = []
    for h, w, c, d in MVS_STAGES:
        ref = torch.randn(1, h, w, c, device=dev, generator=gen)
        warped = [torch.randn(1, d, h, w, c, device=dev, generator=gen)
                  for _ in range(MVS_SOURCES)]
        m = _measure(
            "view_variance",
            lambda: view_variance.view_variance(ref, warped),
            lambda: view_variance.view_variance_plain(ref, warped),
            nbytes(ref, *warped) + nbytes(warped[0]), 0.0, exact=True)
        stages.append({"h": h, "w": w, "c": c, "d": d, **m})
        del ref, warped
        torch.cuda.empty_cache()
    report = [{k: r.get(k, 0) for k in ("kernel", "registers", "spill_bytes",
                                         "smem_bytes")}
              for r in _kernel_reports(["view_variance"])["view_variance"]]
    return {"name": "view_variance", "route": "cuda",
            "source": "estdepth_tpu_torch/csrc/view_variance.cu",
            "replaces": None, "stages": stages, "report": report,
            "ms": sum(m["ms"] for m in stages),
            "bound_ms": sum(m["bound_ms"] for m in stages)}


def _view_correlation_row(dev) -> dict:
    """The port's own correlation kernel (TransMVSNet's cost volume, no
    TPU counterpart) at each DTU stage's shape, one swept source view a
    call, on random features and volumes: within 4 C 2^-23 mean_c
    |warped_c ref_c| of its plain version at every voxel (the largest
    ratio of gap to bound), timed against its bytes (each input read
    once, the [B, D, H, W] output written once; no operation counted) and
    beside the plain version; with every instance's registers, spills
    and shared memory."""
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = []
    for h, w, c, d in MVS_STAGES:
        ref = torch.randn(1, h, w, c, device=dev, generator=gen)
        warped = torch.randn(1, d, h, w, c, device=dev, generator=gen)
        got = view_correlation.view_correlation(ref, warped)
        gap = (got - view_correlation.view_correlation_plain(ref, warped)
               ).abs_()
        bound = (warped * ref[:, None]).abs_().mean(-1).mul_(
            4 * c * 2.0 ** -23)
        ratio = float((gap / bound.clamp_min_(
            torch.finfo(torch.float32).tiny)).max())
        if not ratio <= 1:
            raise AssertionError(f"view_correlation: {ratio} of its bound "
                                 f"from its plain version at {h}x{w}x{c}")
        del gap, bound
        m = _measure(
            "view_correlation",
            lambda: view_correlation.view_correlation(ref, warped),
            lambda: view_correlation.view_correlation_plain(ref, warped),
            nbytes(ref, warped, got), 0.0)
        stages.append({"h": h, "w": w, "c": c, "d": d,
                       "max_gap_over_bound": ratio, **m})
        del ref, warped, got
        torch.cuda.empty_cache()
    report = [{k: r.get(k, 0) for k in ("kernel", "registers", "spill_bytes",
                                         "smem_bytes")}
              for r in _kernel_reports(["view_correlation"])[
                  "view_correlation"]]
    return {"name": "view_correlation", "route": "cuda",
            "source": "estdepth_tpu_torch/csrc/view_correlation.cu",
            "replaces": None, "stages": stages, "report": report,
            "ms": sum(m["ms"] for m in stages),
            "bound_ms": sum(m["bound_ms"] for m in stages)}


# the EST GRU's two GroupNorm calls at the flagship volume (16 channels,
# D = 64, 64x80): the gates' two norms in one call, the output norm
GRU_NORMS = [((1, 32, NDEPTHS, HEIGHT // 4, WIDTH // 4), 2, "sigmoid"),
             ((1, 16, NDEPTHS, HEIGHT // 4, WIDTH // 4), 1, "tanh")]


def _ulps_of_scale(got, want) -> float:
    """max |got - want| over the spacing eps(dtype) max |want|."""
    return ((got.float() - want.float()).abs().max().item()
            / (torch.finfo(want.dtype).eps
               * want.float().abs().max().item()))


def _group_norm_act_row(dev) -> dict:
    """The port's GroupNorm-and-activation kernel (the EST GRU's norms, no
    TPU counterpart) at the GRU's two calls, on random volumes: within 4
    float32 ulps of the output's scale of its plain version (one bf16 ulp
    in bf16), the largest gaps recorded; timed in turns with the plain
    version, which is ATen's F.group_norm and activation on the same call,
    against its bytes (x read once, the output written once, the weight
    and bias; no operation counted); with every instance's registers."""
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for shape, groups, act in GRU_NORMS:
        c = shape[1]
        x = 2.0 * torch.randn(shape, device=dev, generator=gen) + 0.5
        weight = 1.0 + 0.2 * torch.randn(c, device=dev, generator=gen)
        bias = 0.2 * torch.randn(c, device=dev, generator=gen)
        entry = {"shape": list(shape), "groups": groups, "act": act}
        fns = {}
        for key, v in (("f32", x), ("bf16", x.bfloat16())):
            def kern(v=v):
                return group_norm_act.group_norm_act(v, weight, bias, groups,
                                                     1e-5, act)

            def aten(v=v):
                return group_norm_act.group_norm_act_plain(
                    v, weight, bias, groups, 1e-5, act)

            got, want = kern(), aten()
            gap = _ulps_of_scale(got, want)
            if not gap <= (4 if key == "f32" else 1):
                raise AssertionError(f"group_norm_act {key} {shape}: {gap} "
                                     f"ulps of the output's scale from "
                                     f"its plain version")
            entry[key] = {"max_err_in_ulps_of_scale": gap,
                          "deterministic": torch.equal(got, kern())}
            entry[key]["bound_ms"], entry[key]["bound_by"] = bound_ms(
                nbytes(v, got, weight, bias), 0.0)
            fns[key] = (kern, aten)
            del got, want
        times = turns_ms(*fns["f32"], *fns["bf16"])
        for key, (k_ms, aten_ms) in (("f32", times[:2]),
                                     ("bf16", times[2:])):
            entry[key].update(ms=k_ms, library_ms=aten_ms,
                              bound_share=entry[key]["bound_ms"] / k_ms)
        calls.append(entry)
        del x, fns
        torch.cuda.empty_cache()
    report = [{k: r.get(k, 0) for k in ("kernel", "registers", "spill_bytes",
                                         "smem_bytes")}
              for r in _kernel_reports(["group_norm_act"])["group_norm_act"]]
    return {"name": "group_norm_act", "route": "cuda",
            "source": "estdepth_tpu_torch/csrc/group_norm_act.cu",
            "replaces": None, "calls": calls, "report": report,
            "ms": sum(m["f32"]["ms"] for m in calls),
            "bound_ms": sum(m["f32"]["bound_ms"] for m in calls)}


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


def _run_route(route: str, dtype: str) -> list:
    """One run of `route` in `dtype` at the flagship width (ResNet-50,
    random weights from seed 0): its depth range, or its training
    losses."""
    options, _ = ROUTES[route]
    sizes = (HEIGHT, WIDTH, NDEPTHS, DEPTH_MIN, DEPTH_MAX)
    if route == "estm":
        maps = np.stack(run_synthetic(
            *sizes, resnet=50, scenes=1, n_frames=FRAMES, seed=0,
            device="cuda", compute_dtype=dtype)["maps"])
        shape = (FRAMES - 2, 2, HEIGHT, WIDTH)
    elif route.startswith("joint"):
        maps = eval_joint.run_synthetic(
            *sizes, resnet=50, windows=JOINT_WINDOWS, seed=0, device="cuda",
            compute_dtype=dtype, **options)["maps"]
        shape = (JOINT_WINDOWS, 3, 2, HEIGHT, WIDTH)
    else:
        with tempfile.TemporaryDirectory() as logdir:
            res = train_tool.run(train_tool.parse_args([
                "--synthetic", "--steps", str(TRAIN_STEPS), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--ndepths",
                str(NDEPTHS), "--depth-min", str(DEPTH_MIN), "--depth-max",
                str(DEPTH_MAX), "--resnet", "50", "--n-frames", "5",
                "--batch-per-device", "1", "--summary-freq", "1", "--seed",
                "0", "--logdir", logdir, "--ckpt-steps",
                str(10 * TRAIN_STEPS), *options,
                *(["--bf16"] if dtype == "bfloat16" else [])]))
        losses = [r["loss"] for r in res["records"]]
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                   for r in res["records"]):
            raise AssertionError(f"{route} {dtype}: {res['records']}")
        state = res["state"]
        if not all(t.dtype == torch.float32 for t in (
                *state.model.parameters(),
                *(v for st in state.optimizer.state.values()
                  for v in st.values() if v.is_floating_point()))):
            raise AssertionError(f"{route} {dtype}: a parameter or an Adam "
                                 f"moment is not float32")
        return losses
    if maps.shape != shape or not (np.isfinite(maps).all() and maps.min()
                                   >= 0 and maps.max() <= DEPTH_MAX):
        raise AssertionError(f"{route} {dtype}: outputs {maps.shape}, "
                             f"depths not finite or outside [0, depth_max]")
    return [float(maps.min()), float(maps.max())]


def phase_routes() -> None:
    """Each of ROUTE_RUNS once, every kernel's counts read just before and
    just after: each kernel launches exactly as ROUTES says (0 where it
    does not name it), a bf16 run only bf16 instances and a float32 run
    none, and between them the bf16 runs launch all five kernels."""
    launched_bf16 = set()
    for route, dtype in ROUTE_RUNS:
        torch.cuda.synchronize()
        before = {n: (k.launches, k.launches_bf16) for n, k in KERNELS.items()}
        out = _run_route(route, dtype)
        torch.cuda.synchronize()
        launches = {n: k.launches - before[n][0] for n, k in KERNELS.items()}
        bf16 = {n: k.launches_bf16 - before[n][1] for n, k in KERNELS.items()}
        expected = {**dict.fromkeys(KERNELS, 0), **ROUTES[route][1]}
        want_bf16 = launches if dtype == "bfloat16" else dict.fromkeys(
            KERNELS, 0)
        if launches != expected or bf16 != want_bf16:
            raise AssertionError(f"{route} {dtype}: kernel launches "
                                 f"{launches} (bf16 {bf16}), expected "
                                 f"{expected}")
        launched_bf16 |= {n for n, c in bf16.items() if c}
        log("route", path=route, dtype=dtype, launches=launches,
            **{"losses" if route.startswith("train") else "depth_range": out})
        torch.cuda.empty_cache()
    if launched_bf16 != set(KERNELS):
        raise AssertionError(f"bf16 routes launched only {launched_bf16}")


def main() -> None:
    dev_info = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_gradients(rows)
    phase_routes()
    print(json.dumps({"kernels": rows}))
    print(dev_info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
