"""Where the time of a window step goes, on the CUDA device.

    python -m estdepth_tpu_torch.tools.profile_estm
        [--protocol estm|joint|train] [--frames 8]
        [--no-exact-z | --exact-warp] [--fused-attention] [--two-pass-warp]
        [--bf16] [--serving] [--trace DIR]

Runs one synthetic scene at the eval defaults (256x320, D = 64, ResNet-50,
float32, or bfloat16 with --bf16, random weights) through ESTMRunner
(lwindow 3, memory 2; a step is one frame) or, with --protocol joint,
through JointRunner (5-frame windows advancing by 3, a 1-entry memory; a
step is one window of 3 targets), or, with --protocol train, through the
training step of train/trainer.py on 5-frame windows at batch 1 (a step is
one optimizer update; the result fetched is the loss). With --serving (estm
or joint) the step is exported first (serving.export_stream / export_joint,
all 4 depth scales, as the live runners return them), saved, loaded back
and fed the scene's frames one by one: a step is then the frames a window
adds (1, or 3 for Joint). Warms up on the first steps, times --frames
steady-state steps
without the profiler (the median step, and how much of it the host spends
issuing the step's launches before it waits for the result), then records
--frames more with torch.profiler. Prints one JSON line: those two times,
host ms per step under the profiler, device-busy ms per step (the sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, the share of each kernel group, the top kernels by device time and
the top host operators by their own host time.
For a training step it also prints, per warp, the device time of the
backward (`estdepth::<kernel>_backward` ranges: autograd of the plain
version, many PyTorch kernels) beside the forward kernel's.
The profiler adds its own time to every launch: where the step without it
is shorter than device-busy with it, trust the shares, not the sum.
--trace writes a Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from estdepth_tpu_torch import serving
from estdepth_tpu_torch.config import (
    ModelConfig, add_model_flags, compute_dtype_flag, resolve_frustum_mode,
    set_fp32_numerics,
)
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream, synthetic_window,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.tools.eval_joint import JointRunner
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step

# kernel name -> group, first match wins (cuDNN's BatchNorm and layout
# kernels before its convolutions)
GROUPS = [
    ("port: plane_sweep_warp", r"plane_sweep_warp_kernel"),
    ("port: frustum_warp_exact_z", r"frustum_warp_exact_z_kernel"),
    ("port: two_pass_resample", r"two_pass_resample_kernel"),
    ("port: frustum_warp_plane_mix", r"frustum_warp_plane_mix_kernel"),
    ("port: epipolar_attention", r"epipolar_attention_kernel"),
    ("batchnorm (cuDNN)", r"bn_fw|bn_bw|batch_norm"),
    ("groupnorm", r"RowwiseMoments|group_norm|GroupNorm"),
    ("layout / copy / cat", r"nhwcToNchw|nchwToNhwc|copy|Memcpy|"
                            r"transpose"),
    # the complex GEMMs of cuDNN's FFT convolutions (float32 only)
    ("conv FFT tiles (cuDNN)", r"fft|cf32cf32"),
    ("conv (cuDNN)", r"conv|cudnn|implicit|xmma|winograd|fft|sm90|sm80|"
                     r"wgrad|dgrad|fprop"),
    ("gemm", r"gemm|cutlass|cublas"),
    ("optimizer (multi-tensor)", r"multi_tensor|adam|foreach"),
    ("gather / index", r"gather|index|scatter"),
    ("reduce / softmax", r"reduce|softmax|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, re.IGNORECASE):
            return group
    return "other"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--protocol", choices=["estm", "joint", "train"],
                   default="estm")
    p.add_argument("--frames", type=int, default=8,
                   help="steady-state steps recorded")
    p.add_argument("--warmup", type=int, default=4,
                   help="steps run before recording")
    add_model_flags(p)
    p.add_argument("--two-pass-warp", action="store_true",
                   help="plane sweep through the fused two-pass resample")
    p.add_argument("--serving", action="store_true",
                   help="profile the exported step (estm or joint) loaded "
                        "back from disk instead of the live runner")
    p.add_argument("--trace", type=str, default=None)
    args = p.parse_args(argv)
    if args.serving and args.protocol == "train":
        raise SystemExit("profile_estm: --serving profiles estm or joint")
    if not torch.cuda.is_available():
        raise SystemExit("profile_estm: needs a CUDA device")
    set_fp32_numerics()
    cfg = SyntheticSceneConfig()
    model = DepthNetHybrid(ModelConfig(
        frustum_mode=resolve_frustum_mode(args.exact_warp, args.exact_z),
        use_fused_attention=args.fused_attention,
        two_pass_warp=args.two_pass_warp,
        compute_dtype=compute_dtype_flag(args)))
    n_steps = args.warmup + 2 * args.frames
    if args.serving:
        runner = _load_exported(model, cfg, args.protocol)
        window = runner.window
        stream = list(synthetic_stream(
            cfg, window + (n_steps - 1) * runner.stride))
        # a step: the frames a window adds (the first window: all of them)
        frames = [stream[:window]] + [
            stream[window + i * runner.stride:
                   window + (i + 1) * runner.stride]
            for i in range(n_steps - 1)]

        def issue(group):
            for f in group:
                out = runner.push_frame(f["img"], f["cam_pose"],
                                        f["cam_intr"])
            return out
    elif args.protocol == "estm":
        runner = ESTMRunner(model, cfg.height, cfg.width, device="cuda")
        frames = list(synthetic_stream(cfg, n_steps))

        def issue(f):
            return runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
    elif args.protocol == "train":
        model.to("cuda")
        optimizer, scheduler = make_optimizer(
            model.named_parameters(),
            warmup_multistep_schedule(4e-5, steps_per_epoch=256))
        step = make_train_step(model, optimizer, scheduler,
                               model.cfg.depth_min, model.cfg.depth_max)
        frames = [{k: torch.from_numpy(v).to("cuda") for k, v in
                   synthetic_window(cfg, 5, wi % 7).items()}
                  for wi in range(n_steps)]

        def issue(f):
            return step(f, 10.0)["loss"]
    else:
        runner = JointRunner(model, device="cuda")
        frames = [synthetic_window(cfg, 5, 3 * wi) for wi in range(n_steps)]

        def issue(f):
            return runner.run_window(f["imgs"], f["cam_poses"],
                                     f["cam_intr"])[0]

    def push(f):
        """One step and the fetch of its result: (seconds until the step's
        launches were issued, seconds until the result was on the host)."""
        t0 = time.perf_counter()
        out = issue(f)
        t1 = time.perf_counter()
        if out is not None:
            out.cpu()
        return t1 - t0, time.perf_counter() - t0

    for f in frames[:args.warmup]:
        push(f)
    torch.cuda.synchronize()
    plain_steps = [push(f) for f in frames[args.warmup:-args.frames]]
    torch.cuda.synchronize()
    issue_ms = 1e3 * statistics.median(t for t, _ in plain_steps)
    step_ms = 1e3 * statistics.median(t for _, t in plain_steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[-args.frames:]:
            push(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.frames
    kernels = defaultdict(lambda: [0.0, 0])
    backward = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation:  # a range's span, not a kernel
                continue
            kernels[e.name][0] += e.device_time_total / 1e3  # ms
            kernels[e.name][1] += 1
        elif e.name.startswith("estdepth::"):  # a warp's backward range
            backward[e.name][0] += e.device_time_total / 1e3
            backward[e.name][1] += 1
    busy = sum(t for t, _ in kernels.values())
    host_ops = sorted(
        (e for e in prof.key_averages() if e.self_cpu_time_total > 0),
        key=lambda e: -e.self_cpu_time_total)[:15]
    groups = defaultdict(float)
    for name, (t, _) in kernels.items():
        groups[group_of(name)] += t
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "protocol": args.protocol,
        "frustum_mode": model.cfg.frustum_mode,
        "fused_attention": model.cfg.use_fused_attention,
        "serving": args.serving,
        "two_pass_warp": model.cfg.two_pass_warp,
        "compute_dtype": model.cfg.compute_dtype,
        "frames": n,
        "unprofiled_ms_per_frame": step_ms,
        "unprofiled_issue_ms_per_frame": issue_ms,
        "unprofiled_issue_share": issue_ms / step_ms,
        "host_ms_per_frame": 1e3 * wall / n,
        "device_busy_ms_per_frame": busy / n,
        "device_idle_share": 1.0 - busy / (1e3 * wall) if wall else None,
        "kernel_launches_per_frame": sum(c for _, c in kernels.values()) / n,
        "groups_ms_per_frame": {g: t / n for g, t in
                                sorted(groups.items(), key=lambda kv: -kv[1])},
        "warp_backward_ms_per_frame": {
            name: {"ms_per_frame": t / n, "calls_per_frame": c / n}
            for name, (t, c) in backward.items()},
        "top_kernels": [{"name": name[:120], "ms_per_frame": t / n,
                         "calls_per_frame": c / n}
                        for name, (t, c) in top],
        "top_host_ops": [{"name": e.key[:120],
                          "self_host_ms_per_frame":
                              e.self_cpu_time_total / 1e3 / n,
                          "calls_per_frame": e.count / n}
                         for e in host_ops],
    }))
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(Path(args.trace) / f"{args.protocol}_trace.json"))


def _load_exported(model, cfg, protocol: str):
    """The model's window step exported on the card, saved and loaded
    back: the runner a deployment uses."""
    export = (serving.export_joint if protocol == "joint"
              else serving.export_stream)
    art = export(model, height=cfg.height, width=cfg.width,
                 output_scales=(0, 1, 2, 3), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        art.save(tmp)
        load = (serving.load_joint if protocol == "joint"
                else serving.load_stream)
        return load(tmp, device="cuda")


if __name__ == "__main__":
    main()
