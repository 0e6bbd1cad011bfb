"""Where the time of the ESTM streaming step goes, on the CUDA device.

    python -m estdepth_tpu_torch.tools.profile_estm [--frames 8] [--trace DIR]

Streams one synthetic scene through ESTMRunner at the eval defaults
(256x320, D = 64, ResNet-50, lwindow 3, memory 2, float32, random weights),
warms up on the first windows, then records the steady-state frames with
torch.profiler. Prints one JSON line: host ms per frame, device-busy ms per
frame (the sum of kernel times; one stream, so kernels do not overlap),
the device's idle share, the share of each kernel group, and the top
kernels by device time. --trace writes a Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from estdepth_tpu_torch.config import ModelConfig, set_fp32_numerics
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

# kernel name -> group, first match wins (cuDNN's BatchNorm and layout
# kernels before its convolutions)
GROUPS = [
    ("port: plane_sweep_warp", r"plane_sweep_warp_kernel"),
    ("port: frustum_warp_exact_z", r"frustum_warp_exact_z_kernel"),
    ("batchnorm (cuDNN, eval)", r"bn_fw_inf|batch_norm"),
    ("groupnorm", r"RowwiseMoments|group_norm|GroupNorm"),
    ("layout / copy / cat", r"nhwcToNchw|nchwToNhwc|copy|Memcpy|"
                            r"transpose"),
    ("conv (cuDNN)", r"conv|cudnn|implicit|xmma|winograd|fft|sm90|sm80"),
    ("gemm", r"gemm|cutlass|cublas"),
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
    p.add_argument("--frames", type=int, default=8,
                   help="steady-state frames recorded")
    p.add_argument("--warmup", type=int, default=4,
                   help="frames streamed before recording")
    p.add_argument("--trace", type=str, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_estm: needs a CUDA device")
    set_fp32_numerics()
    cfg = SyntheticSceneConfig()
    frames = list(synthetic_stream(cfg, args.warmup + args.frames))
    runner = ESTMRunner(DepthNetHybrid(ModelConfig()), cfg.height,
                        cfg.width, device="cuda")

    def push(f):
        out = runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        if out is not None:
            out.cpu()

    for f in frames[:args.warmup]:
        push(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[args.warmup:]:
            push(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.frames
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += e.device_time_total / 1e3  # ms
            kernels[e.name][1] += 1
    busy = sum(t for t, _ in kernels.values())
    groups = defaultdict(float)
    for name, (t, _) in kernels.items():
        groups[group_of(name)] += t
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "frames": n,
        "host_ms_per_frame": 1e3 * wall / n,
        "device_busy_ms_per_frame": busy / n,
        "device_idle_share": 1.0 - busy / (1e3 * wall) if wall else None,
        "kernel_launches_per_frame": sum(c for _, c in kernels.values()) / n,
        "groups_ms_per_frame": {g: t / n for g, t in
                                sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": name[:120], "ms_per_frame": t / n,
                         "calls_per_frame": c / n}
                        for name, (t, c) in top],
    }))
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / "estm_trace.json"))


if __name__ == "__main__":
    main()
