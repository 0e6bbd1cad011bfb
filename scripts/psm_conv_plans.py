#!/usr/bin/env python3
"""The PSM matching encoder's convolutions under cuDNN's heuristic plan and
under its measured plan, one row per distinct convolution, on the card.

    python scripts/psm_conv_plans.py [--batches 5 1] [--reps 20]
        [--out FILE]

The encoder (models/psm.PSMFeatureNet, random weights, eval mode, float32
with TF32 off) runs once at each batch on 256x320 frames laid out as
DepthNetHybrid._matching lays them out, and forward pre-hooks record every
convolution's input (shape and memory layout), weight shape, stride,
padding and dilation. cuDNN keeps the plan that a convolution's first call
chose for the life of the process, so each mode runs in a process of its
own: `heuristic` with torch.backends.cudnn.benchmark false, `measured`
with it true. There each distinct convolution is called once (the plan is
chosen), then timed over --reps calls behind CUDA events (median of 5),
then profiled once for the names of the kernels it launches. Prints a
Markdown table with the card's name and power limit (shape, GFLOP, count
in one forward, each mode's kernels and ms, TFLOP/s against the float32
peak) and each mode's sum over one forward; --out writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, W = 256, 320
PEAK_TFLOPS = 67.0  # H100 SXM float32, no tensor cores
MODES = {"heuristic": False, "measured": True}


def _numerics(benchmark: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = benchmark


def capture(batch: int) -> list[dict]:
    """Every distinct convolution of one encoder forward at `batch`, in
    order of first call, with its count."""
    from estdepth_tpu_torch.models.layers import init_weights
    from estdepth_tpu_torch.models.psm import PSMFeatureNet

    net = PSMFeatureNet()
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.eval().cuda()
    specs: dict = {}

    def hook(name):
        def pre(mod, args):
            x = args[0]
            nhwc = (x.is_contiguous(memory_format=torch.channels_last)
                    and not x.is_contiguous())
            key = (tuple(x.shape), nhwc, tuple(mod.weight.shape),
                   mod.stride, mod.padding, mod.dilation)
            if key not in specs:
                specs[key] = {"first": name, "count": 0,
                              "input": list(x.shape), "nhwc": nhwc,
                              "weight": list(mod.weight.shape),
                              "stride": list(mod.stride),
                              "padding": list(mod.padding),
                              "dilation": list(mod.dilation)}
            specs[key]["count"] += 1
        return pre

    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_pre_hook(hook(name))
    x = torch.rand(batch, H, W, 3, device="cuda") * 2 - 1
    with torch.no_grad():
        net(x.permute(0, 3, 1, 2))
    return list(specs.values())


def _gflop(spec: dict) -> float:
    n, cin, h, w = spec["input"]
    cout, _, kh, kw = spec["weight"]
    (sh, sw), (ph, pw), (dh, dw) = (spec["stride"], spec["padding"],
                                    spec["dilation"])
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return 2.0 * n * cout * ho * wo * cin * kh * kw / 1e9


def _kernels(fn) -> list[tuple[str, float]]:
    """(name, device µs) of each kernel that fn() launches."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.elapsed_us()))
    return out


def worker(mode: str, specs: list[dict], reps: int) -> list[dict]:
    _numerics(MODES[mode])
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for spec in specs:
        n, c, h, w = spec["input"]
        if spec["nhwc"]:
            x = torch.randn(n, h, w, c, device="cuda",
                            generator=g).permute(0, 3, 1, 2)
        else:
            x = torch.randn(n, c, h, w, device="cuda", generator=g)
        wt = torch.randn(spec["weight"], device="cuda", generator=g)

        def call():
            return F.conv2d(x, wt, None, spec["stride"], spec["padding"],
                            spec["dilation"])

        call()  # the plan is chosen here
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        rows.append({"ms": statistics.median(times),
                     "kernels": _kernels(call)})
    return rows


def _short(name: str, width: int = 72) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, nargs="+", default=[5, 1])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out")
    p.add_argument("--worker", choices=sorted(MODES), help=argparse.SUPPRESS)
    p.add_argument("--specs", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        specs = json.loads(Path(args.specs).read_text())
        print(json.dumps(worker(args.worker, specs, args.reps)))
        return 0

    _numerics(False)
    print(f"card: {_card()}; torch {torch.__version__}")
    table = []
    for batch in args.batches:
        specs = capture(batch)
        fd, name = tempfile.mkstemp(suffix=".json")
        spec_file = Path(name)
        with os.fdopen(fd, "w") as f:
            json.dump(specs, f)
        by_mode = {}
        for mode in MODES:
            out = subprocess.run(
                [sys.executable, __file__, "--worker", mode, "--specs",
                 str(spec_file), "--reps", str(args.reps)],
                capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stderr)
                raise SystemExit(f"the {mode} worker failed")
            by_mode[mode] = json.loads(out.stdout.strip().splitlines()[-1])
        spec_file.unlink()
        print(f"\nbatch {batch}\n")
        print("| first conv | input (layout) | weight s/p/d | GFLOP | count |"
              " heuristic kernels | ms | TFLOP/s | measured kernels | ms |"
              " TFLOP/s |")
        print("|---" * 11 + "|")
        totals = dict.fromkeys(MODES, 0.0)
        for i, spec in enumerate(specs):
            gf = _gflop(spec)
            row = dict(spec, batch=batch, gflop=gf)
            cells = []
            for mode in MODES:
                r = by_mode[mode][i]
                row[mode] = r
                totals[mode] += r["ms"] * spec["count"]
                names = "; ".join(sorted({_short(k) for k, _ in
                                          r["kernels"]}))
                cells += [names, f"{r['ms']:.4f}",
                          f"{gf / r['ms']:.2f}"]
            table.append(row)
            layout = "NHWC" if spec["nhwc"] else "NCHW"
            print(f"| {spec['first']} | {spec['input']} ({layout}) | "
                  f"{spec['weight']} {spec['stride']}/{spec['padding']}/"
                  f"{spec['dilation']} | {gf:.3f} | {spec['count']} | "
                  + " | ".join(cells) + " |")
        gf_all = sum(_gflop(s) * s["count"] for s in specs)
        print(f"\nbatch {batch}: {gf_all:.2f} GFLOP a forward; sum of ms x "
              "count: " + ", ".join(f"{m} {t:.3f} ms "
                                     f"({gf_all / t:.2f} TFLOP/s, "
                                     f"{100 * gf_all / t / PEAK_TFLOPS:.1f}%"
                                     f" of {PEAK_TFLOPS:g})"
                                     for m, t in totals.items()))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": _card(), "torch": torch.__version__, "rows": table},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
