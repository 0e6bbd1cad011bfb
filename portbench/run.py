#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the checkout's root. The cell is an entry of BENCHMARK.json; its
configuration, traffic mix, protocol driver, per-layer readers and output
limits are found by name (harness/cell.py). The run makes its weights and
inputs from --seed on the device, builds the port's step and warms it up
(set-up, `setup_s`, timed from the process's start), runs the protocol's
closed loop for --seconds, reads the peak memory, frees the port's state,
and checks what the window produced against the plain reference
(reference/). With --trace 0 it reports the cell's end-to-end metrics;
with --trace 1 the first half of the window runs on the host clock alone
and the second under torch.profiler, and it reports the per-layer metrics,
the device's busy and window seconds and a breakdown. The last line of
standard output is one JSON object; the numbers compared and their limits
are the last lines of standard error and the last key of that object.

Exits 2 without a result where no CUDA device (or fewer than the cell
asks for) is present, and 3 where jax, jaxlib, flax or the JAX package
were loaded into the process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "estdepth_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are the JAX stack or the JAX
    package, compared whole (estdepth_tpu_torch is not estdepth_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, root: Path = ROOT, device=None,
        require_cuda: bool = True) -> dict:
    """One run of the cell of the checkout at `root`; returns the result
    object. `device` and `require_cuda` exist for the CPU tests, which
    drive every other part of a run on the port's plain paths."""
    import torch
    from torch.autograd.profiler import record_function

    from portbench.harness import cell as cells
    from portbench.harness import models, trace
    from portbench.harness.loop import closed_loop, process_age_s
    from portbench.harness.readings import Readings

    cell = cells.load(root, args.workload)
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(2)
    device = torch.device("cuda", 0) if device is None else device
    on_cuda = device.type == "cuda"
    models.set_numerics(cell.config["tf32"])
    proto = cells.protocol(cell)
    session = proto.Session(cell, args.seed, device)
    if on_cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age_s()

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if args.trace:
        half = args.seconds / 2
        host, host_window_s = closed_loop(session, half)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with trace.module_spans(session.span_modules()), \
                torch.profiler.profile(activities=activities,
                                       record_shapes=True) as prof:
            traced, traced_window_s = closed_loop(session, half,
                                                  span=record_function)
            if on_cuda:
                torch.cuda.synchronize(device)
        tr = trace.reduce(prof, traced_window_s, traced)
        del prof
        recs = host + traced
    else:
        recs, window_s = closed_loop(session, args.seconds)
        values = proto.Session.end_to_end(recs, window_s)
        values["setup_s"] = setup_s
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}
    result["attempted"] = len(recs)
    result["failed"] = session.failed()
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    session.release()

    ref = models.reference(cell.config,
                           models.weights(cell.config, args.seed, device),
                           device)
    numbers = session.check(ref)
    result["correct"] = all(math.isfinite(v) and v <= limit
                            for _, v, limit in numbers)
    if args.trace:
        readings = Readings(cell.mix["protocol"], host, host_window_s, tr,
                            session.flops(ref))
        for m in cell.per_layer:
            value = cells.reader(cell, m["name"]).read(readings)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = trace.breakdown(tr)
    del ref
    result["device"] = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak,
        "power_limit": _power_limit() if on_cuda else None}
    if args.trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
    result["checked"] = {name: {"value": v, "limit": limit}
                         for name, v, limit in numbers}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    result = run(args)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
