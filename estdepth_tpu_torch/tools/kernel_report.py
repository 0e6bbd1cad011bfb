"""Registers, spills and SASS instruction counts of the port's CUDA kernels.

    python -m estdepth_tpu_torch.tools.kernel_report [name ...]

Compiles each `estdepth_tpu_torch/csrc/<name>.cu` (all of them by default)
with the build's flags plus `-Xptxas -v` into a temporary directory, reads
what ptxas reports for every kernel instance (registers, spilled bytes,
static shared memory) and counts the instructions of its SASS
(`cuobjdump -sass`): all of them, and the global loads, global stores and
warp shuffles among them. The counts are static (instructions in the
code, not executed ones). Needs the CUDA toolkit; prints one JSON line per
kernel instance.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from estdepth_tpu_torch.ops.cuda import build

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_KINDS = {"LDG": "global_loads", "STG": "global_stores", "SHFL": "shuffles"}


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.split("\n")
    return dict(zip(names, out))


def ptxas_report(log: str) -> dict[str, dict]:
    """ptxas -v output -> {mangled kernel: registers, spills, smem}."""
    kernels, name = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            kernels[name] = {}
        elif name and (m := _SPILL.search(line)):
            kernels[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := _USED.search(line)):
            kernels[name]["registers"] = int(m.group(1))
            kernels[name]["smem_bytes"] = int(m.group(2) or 0)
    return kernels


def sass_counts(sass: str) -> dict[str, collections.Counter]:
    """cuobjdump -sass output -> {mangled kernel: counts by kind}."""
    counts, name = {}, None
    for line in sass.splitlines():
        if m := _FUNCTION.match(line):
            name = m.group(1)
            counts[name] = collections.Counter()
        elif name and (m := _INSTRUCTION.search(line)):
            op = m.group(1).split(".")[0]
            counts[name]["instructions"] += 1
            if op in _KINDS:
                counts[name][_KINDS[op]] += 1
    return counts


def report(name: str, workdir: Path) -> list[dict]:
    lib = workdir / f"{name}.so"
    compiled = subprocess.run(
        [build.nvcc(), *build.FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(build.CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if compiled.returncode:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{compiled.stderr}")
    cuobjdump = str(Path(build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    regs, counts = ptxas_report(compiled.stderr), sass_counts(sass)
    names = _demangle(sorted(regs))
    return [{"source": f"{name}.cu", "kernel": names[k], **regs[k],
             **dict(counts.get(k, {}))} for k in sorted(regs)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("names", nargs="*", help="csrc/<name>.cu (default: all)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.names or build.sources():
            for row in report(name, Path(tmp)):
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
