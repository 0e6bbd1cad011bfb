"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files in
a temporary checkout, cut to `tiny_config()` sizes, and one run of a cell
there on the port's plain paths."""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a large seed, as the driver's are
SEED = 2**31 + 11


def load_run():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_checkout(dest: Path) -> Path:
    """BENCHMARK.json and portbench/ under `dest`, every configuration at
    64x96 with 8 planes and a ResNet-18, every scene 14 frames."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["model"].update(ndepths=8, resnet=18)
        cfg["height"], cfg["width"] = 64, 96
        (dest / c["file"]).write_text(json.dumps(cfg))
    for mix in (dest / "portbench" / "traffic").glob("*.json"):
        m = json.loads(mix.read_text())
        m["scene"]["frames"] = 14
        m["scenes"] = 2
        if "windows" in m:
            m["windows"] = 4
        mix.write_text(json.dumps(m))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(scope="session")
def run_cell():
    """run_cell(root, workload, trace=0, seconds=2.0) -> the result
    object of one run on the CPU."""
    torch.set_num_threads(4)
    bench = load_run()

    def run(root, workload, trace=0, seconds=2.0, seed=SEED):
        return bench.run(argparse.Namespace(workload=workload, seed=seed,
                                            seconds=seconds, trace=trace),
                         root=root, device=torch.device("cpu"),
                         require_cuda=False)

    return run


@pytest.fixture
def cuda_device():
    """The card, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
