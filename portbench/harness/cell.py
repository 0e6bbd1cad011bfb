"""Everything a cell is, found by name.

A cell is an entry of `workloads` in BENCHMARK.json at the checkout's root.
It names a configuration (an entry of `configs`, whose `file` holds the
model's settings, and under `family` the model family
`portbench/families/<family>.py` that builds its model, reference and
weights: harness/models.py) and a traffic mix,
`portbench/traffic/<mix>.json`, whose `protocol` names the driver
`portbench/protocols/<protocol>.py`. Each per-layer metric is read by
`portbench/layer_metrics/<metric>.py`, and the limits of a cell's output
check are `portbench/limits/<cell>.json`. A new configuration, model
family, mix, metric or cell is new files and entries; no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

# the family of a configuration whose file names none
DEFAULT_FAMILY = "estdepth_hybrid"


@dataclasses.dataclass(frozen=True)
class Cell:
    package: Path  # <root>/portbench
    name: str
    chips: int
    config: dict  # the configuration's file, and `family_file`
    mix: dict  # the traffic mix's file
    limits: dict  # {number: {"limit": ...}} of the output check
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path, workload: str) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    package = root / "portbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(root / entry["file"])
    return Cell(
        package=package, name=workload, chips=w["chips"],
        config=dict(config,
                    family_file=str(family_file(package, config))),
        mix=_load_json(package / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(package / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def family_file(package: Path, config: dict) -> Path:
    """The file of the model family that the configuration `config`
    names, in the benchmark package `package`."""
    return (package / "families"
            / f"{config.get('family', DEFAULT_FAMILY)}.py")


def load_module(path: Path):
    """The Python file at `path` as a module of its own, named after its
    directory and stem (a family and a protocol may share a stem)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def protocol(cell: Cell):
    return load_module(cell.package / "protocols"
                       / f"{cell.mix['protocol']}.py")


def reader(cell: Cell, metric: str):
    return load_module(cell.package / "layer_metrics" / f"{metric}.py")
