"""BENCHMARK.json against the rules its check applies before any run, and
the files every name in it points to."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
MUST = {"end_to_end": KEYS["end_to_end"] - {"workloads"},
        "per_layer": KEYS["per_layer"] - {"workloads"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_size_and_command():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_names_and_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section]
        assert MUST.get(section, KEYS[section]) <= set(e)
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.fullmatch(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_cells_point_at_files():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
        mix = json.loads((ROOT / "portbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "protocols"
                / f"{mix['protocol']}.py").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "portbench" / "layer_metrics"
                / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert _reports(moved, cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        cell = w["name"]
        assert sum(_reports(m, cell) for m in BENCH["end_to_end"]) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_layers_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"`{layer}`" in perf, layer


def test_file_names_use_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert PATH.fullmatch(str(path.relative_to(ROOT))), path


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_no_file_imports_the_jax_stack_or_the_jax_package():
    from portbench.run import FORBIDDEN

    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        assert not tops & {"bench", "chip_smoke"}, path


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"torch", "portbench", "__future__"}, (path, tops)


def test_every_configuration_names_a_family_file():
    from portbench.harness.cell import family_file

    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert family_file(ROOT / "portbench", cfg).is_file(), c["name"]


def _module_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_families_import_the_port_only_inside_port():
    """A family's structure and reference load nothing of the port: it is
    imported inside `port()` alone."""
    for path in (ROOT / "portbench" / "families").glob("*.py"):
        tops = {n.split(".")[0] for n in _module_level_imports(path)}
        assert "estdepth_tpu_torch" not in tops, path


def test_forbidden_names_compare_whole():
    from portbench.run import forbidden_modules

    assert forbidden_modules(["estdepth_tpu_torch", "estdepth_tpu_torch.ops",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "estdepth_tpu.ops", "flax",
                              "jaxlib.xla_client"]) == [
        "estdepth_tpu", "flax", "jax", "jaxlib"]
