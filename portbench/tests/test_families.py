"""Model families: the weights, port and reference of the existing
configurations as they were, the settings a family refuses, the bfloat16
port against the float32 reference, and a new architecture added by new
files alone and run as a cell on the CPU."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from portbench.harness import models
from portbench.tests.conftest import ROOT, SEED, tiny_checkout

CPU = torch.device("cpu")

# sha256 of models.weights(config, SEED, CPU), every tensor in the order of
# its name (name, dtype, shape, bytes), as the harness made them before
# configurations named their family
DIGESTS = {
    "estdepth_psm_r50":
        "236a7d5c9c808437f2ff2794c2834288dbd1aa74e5063abcd14ecbdfda3de87f",
    "estdepth_senet_r50":
        "1f55da9223710277d3090a2f7e38e66c2071a084bb8a3370b151e8cd4779ac17",
}


def _config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_weights_of_the_existing_configurations_are_pinned(name):
    assert _digest(models.weights(_config(name), SEED, CPU)) == DIGESTS[name]


def _tiny(**model) -> dict:
    cfg = _config("estdepth_psm_r50")
    cfg["model"].update(ndepths=8, resnet=18, **model)
    return cfg


def test_existing_configurations_are_the_hybrid_family():
    from portbench.harness import cell as cells

    for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]:
        assert "family" not in _config(c["name"])
    cell = cells.load(ROOT, "psm.estm_stream")
    assert cell.config["family_file"] == str(
        ROOT / "portbench" / "families" / "estdepth_hybrid.py")
    ref = models.reference(_tiny(), models.weights(_tiny(), 1, CPU), CPU)
    assert type(ref).__module__ == "portbench.reference.model"


@pytest.mark.parametrize("key, value", [
    ("est_transformer", False), ("frustum_mode", "plane_mix"),
    ("sequential_fusion", False), ("two_pass_warp", True),
    ("use_fused_attention", True), ("sequential_cost_bn", True),
    ("compute_dtype", "float16")])
def test_settings_the_reference_does_not_compute_are_refused(key, value):
    cfg = _tiny(**{key: value})
    with pytest.raises(ValueError, match=key):
        models.weights(cfg, 1, CPU)
    with pytest.raises(ValueError, match=key):
        models.reference(cfg, {}, CPU)


def test_bf16_port_against_the_float32_reference():
    f32, bf16 = _tiny(), _tiny(compute_dtype="bfloat16")
    state = models.weights(bf16, 7, CPU)
    same = models.weights(f32, 7, CPU)
    assert set(state) == set(same)
    assert all(torch.equal(state[k], same[k]) for k in state)
    port = models.port(bf16, state, CPU)
    ref = models.reference(bf16, state, CPU)
    assert port.compute_dtype == torch.bfloat16
    assert models.port(f32, state, CPU).compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in ref.parameters())
    assert all(p.dtype == torch.float32 for p in port.parameters())


# A toy plane-sweep network with a transposed 3D convolution: the files a
# model_config change would add, written into a copy of the benchmark.
TOY_REFERENCE = '''"""A toy plane-sweep network, plain float32: features,
a volume over planes, a 3D convolution with BatchNorm, a transposed 3D
convolution to twice the planes and the frame's size, and the expected
depth."""

import torch
from torch import nn


class ToyVolume(nn.Module):
    def __init__(self, channels, planes):
        super().__init__()
        self.planes = planes
        self.feat = nn.Conv2d(3, channels, 3, padding=1)
        self.cost = nn.Conv3d(channels, channels, 3, padding=1, bias=False)
        self.cost.he_init = True
        self.cost_bn = nn.BatchNorm3d(channels)
        self.up = nn.ConvTranspose3d(channels, 1, 4, stride=2, padding=1)

    def forward(self, images):
        f = torch.relu(self.feat(images))
        scale = torch.linspace(0.5, 1.5, self.planes)
        vol = f[:, :, None] * scale[:, None, None]
        vol = torch.relu(self.cost_bn(self.cost(vol)))
        prob = torch.softmax(self.up(vol)[:, 0], dim=1)
        depth = torch.linspace(1.0, 2.0, 2 * self.planes)
        return (prob * depth[:, None, None]).sum(1)
'''

TOY_FAMILY = '''"""A toy family: its reference is
portbench/reference/toy_volume.py, its port a second class on the same
state_dict."""

from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from portbench.harness.cell import load_module
from portbench.harness.weights import on_device

_ref = load_module(Path(__file__).resolve().parents[1] / "reference"
                   / "toy_volume.py")


class ToyPort(nn.Module):
    def __init__(self, channels, planes):
        super().__init__()
        self.planes = planes
        self.feat = nn.Conv2d(3, channels, 3, padding=1)
        self.cost = nn.Conv3d(channels, channels, 3, padding=1, bias=False)
        self.cost_bn = nn.BatchNorm3d(channels)
        self.up = nn.ConvTranspose3d(channels, 1, 4, stride=2, padding=1)

    def forward(self, images):
        f = F.relu(F.conv2d(images, self.feat.weight, self.feat.bias,
                            padding=1))
        scale = torch.linspace(0.5, 1.5, self.planes)
        vol = torch.einsum("bchw,d->bcdhw", f, scale)
        bn = self.cost_bn
        vol = F.relu(F.batch_norm(F.conv3d(vol, self.cost.weight, padding=1),
                                  bn.running_mean, bn.running_var, bn.weight,
                                  bn.bias, False, 0.0, bn.eps))
        logits = F.conv_transpose3d(vol, self.up.weight, self.up.bias,
                                    stride=2, padding=1)[:, 0]
        depth = torch.linspace(1.0, 2.0, 2 * self.planes)
        out = torch.einsum("bdhw,d->bhw", logits.softmax(1), depth)
        out[:, 0, 0] += {fault}
        return out


def _sizes(config):
    m = config["model"]
    if m.get("compute_dtype", "float32") != "float32":
        raise ValueError("compute_dtype: the toy computes float32")
    return m["channels"], m["planes"]


def structure(config):
    return _ref.ToyVolume(*_sizes(config))


def reference(config, state, device):
    return on_device(lambda: _ref.ToyVolume(*_sizes(config)), state, device)


def port(config, state, device):
    return on_device(lambda: ToyPort(*_sizes(config)), state, device)
'''

TOY_PROTOCOL = '''"""Batches of seeded images through the family's port,
one batch a request, closed loop; the check is the largest |port -
reference| over every batch the window delivered."""

import dataclasses

import torch

from portbench.harness import models


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    kind: str = "batch"


class Session:
    def __init__(self, cell, seed, device):
        cfg, mix = cell.config, cell.mix
        self.cell = cell
        gen = torch.Generator(device=device).manual_seed(seed)
        self.inputs = torch.rand(mix["batches"], mix["batch"], 3,
                                 cfg["height"], cfg["width"],
                                 generator=gen, device=device)
        self.model = models.port(cfg, models.weights(cfg, seed, device),
                                 device)
        self.outputs = {}
        self.sent = 0
        self.issue(Request(0))

    def next_request(self):
        self.sent += 1
        return Request((self.sent - 1) % len(self.inputs))

    @torch.no_grad()
    def issue(self, req):
        return self.model(self.inputs[req.index])

    def fetch(self, req, pending):
        self.outputs[req.index] = pending.cpu()
        return pending.shape[0]

    @staticmethod
    def end_to_end(recs, window_s):
        return {"toy_items_per_s": sum(r.delivered for r in recs) / window_s}

    def failed(self):
        return sum(not bool(o.isfinite().all())
                   for o in self.outputs.values())

    def span_modules(self):
        return {"up": self.model.up}

    def release(self):
        del self.model

    @torch.no_grad()
    def check(self, reference):
        gap = max(float((reference(self.inputs[i]) - o).abs().max())
                  for i, o in self.outputs.items())
        return [("out_gap", gap, self.cell.limits["out_gap"]["limit"])]

    @torch.no_grad()
    def flops(self, reference):
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            reference(self.inputs[0])
        return {"batch": fc.get_total_flops()}
'''


def _files(root) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def test_new_family_is_new_files_alone(tmp_path, run_cell):
    root = tiny_checkout(tmp_path)
    before = _files(root)
    bench_before = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "reference" / "toy_volume.py").write_text(TOY_REFERENCE)
    (pb / "families" / "toy_cascade.py").write_text(
        TOY_FAMILY.replace("{fault}", "0.0"))
    (pb / "families" / "toy_cascade_fault.py").write_text(
        TOY_FAMILY.replace("{fault}", "0.05"))
    (pb / "protocols" / "toy_volumes.py").write_text(TOY_PROTOCOL)
    config = {"family": "toy_cascade", "model": {"channels": 4, "planes": 6},
              "height": 16, "width": 24, "tf32": False, "reduced": []}
    (pb / "configs" / "toy_cfg.json").write_text(json.dumps(config))
    (pb / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"protocol": "toy_volumes", "batches": 3, "batch": 2}))
    (pb / "limits" / "toy.cell.json").write_text(json.dumps(
        {"out_gap": {"limit": 1e-4}}))
    (pb / "layer_metrics" / "toy_host_issue_ms.py").write_text(
        "from portbench.harness.readings import host_issue_ms\n\n\n"
        "def read(r):\n    return host_issue_ms(r, 'toy_volumes')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_cfg", "source": "a test",
                             "file": "portbench/configs/toy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy_cfg",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({
        "name": "toy_items_per_s", "unit": "items/s", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": ["toy.cell"]})
    bench["per_layer"].append({
        "name": "toy_host_issue_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "step driver",
        "moves": "toy_items_per_s", "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run_cell(root, "toy.cell", trace=0, seconds=1.0)
    assert res["correct"] is True, res["checked"]
    assert res["checked"]["out_gap"]["value"] < 1e-5
    assert set(res["metrics"]) == {"toy_items_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    res = run_cell(root, "toy.cell", trace=1, seconds=1.0)
    assert res["correct"] is True, res["checked"]
    assert set(res["metrics"]) == {"toy_host_issue_ms"}

    config["family"] = "toy_cascade_fault"  # one answer altered
    (pb / "configs" / "toy_cfg.json").write_text(json.dumps(config))
    res = run_cell(root, "toy.cell", trace=0, seconds=1.0)
    assert res["correct"] is False
    assert res["checked"]["out_gap"]["value"] == pytest.approx(0.05,
                                                               rel=1e-3)

    after = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in bench_before.items():
        if isinstance(entries, list):
            assert after[key][:len(entries)] == entries
    changed = [p for p, data in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != data]
    assert changed == []
