"""TransMVSNet (Ding et al., CVPR 2022, arXiv:2111.14600): the port's
`models/transmvsnet.py:TransMVSNet` and its plain reference
`portbench/reference/transmvsnet.py:TransMVSNet`.

The configuration's `model` holds the port's `CascadeConfig`, as the
casmvsnet family's: the planes and interval ratios of the three stages,
the base planes `ndepths` and `depth_min`, `depth_interval` in metres.
The reference computes float32 alone, so `compute_dtype` is float32 or
refused. `resnet`, the hybrid family's context encoder, names nothing
here and is ignored.

The seed's state_dict (harness/weights.py) covers convolutions, linear
layers and 2D / 3D BatchNorm; the FMT's LayerNorms and the position
encoder's BatchNorm1d get the same scheme's constants for norms here
(scale 1, bias 0, running mean 0, variance 1), the same for the port and
the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.harness.weights import on_device
from portbench.reference.transmvsnet import TransMVSNet as Reference

# the keys of the port's CascadeConfig; the reference computes each
SETTINGS = ("stage_planes", "interval_ratios", "ndepths", "depth_min",
            "depth_interval")
IGNORED = ("resnet",)


def _settings(config: dict) -> dict:
    m = config["model"]
    unknown = set(m) - set(SETTINGS) - set(IGNORED) - {"compute_dtype"}
    if unknown:
        raise ValueError(f"the transmvsnet family takes {SETTINGS}, the "
                         f"configuration also names {sorted(unknown)}")
    if m.get("compute_dtype", "float32") != "float32":
        raise ValueError(f"compute_dtype {m['compute_dtype']!r}: the "
                         f"reference computes float32")
    planes = tuple(m["stage_planes"])
    if len(planes) != 3 or any(d % 8 for d in planes):
        raise ValueError(f"stage_planes {planes}: three stages, each a "
                         f"multiple of 8")
    return {k: tuple(m[k]) if isinstance(m[k], list) else m[k]
            for k in SETTINGS}


def structure(config: dict) -> Reference:
    return Reference(**_settings(config))


def _with_norms(config: dict, state: dict) -> dict:
    """`state` with the entries of the LayerNorms and BatchNorm1d layers
    that the seed's state_dict leaves out."""
    with torch.device("meta"):
        tree = structure(config)
    device = next(iter(state.values())).device
    out = dict(state)
    for prefix, m in tree.named_modules():
        consts = {}
        if isinstance(m, nn.LayerNorm):
            consts = {"weight": 1.0, "bias": 0.0}
        elif isinstance(m, nn.BatchNorm1d):
            consts = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
                      "running_var": 1.0}
            out.setdefault(f"{prefix}.num_batches_tracked",
                           torch.zeros((), dtype=torch.long, device=device))
        for name, value in consts.items():
            shape = getattr(m, name).shape
            out.setdefault(f"{prefix}.{name}",
                           torch.full(shape, value, device=device))
    return out


def reference(config: dict, state: dict, device) -> Reference:
    settings = _settings(config)
    return on_device(lambda: Reference(**settings),
                     _with_norms(config, state), device)


def port(config: dict, state: dict, device):
    from estdepth_tpu_torch.config import CascadeConfig
    from estdepth_tpu_torch.models.transmvsnet import TransMVSNet

    cfg = CascadeConfig(**_settings(config))
    return on_device(lambda: TransMVSNet(cfg), _with_norms(config, state),
                     device)
