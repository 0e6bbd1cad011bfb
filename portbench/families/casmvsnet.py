"""CasMVSNet (Gu et al., CVPR 2020, arXiv:1912.06378): the port's
`models/casmvsnet.py:CascadeMVSNet` and its plain reference
`portbench/reference/casmvsnet.py:CascadeMVSNet`.

The configuration's `model` holds the port's `CascadeConfig`: the planes
and interval ratios of the three stages, the base planes `ndepths` and
`depth_min`, `depth_interval` in metres. The reference computes float32
alone, so `compute_dtype` is float32 or refused. `resnet`, the hybrid
family's context encoder, names nothing here and is ignored.
"""

from __future__ import annotations

from portbench.harness.weights import on_device
from portbench.reference.casmvsnet import CascadeMVSNet as Reference

# the keys of the port's CascadeConfig; the reference computes each
SETTINGS = ("stage_planes", "interval_ratios", "ndepths", "depth_min",
            "depth_interval")
IGNORED = ("resnet",)


def _settings(config: dict) -> dict:
    m = config["model"]
    unknown = set(m) - set(SETTINGS) - set(IGNORED) - {"compute_dtype"}
    if unknown:
        raise ValueError(f"the casmvsnet family takes {SETTINGS}, the "
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


def reference(config: dict, state: dict, device) -> Reference:
    settings = _settings(config)
    return on_device(lambda: Reference(**settings), state, device)


def port(config: dict, state: dict, device):
    from estdepth_tpu_torch.config import CascadeConfig
    from estdepth_tpu_torch.models.casmvsnet import CascadeMVSNet

    cfg = CascadeConfig(**_settings(config))
    return on_device(lambda: CascadeMVSNet(cfg), state, device)
