"""The hybrid ESTDepth network (Long et al., CVPR 2021): the port's
`models/estdepth.py:DepthNetHybrid` and its plain reference
`portbench/reference/model.py:DepthNetHybrid`. The family of every
configuration that names none.

The configuration's `model` holds the port's `ModelConfig`. The reference
computes one warp and one fusion order, in float32 (REFERENCE_SETTINGS); a
setting that changes that mathematics needs another reference and is
refused. The compute dtype is not among them: a bfloat16 port is held
against the float32 reference, as any lower precision is.
"""

from __future__ import annotations

from portbench.harness.weights import on_device
from portbench.reference.model import DepthNetHybrid as Reference

# the port settings the reference computes; another value needs another
# reference
REFERENCE_SETTINGS = {"est_transformer": True,
                      "frustum_mode": "plane_mix_exact_z",
                      "sequential_fusion": True, "two_pass_warp": False,
                      "use_fused_attention": False,
                      "sequential_cost_bn": False}
# the port's compute dtypes, each held against the float32 reference
COMPUTE_DTYPES = ("float32", "bfloat16")


def _reference_fn(config: dict):
    m = config["model"]
    for key, want in REFERENCE_SETTINGS.items():
        if m.get(key, want) != want:
            raise ValueError(f"the reference computes {key}={want!r}, the "
                             f"configuration asks for {m[key]!r}")
    if m.get("compute_dtype", "float32") not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {m['compute_dtype']!r} is none of "
                         f"{COMPUTE_DTYPES}")
    return lambda: Reference(m["feature_net"], m["ndepths"],
                             m["depth_min"], m["depth_max"], m["resnet"])


def structure(config: dict) -> Reference:
    return _reference_fn(config)()


def reference(config: dict, state: dict, device) -> Reference:
    return on_device(_reference_fn(config), state, device)


def port(config: dict, state: dict, device):
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    cfg = ModelConfig(**config["model"])
    return on_device(lambda: DepthNetHybrid(cfg), state, device)
