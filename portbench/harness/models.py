"""The port's model and the reference, both from a configuration's file,
with the same weights from the seed."""

from __future__ import annotations

import torch

from portbench.harness.weights import make_state_dict, on_device
from portbench.reference.model import DepthNetHybrid as Reference

# the port settings the reference computes; another value needs another
# reference
REFERENCE_SETTINGS = {"est_transformer": True,
                      "frustum_mode": "plane_mix_exact_z",
                      "sequential_fusion": True, "two_pass_warp": False,
                      "use_fused_attention": False,
                      "sequential_cost_bn": False,
                      "compute_dtype": "float32"}


def set_numerics(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _reference_fn(config: dict):
    m = config["model"]
    for key, want in REFERENCE_SETTINGS.items():
        if m.get(key, want) != want:
            raise ValueError(f"the reference computes {key}={want!r}, the "
                             f"configuration asks for {m[key]!r}")
    return lambda: Reference(m["feature_net"], m["ndepths"],
                             m["depth_min"], m["depth_max"], m["resnet"])


def weights(config: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        structure = _reference_fn(config)()
    return make_state_dict(structure, seed, device)


def reference(config: dict, state: dict, device) -> Reference:
    return on_device(_reference_fn(config), state, device)


def port(config: dict, state: dict, device):
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    cfg = ModelConfig(**config["model"])
    return on_device(lambda: DepthNetHybrid(cfg), state, device)
