"""VGGT (Wang et al., CVPR 2025, arXiv:2503.11347): the port's
`models/vggt.py:VGGT` and its plain reference
`portbench/reference/vggt.py:VGGT`.

The configuration's `model` holds the port's `VGGTConfig`. The reference
computes every setting in SETTINGS; `compute_dtype` (the port's autocast
dtype, bfloat16 or float32) is the port's alone, and the reference
computes float32 whichever is set. `mlp_ratio` is 4 or refused.
`ndepths` and `resnet`, the other families' settings, name nothing here
and are ignored.

The seed's state_dict (harness/weights.py) covers convolutions and linear
layers. The entries it leaves out are filled here, the same for the port
and the reference: LayerNorms at scale 1, bias 0; every LayerScale at 1.0
(the configuration's `assumed`: trained blocks contribute at full scale,
where the published inits of 0.01 would let random blocks hide a broken
attention from the check); the class, register, camera and empty-pose
tokens and DINOv2's position embedding drawn from a unit normal by a
generator seeded with a digest of the seed's patch-embedding kernel, so
that they follow the seed.
"""

from __future__ import annotations

import hashlib

import torch
from torch import nn

from portbench.harness.weights import on_device
from portbench.reference.vggt import VGGT as Reference
from portbench.reference.vggt import LayerScale

# the keys of the port's VGGTConfig that the reference computes
SETTINGS = ("img_height", "img_width", "patch_size", "embed_dim",
            "num_heads", "num_register_tokens", "dino_depth", "aa_depth",
            "pos_embed_grid", "rope_frequency", "camera_trunk_depth",
            "camera_iterations", "dpt_features", "dpt_out_channels",
            "dpt_layers")
PORT_ONLY = ("compute_dtype",)
IGNORED = ("ndepths", "resnet")
TOKENS = ("cls_token", "register_tokens", "pos_embed", "camera_token",
          "register_token", "empty_pose_tokens")
DIGEST_OF = "aggregator.patch_embed.patch_embed.proj.weight"


def _model(config: dict) -> dict:
    m = config["model"]
    unknown = (set(m) - set(SETTINGS) - set(PORT_ONLY) - set(IGNORED)
               - {"mlp_ratio"})
    if unknown:
        raise ValueError(f"the vggt family takes {SETTINGS + PORT_ONLY}, "
                         f"the configuration also names {sorted(unknown)}")
    if m.get("mlp_ratio", 4.0) != 4.0:
        raise ValueError(f"mlp_ratio {m['mlp_ratio']}: the reference's "
                         f"MLPs are 4 wide")
    if m.get("compute_dtype", "bfloat16") not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype {m['compute_dtype']!r}: bfloat16 "
                         f"(autocast) or float32")
    missing = set(SETTINGS) - set(m)
    if missing:
        raise ValueError(f"the vggt family needs {sorted(missing)}")
    return m


def _settings(config: dict) -> dict:
    m = _model(config)
    return {k: tuple(m[k]) if isinstance(m[k], list) else m[k]
            for k in SETTINGS}


def structure(config: dict) -> Reference:
    return Reference(**_settings(config))


def _with_rest(config: dict, state: dict) -> dict:
    """`state` with the LayerNorm, LayerScale and token entries that the
    seed's state_dict leaves out."""
    with torch.device("meta"):
        tree = structure(config)
    device = state[DIGEST_OF].device
    kernel = state[DIGEST_OF].reshape(-1)[:64].cpu().numpy().tobytes()
    gen = torch.Generator(device=device).manual_seed(
        int.from_bytes(hashlib.sha256(kernel).digest()[:7], "little"))
    out = dict(state)
    for prefix, m in tree.named_modules():
        name = f"{prefix}." if prefix else ""
        if isinstance(m, nn.LayerNorm) and m.elementwise_affine:
            out.setdefault(name + "weight",
                           torch.ones(m.weight.shape, device=device))
            out.setdefault(name + "bias",
                           torch.zeros(m.bias.shape, device=device))
        elif isinstance(m, LayerScale):
            out.setdefault(name + "gamma",
                           torch.ones(m.gamma.shape, device=device))
        for token in TOKENS:
            p = m._parameters.get(token)
            if p is not None:
                out.setdefault(name + token, torch.randn(
                    p.shape, generator=gen, device=device))
    return out


def reference(config: dict, state: dict, device) -> Reference:
    settings = _settings(config)
    return on_device(lambda: Reference(**settings),
                     _with_rest(config, state), device)


def port(config: dict, state: dict, device):
    from estdepth_tpu_torch.config import VGGTConfig
    from estdepth_tpu_torch.models.vggt import VGGT

    m = _model(config)
    cfg = VGGTConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in m.items() if k not in IGNORED})
    return on_device(lambda: VGGT(cfg), _with_rest(config, state), device)
