"""The weight bridge: JAX variables -> the port's state_dict.

The port's own copy of the name mapping and kernel transposes of
estdepth_tpu/utils/convert.py:216-341 (export_state_dict). The JAX
`{'params', 'batch_stats'}` tree arrives as nested dicts of numpy arrays;
the result uses the reference's torch names, which the port's modules
carry, so `model.load_state_dict(state_dict_from_jax(v))` loads JAX
weights and the result is also a reference checkpoint.

Layouts: a JAX conv kernel [kh, kw, I, O] becomes [O, I, kh, kw] and
[kd, kh, kw, I, O] becomes [O, I, kd, kh, kw]; BatchNorm scale/bias and
batch_stats mean/var become weight/bias/running_mean/running_var;
GroupNorm scale/bias become weight/bias.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _torch_conv_kernel(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return np.transpose(k, (3, 2, 0, 1))
    if k.ndim == 5:
        return np.transpose(k, (4, 3, 0, 1, 2))
    raise ValueError(f"unexpected kernel rank {k.ndim}")


# JAX PSM module names -> the reference's torch name fragments
_PSM_NAMES = {
    "firstconv_0": "firstconv.0", "firstconv_1": "firstconv.2",
    "firstconv_2": "firstconv.4",
    "branch1": "branch1.1", "branch2": "branch2.1",
    "branch3": "branch3.1", "branch4": "branch4.1",
    "lastconv_0": "lastconv.0",
}


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX {'params', 'batch_stats'} of DepthNetHybrid -> the port's
    state_dict (float32 tensors, without BatchNorm's num_batches_tracked,
    which load_state_dict fills in)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}

    def emit(prefix, node, stat_node, kind):
        if kind == "conv":
            out[f"{prefix}.weight"] = _torch_conv_kernel(
                np.asarray(node["kernel"]))
            if "bias" in node:
                out[f"{prefix}.bias"] = np.asarray(node["bias"])
        else:  # "bn" or "gn"
            out[f"{prefix}.weight"] = np.asarray(node["scale"])
            out[f"{prefix}.bias"] = np.asarray(node["bias"])
            if kind == "bn" and stat_node is not None:
                out[f"{prefix}.running_mean"] = np.asarray(stat_node["mean"])
                out[f"{prefix}.running_var"] = np.asarray(stat_node["var"])

    def convbn(base, node, stat_node):
        emit(f"{base}.0", node["conv"], None, "conv")
        emit(f"{base}.1", node["bn"],
             stat_node.get("bn") if stat_node else None, "bn")

    # matching feature (PSM)
    ms = stats.get("matching_feature", {})
    for name, node in params.get("matching_feature", {}).items():
        snode = ms.get(name, {})
        m = re.match(r"layer(\d+)_(\d+)$", name)
        if m:
            base = f"matchingFeature.layer{m.group(1)}.{m.group(2)}"
            convbn(f"{base}.conv1.0", node["conv1"], snode.get("conv1"))
            convbn(f"{base}.conv2", node["conv2"], snode.get("conv2"))
            if "downsample" in node:
                convbn(f"{base}.downsample", node["downsample"],
                       snode.get("downsample"))
        elif name == "lastconv_1":
            emit("matchingFeature.lastconv.2", node, None, "conv")
        elif name in _PSM_NAMES:
            convbn(f"matchingFeature.{_PSM_NAMES[name]}", node, snode)

    # semantic feature (torchvision resnet)
    ss = stats.get("semantic_feature", {})
    for name, node in params.get("semantic_feature", {}).items():
        snode = ss.get(name, {})
        if name == "conv1":
            emit("semanticFeature.encoder.conv1", node["conv"], None, "conv")
            emit("semanticFeature.encoder.bn1", node["bn"], snode.get("bn"),
                 "bn")
            continue
        m = re.match(r"layer(\d+)_(\d+)$", name)
        if m:
            base = f"semanticFeature.encoder.layer{m.group(1)}.{m.group(2)}"
            for ci in ("1", "2", "3"):
                key = f"conv{ci}"
                if key in node:
                    emit(f"{base}.conv{ci}", node[key]["conv"], None, "conv")
                    emit(f"{base}.bn{ci}", node[key]["bn"],
                         snode.get(key, {}).get("bn"), "bn")
            if "downsample" in node:
                convbn(f"{base}.downsample", node["downsample"],
                       snode.get("downsample"))

    # decoder
    ds = stats.get("decoder", {})
    for name, node in params.get("decoder", {}).items():
        snode = ds.get(name, {})
        if name.startswith("upconv_"):
            convbn(f"CostRegNet.{name}.conv", node["conv"], snode.get("conv"))
        elif name.startswith("dispconv_"):
            emit(f"CostRegNet.{name}", node, None, "conv")
        elif re.match(r"dres[01]_\d$", name):
            convbn(f"CostRegNet.{name[:5]}.{name[-1]}", node["conv"],
                   snode.get("conv"))
        elif name == "dres2":
            convbn("CostRegNet.dres2.0", node["conv"], snode.get("conv"))
        elif name in ("key_layer", "value_layer"):
            convbn(f"CostRegNet.{name}.0", node["conv"], snode.get("conv"))
        elif name.startswith("stereo_head"):
            convbn(f"CostRegNet.{name}.0", node["conv0"]["conv"],
                   snode.get("conv0", {}).get("conv"))
            emit(f"CostRegNet.{name}.1", node["out"], None, "conv")
        elif name == "est":
            for sub in ("gate_conv", "output_conv"):
                emit(f"CostRegNet.epipolar_transformer.{sub}", node[sub],
                     None, "conv")
            for sub in ("reset_gate_norm", "update_gate_norm",
                        "output_norm"):
                emit(f"CostRegNet.epipolar_transformer.{sub}", node[sub],
                     None, "gn")

    # cost-volume aggregation
    for name in ("pre0", "pre1", "pre2"):
        if name in params:
            convbn(name, params[name], stats.get(name, {}))

    return {k: torch.tensor(np.asarray(v), dtype=torch.float32)
            for k, v in out.items()}


def grads_from_jax(grads) -> dict[str, torch.Tensor]:
    """A JAX parameter-gradient tree (the shape of `variables['params']`)
    under the port's parameter names and layouts, so `p.grad` can be held
    against `jax.grad` name by name: the mapping of `state_dict_from_jax`
    (conv kernels transposed the same way), without batch statistics."""
    return state_dict_from_jax({"params": grads})


# The reference's parameter names the port's model carries, after the
# `module.` prefix: the name rules of the JAX package's convert_state_dict
# (estdepth_tpu/utils/convert.py:49-153), each with its leaf
_LEAF = r"\.(weight|bias|running_mean|running_var)$"
_REFERENCE_NAMES = re.compile("|".join(f"(?:{p}{_LEAF})" for p in (
    r"matchingFeature\.firstconv\.\d+\.\d+",
    r"matchingFeature\.layer\d+\.\d+\.conv1\.0\.\d+",
    r"matchingFeature\.layer\d+\.\d+\.(?:conv2|downsample)\.\d+",
    r"matchingFeature\.branch\d+\.1\.\d+",
    r"matchingFeature\.lastconv\.0\.\d+",
    r"matchingFeature\.lastconv\.2",
    r"semanticFeature\.encoder\.(?:conv1|bn1)",
    r"semanticFeature\.encoder\.layer\d+\.\d+\.(?:conv|bn)\d",
    r"semanticFeature\.encoder\.layer\d+\.\d+\.downsample\.\d+",
    r"CostRegNet\.upconv_\d_\d\.conv\.\d+",
    r"CostRegNet\.dispconv_[01]",
    r"CostRegNet\.dres[01]\.\d+\.\d+",
    r"CostRegNet\.dres2\.0\.\d+",
    r"CostRegNet\.(?:key_layer|value_layer)\.0\.\d+",
    r"CostRegNet\.stereo_head[01]\.0\.\d+",
    r"CostRegNet\.stereo_head[01]\.1",
    r"CostRegNet\.epipolar_transformer\.(?:gate_conv|output_conv"
    r"|reset_gate_norm|update_gate_norm|output_norm)",
    r"pre[012]\.\d+",
)))


def load_reference_checkpoint(path: str, strict: bool = True):
    """A reference checkpoint file (`torch.save({'epoch', 'model',
    'optimizer'})`, the reference's train_hybrid.py:137-151, or a bare
    state_dict) -> (state_dict for DepthNetHybrid.load_state_dict, the
    names it could not place).

    The counterpart of the JAX package's load_torch_checkpoint and
    convert_state_dict (estdepth_tpu/utils/convert.py:156-213, 344-350):
    the DDP `module.` prefix is stripped, BatchNorm's num_batches_tracked
    and the ResNet classifier head `fc.` are dropped, and any other name
    outside the model's raises a KeyError under `strict`. The file is read
    with `weights_only=True` (tensors, numbers and containers only)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model", blob) if isinstance(blob, dict) else blob
    out, unmatched = {}, []
    for key, value in state.items():
        name = key[len("module."):] if key.startswith("module.") else key
        if (name.endswith("num_batches_tracked")
                or name.startswith("semanticFeature.encoder.fc.")):
            continue
        if _REFERENCE_NAMES.fullmatch(name):
            out[name] = value
        else:
            unmatched.append(key)
    if unmatched and strict:
        raise KeyError(f"unmatched torch keys ({len(unmatched)}): "
                       f"{unmatched[:10]} ...")
    return out, unmatched
