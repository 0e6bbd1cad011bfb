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

It also imports ImageNet-pretrained torchvision ResNet weights as the
context encoder's initialization (the counterpart of
convert_torchvision_resnet and load_pretrained_encoder,
estdepth_tpu/utils/convert.py:353-384): from a torchvision `.pth`, or from
the `.npz` that tools/import_torchvision.py of either package writes, whose
names are the JAX tree's `params/...` and `batch_stats/...` paths.
"""

from __future__ import annotations

import re

import numpy as np
import torch

ENCODER_PREFIX = "semanticFeature.encoder."


def _torch_conv_kernel(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return np.transpose(k, (3, 2, 0, 1))
    if k.ndim == 5:
        return np.transpose(k, (4, 3, 0, 1, 2))
    raise ValueError(f"unexpected kernel rank {k.ndim}")


# JAX PSM module names -> the reference's torch name fragments; the
# SEFeatureNet's stem, branches and head carry the same names
_PSM_NAMES = {
    "firstconv_0": "firstconv.0", "firstconv_1": "firstconv.2",
    "firstconv_2": "firstconv.4",
    "branch1": "branch1.1", "branch2": "branch2.1",
    "branch3": "branch3.1", "branch4": "branch4.1",
    "lastconv_0": "lastconv.0",
}


def _emit(out: dict, prefix: str, node, stat_node, kind: str) -> None:
    """One JAX conv ("conv"), BatchNorm ("bn") or GroupNorm ("gn") under
    the torch prefix."""
    if kind == "conv":
        out[f"{prefix}.weight"] = _torch_conv_kernel(np.asarray(node["kernel"]))
        if "bias" in node:
            out[f"{prefix}.bias"] = np.asarray(node["bias"])
    else:
        out[f"{prefix}.weight"] = np.asarray(node["scale"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"])
        if kind == "bn" and stat_node is not None:
            out[f"{prefix}.running_mean"] = np.asarray(stat_node["mean"])
            out[f"{prefix}.running_var"] = np.asarray(stat_node["var"])


def _convbn(out: dict, base: str, node, stat_node) -> None:
    """A JAX ConvBN -> the torch `nn.Sequential(conv, bn)` `{base}.0/.1`."""
    _emit(out, f"{base}.0", node["conv"], None, "conv")
    _emit(out, f"{base}.1", node["bn"],
          stat_node.get("bn") if stat_node else None, "bn")


def _block(out: dict, base: str, node, stat_node) -> None:
    """A bottleneck's JAX tree -> `{base}.conv{i}/.bn{i}`,
    `.se_module.fc1/.fc2` and `.downsample.0/.1`: the names of
    torchvision's ResNet blocks and of the reference SENet's (and
    tests/test_senet.py's mapping). An SE block's conv2 is a plain conv
    with its own bn2; every other conv{i} is a ConvBN."""
    stat_node = stat_node or {}
    for i in "123":
        key = f"conv{i}"
        if key not in node:
            continue
        if "kernel" in node[key]:
            _emit(out, f"{base}.{key}", node[key], None, "conv")
            _emit(out, f"{base}.bn{i}", node[f"bn{i}"],
                  stat_node.get(f"bn{i}"), "bn")
        else:
            _emit(out, f"{base}.{key}", node[key]["conv"], None, "conv")
            _emit(out, f"{base}.bn{i}", node[key]["bn"],
                  stat_node.get(key, {}).get("bn"), "bn")
    for fc in ("fc1", "fc2") if "se" in node else ():
        _emit(out, f"{base}.se_module.{fc}", node["se"][fc], None, "conv")
    if "downsample" in node:
        _convbn(out, f"{base}.downsample", node["downsample"],
                stat_node.get("downsample"))


def _tensors(out: dict) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32)
            for k, v in out.items()}


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX {'params', 'batch_stats'} of DepthNetHybrid -> the port's
    state_dict (float32 tensors, without BatchNorm's num_batches_tracked,
    which load_state_dict fills in). Either matching encoder: PSM's blocks
    or SEFeatureNet's SE blocks."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}

    # matching feature (PSM or SEFeatureNet)
    ms = stats.get("matching_feature", {})
    for name, node in params.get("matching_feature", {}).items():
        snode = ms.get(name, {})
        m = re.match(r"layer(\d+)_(\d+)$", name)
        if m and "se" in node:
            _block(out, f"matchingFeature.layer{m.group(1)}.{m.group(2)}",
                   node, snode)
        elif m:
            base = f"matchingFeature.layer{m.group(1)}.{m.group(2)}"
            _convbn(out, f"{base}.conv1.0", node["conv1"], snode.get("conv1"))
            _convbn(out, f"{base}.conv2", node["conv2"], snode.get("conv2"))
            if "downsample" in node:
                _convbn(out, f"{base}.downsample", node["downsample"],
                        snode.get("downsample"))
        elif name == "lastconv_1":
            _emit(out, "matchingFeature.lastconv.2", node, None, "conv")
        elif name in _PSM_NAMES:
            _convbn(out, f"matchingFeature.{_PSM_NAMES[name]}", node, snode)

    # semantic feature (torchvision resnet)
    ss = stats.get("semantic_feature", {})
    for name, node in params.get("semantic_feature", {}).items():
        snode = ss.get(name, {})
        if name == "conv1":
            _emit(out, "semanticFeature.encoder.conv1", node["conv"], None,
                  "conv")
            _emit(out, "semanticFeature.encoder.bn1", node["bn"],
                  snode.get("bn"), "bn")
            continue
        m = re.match(r"layer(\d+)_(\d+)$", name)
        if m:
            _block(out, f"semanticFeature.encoder.layer{m.group(1)}."
                   f"{m.group(2)}", node, snode)

    # decoder
    ds = stats.get("decoder", {})
    for name, node in params.get("decoder", {}).items():
        snode = ds.get(name, {})
        if name.startswith("upconv_"):
            _convbn(out, f"CostRegNet.{name}.conv", node["conv"],
                    snode.get("conv"))
        elif name.startswith("dispconv_"):
            _emit(out, f"CostRegNet.{name}", node, None, "conv")
        elif re.match(r"dres[01]_\d$", name):
            _convbn(out, f"CostRegNet.{name[:5]}.{name[-1]}", node["conv"],
                    snode.get("conv"))
        elif name == "dres2":
            _convbn(out, "CostRegNet.dres2.0", node["conv"],
                    snode.get("conv"))
        elif name in ("key_layer", "value_layer"):
            _convbn(out, f"CostRegNet.{name}.0", node["conv"],
                    snode.get("conv"))
        elif name.startswith("stereo_head"):
            _convbn(out, f"CostRegNet.{name}.0", node["conv0"]["conv"],
                    snode.get("conv0", {}).get("conv"))
            _emit(out, f"CostRegNet.{name}.1", node["out"], None, "conv")
        elif name == "est":
            for sub in ("gate_conv", "output_conv"):
                _emit(out, f"CostRegNet.epipolar_transformer.{sub}",
                      node[sub], None, "conv")
            for sub in ("reset_gate_norm", "update_gate_norm",
                        "output_norm"):
                _emit(out, f"CostRegNet.epipolar_transformer.{sub}",
                      node[sub], None, "gn")

    # cost-volume aggregation
    for name in ("pre0", "pre1", "pre2"):
        if name in params:
            _convbn(out, name, params[name], stats.get(name, {}))

    return _tensors(out)


def senet_state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX {'params', 'batch_stats'} of an `SENet` classifier -> the state
    dict of the port's (models/senet.py) and the reference's SENet:
    `layer0.convN/bnN`, `layerK.i.conv1..3/bn1..3`, `downsample.0/.1`,
    `se_module.fc1/fc2` and `last_linear` (absent from a tree initialised
    with features_only). The port's own copy of tests/test_senet.py's
    mapping."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    for name, node in params.items():
        snode = stats.get(name, {})
        m = re.match(r"layer0_conv(\d)$", name)
        if m:
            i = m.group(1)
            _emit(out, f"layer0.conv{i}", node["conv"], None, "conv")
            _emit(out, f"layer0.bn{i}", node["bn"], snode.get("bn"), "bn")
            continue
        m = re.match(r"layer(\d)_(\d+)$", name)
        if m:
            _block(out, f"layer{m.group(1)}.{m.group(2)}", node, snode)
        elif name == "last_linear":
            out["last_linear.weight"] = np.transpose(np.asarray(node["kernel"]))
            out["last_linear.bias"] = np.asarray(node["bias"])
    return _tensors(out)


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
    r"matchingFeature\.layer\d+\.\d+\.(?:conv|bn)\d",
    r"matchingFeature\.layer\d+\.\d+\.se_module\.fc[12]",
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


# torchvision resnet names -> (the JAX encoder subtree's module path, the
# torch leaf): conv1/bn1 are the stem's ConvBN, convK/bnK the block's
# ConvBN "convK", downsample.0/.1 its "downsample" ConvBN
_TORCHVISION_RULES = (
    (r"conv1\.(weight)", ("conv1", "conv")),
    (r"bn1\.(\w+)", ("conv1", "bn")),
    (r"layer(\d)\.(\d+)\.conv(\d)\.(weight)",
     ("layer{0}_{1}", "conv{2}", "conv")),
    (r"layer(\d)\.(\d+)\.bn(\d)\.(\w+)", ("layer{0}_{1}", "conv{2}", "bn")),
    (r"layer(\d)\.(\d+)\.downsample\.0\.(weight)",
     ("layer{0}_{1}", "downsample", "conv")),
    (r"layer(\d)\.(\d+)\.downsample\.1\.(\w+)",
     ("layer{0}_{1}", "downsample", "bn")),
)
_JAX_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var")}


def _torchvision_encoder_items(state_dict):
    """(name, tensor) of a torchvision resnet state_dict (bare or under
    "state_dict"), without the classifier head `fc.`."""
    state = state_dict.get("state_dict", state_dict)
    for name, value in state.items():
        if not name.startswith("fc."):
            yield name, torch.as_tensor(value)


def convert_torchvision_resnet(state_dict) -> dict[str, np.ndarray]:
    """A torchvision resnet{18,34,50,101,152} state_dict -> the arrays of
    the JAX `semantic_feature` subtree under their flattened paths
    (`params/layer1_0/conv1/conv/kernel`, `batch_stats/conv1/bn/mean`):
    what the JAX package's flatten_tree(convert_torchvision_resnet(...))
    gives, and what tools/import_torchvision.py writes. The classifier head
    and num_batches_tracked are dropped; any other unknown name raises."""
    out = {}
    for name, value in _torchvision_encoder_items(state_dict):
        if name.endswith("num_batches_tracked"):
            continue
        for pattern, path in _TORCHVISION_RULES:
            m = re.fullmatch(pattern, name)
            if m:
                break
        else:
            raise KeyError(f"not a torchvision resnet name: {name}")
        *groups, leaf = m.groups()
        module = "/".join(p.format(*groups) for p in path)
        arr = value.detach().cpu().numpy()
        if arr.ndim == 4:  # a conv weight
            out[f"params/{module}/kernel"] = np.transpose(arr, (2, 3, 1, 0))
        else:
            root, jax_leaf = _JAX_LEAF[leaf]
            out[f"{root}/{module}/{jax_leaf}"] = arr
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


def load_pretrained_encoder(path: str) -> dict[str, torch.Tensor]:
    """The `semanticFeature.encoder.*` tensors of the port's model from a
    torchvision resnet `.pth` (read with `weights_only=True`; the
    classifier head dropped, num_batches_tracked kept) or from a `.npz` of
    the JAX tree's paths (tools/import_torchvision.py of either package).
    Load them with utils/checkpoint.partial_restore."""
    if path.endswith(".npz"):
        with np.load(path) as npz:
            tree = _unflatten(dict(npz))
        sd = state_dict_from_jax({
            "params": {"semantic_feature": tree.get("params", {})},
            "batch_stats": {"semantic_feature": tree.get("batch_stats", {})},
        })
        return {k: v for k, v in sd.items() if k.startswith(ENCODER_PREFIX)}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return {ENCODER_PREFIX + name: value
            for name, value in _torchvision_encoder_items(blob)}
