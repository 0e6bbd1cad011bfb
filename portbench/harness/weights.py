"""Random weights from the seed, made on the device in a few large calls.

A copy of the init scheme of `estdepth_tpu_torch/models/layers.py:
init_weights` (commit dd5b5eb): convolution kernels truncated-normal to two
standard deviations, he-normal (std sqrt(2 / fan_in)) where the layer is
marked `he_init` and lecun-normal (sqrt(1 / fan_in)) otherwise, divided by
the standard deviation of a unit normal truncated to [-2, 2]; biases 0;
BatchNorm scale 1 (0 where marked `zero_init`), bias 0, running mean 0,
variance 1; GroupNorm scale 1, bias 0. The marks are read from the
benchmark's reference model (a family's `structure`), whose module tree and
names are the port's. Every convolution (`nn.modules.conv._ConvNd`: the
transposed ones too) and `nn.Linear` takes a kernel. The fan-in is
PyTorch's own for the weight (`torch.nn.init`'s), `weight[0].numel()` in
both layouts: in_channels / groups x the kernel's size for a convolution's
[out, in / groups, *k], out_channels / groups x the kernel's size for a
transposed convolution's [in, out / groups, *k].
One draw of unit truncated normals for every kernel, scaled per leaf by
one multiply; the same seed gives the same weights on any run.
"""

from __future__ import annotations

import math

import torch
from torch import nn

TRUNC_STD = 0.87962566103423978


def _kernel_std(m: nn.Module) -> float:
    fan_in = m.weight[0].numel()
    return math.sqrt((2.0 if getattr(m, "he_init", False) else 1.0)
                     / fan_in) / TRUNC_STD


def make_state_dict(reference: nn.Module, seed: int,
                    device) -> dict[str, torch.Tensor]:
    """A state_dict for `reference` (and the port's model of the same
    configuration), every tensor on `device`. `reference` may live on the
    meta device: only its structure is read."""
    kernels, consts = [], {}
    for prefix, m in reference.named_modules():
        name = f"{prefix}." if prefix else ""
        if isinstance(m, (nn.modules.conv._ConvNd, nn.Linear)):
            kernels.append((name + "weight", tuple(m.weight.shape),
                            _kernel_std(m)))
            if m.bias is not None:
                consts[name + "bias"] = (tuple(m.bias.shape), 0.0)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            c = (m.num_features,)
            consts[name + "weight"] = (
                c, 0.0 if getattr(m, "zero_init", False) else 1.0)
            consts[name + "bias"] = (c, 0.0)
            consts[name + "running_mean"] = (c, 0.0)
            consts[name + "running_var"] = (c, 1.0)
            consts[name + "num_batches_tracked"] = ((), 0)
        elif isinstance(m, nn.GroupNorm):
            consts[name + "weight"] = ((m.num_channels,), 1.0)
            consts[name + "bias"] = ((m.num_channels,), 0.0)
    sizes = [math.prod(shape) for _, shape, _ in kernels]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    stds = torch.tensor([s for _, _, s in kernels], device=device)
    flat.mul_(torch.repeat_interleave(
        stds, torch.tensor(sizes, device=device)))
    out = {name: t.view(shape) for (name, shape, _), t in
           zip(kernels, flat.split(sizes))}
    for name, (shape, value) in consts.items():
        dtype = torch.long if name.endswith("num_batches_tracked") else None
        out[name] = torch.full(shape, value, dtype=dtype, device=device)
    return out


def on_device(module_fn, state: dict, device) -> nn.Module:
    """module_fn() built on the meta device (no host init), moved to
    `device` uninitialized and loaded strictly with `state`."""
    with torch.device("meta"):
        module = module_fn()
    module = module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module.eval()
