"""Conv/BN building blocks and the JAX package's init scheme (port of
estdepth_tpu/models/layers.py).

Modules here are NCHW / NCDHW. `conv_bn` is the reference's convbn
(layers_op.py:10-39): an `nn.Sequential(conv, bn)` so that state_dict names
are `<name>.0.weight` and `<name>.1.*`, the names
estdepth_tpu/utils/convert.py:export_state_dict emits. BatchNorm is
`nn.BatchNorm2d/3d` (eps 1e-5, momentum 0.1), whose train mode is the JAX
package's TorchBatchNorm: the biased batch variance normalizes, the
unbiased one updates `running_var`. In eval mode (the model's resting
state) it normalizes with the running statistics. `convert_sync_batchnorm`
swaps every BatchNorm for `SyncBatchNorm2d/3d`, the JAX package's
TorchBatchNorm(axis_name="data"): statistics averaged over a data mesh.

The JAX package's TPU re-expressions of the 3D conv (Decomp3DConv,
PackedConv3D, conv3d_as2d) bind the same parameters as a plain conv3d and
compute the same function; the port uses `nn.Conv3d`.

Inside `width_sharded` (ops/shard_context.py) the input's width axis (the
last) is one rank's shard: `Conv2d`/`Conv3d` and `MaxPool2d` widen it by
halo columns of the neighbouring ranks and pad only the other axes, and
`GroupNorm` takes its statistics over every rank's columns. Outside it
they compute what they always did.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.ops import shard_context

# flax's truncated-normal variance scaling divides the normal's stddev by
# the stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _conv_in_input_dtype(conv, x: torch.Tensor) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    weight = conv.weight.to(x.dtype)
    shards = shard_context.current()
    if shards is None:
        return conv._conv_forward(x, weight, bias)
    # a width shard: its neighbours' columns (zeros past the image's
    # edges) in place of the width padding
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise ValueError(f"{conv}: width sharding takes explicit zero "
                         f"padding")
    left, right = shard_context.conv_halo(
        conv.kernel_size[-1], conv.stride[-1], conv.padding[-1],
        conv.dilation[-1])
    x = shards.halo(x, -1, left, right)
    fn = F.conv2d if x.dim() == 4 else F.conv3d
    return fn(x, weight, bias, conv.stride, (*conv.padding[:-1], 0),
              conv.dilation, conv.groups)


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's dtype; float32 parameters."""

    forward = _conv_in_input_dtype


class Conv3d(nn.Conv3d):
    """nn.Conv3d in its input's dtype; float32 parameters."""

    forward = _conv_in_input_dtype


class Linear(nn.Linear):
    """nn.Linear in its input's dtype; float32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm computed in float32, returned in its input's dtype.
    On a width shard the float32 statistics span every rank's columns:
    the per-sample, per-group sum all-reduced for the mean, then the sum
    of squares about that mean for the (biased) variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shards = shard_context.current()
        if shards is None:
            return super().forward(x.float()).to(x.dtype)
        n, c = x.shape[:2]
        g = self.num_groups
        xf = x.float().reshape(n, g, -1)
        count = xf.shape[-1] // x.shape[-1] * shards.full_width(x.shape[-1])
        mean = shards.all_reduce(xf.sum(-1)) / count
        xc = xf - mean[..., None]
        var = shards.all_reduce(xc.square().sum(-1)) / count
        y = (xc * torch.rsqrt(var + self.eps)[..., None]).reshape(x.shape)
        shape = [1, c] + [1] * (x.dim() - 2)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class MaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d; on a width shard its width padding (-inf) becomes
    halo columns of the neighbouring ranks, -inf past the image's
    edges."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shards = shard_context.current()
        if shards is None:
            return super().forward(x)
        k, s, p, dl = (v if isinstance(v, int) else v[-1] for v in (
            self.kernel_size, self.stride, self.padding, self.dilation))
        if self.ceil_mode:
            raise ValueError("width sharding takes ceil_mode=False")
        x = shards.halo(x, -1, *shard_context.conv_halo(k, s, p, dl),
                        value=float("-inf"))
        pad_h = self.padding if isinstance(self.padding, int) else (
            self.padding[0])
        return F.max_pool2d(x, self.kernel_size, self.stride, (pad_h, 0),
                            self.dilation)


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1,
            pad: int | None = None, dilation: int = 1, dims: int = 2,
            zero_bn_scale: bool = False, act: str | None = None
            ) -> nn.Sequential:
    """Conv(bias=False) + BatchNorm (+ ReLU or tanh).

    The padding defaults to kernel // 2, and a dilation > 1 forces
    pad = dilation (layers_op.py:12). `zero_bn_scale` starts the BN scale
    at 0 so a residual branch starts as the identity."""
    pad = kernel // 2 if pad is None else pad
    if dilation > 1:
        pad = dilation
    conv_cls, bn_cls = ((Conv2d, nn.BatchNorm2d) if dims == 2
                        else (Conv3d, nn.BatchNorm3d))
    conv = conv_cls(cin, cout, kernel, stride, pad, dilation, bias=False)
    conv.he_init = True
    bn = bn_cls(cout, eps=1e-5)
    bn.zero_init = zero_bn_scale
    layers = [conv, bn]
    if act == "relu":
        layers.append(nn.ReLU(inplace=True))
    elif act == "tanh":
        layers.append(nn.Tanh())
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return nn.Sequential(*layers)


class _SyncBatchNorm:
    """Train mode as the JAX package's TorchBatchNorm with `axis_name`
    (estdepth_tpu/models/layers.py:73-92): the float32 mean and mean of
    squares of this rank's input, averaged over `mesh` by one
    differentiable all-reduce of [mean, mean2] (none without a mesh), var
    = max(mean2 - mean^2, 0), the running variance updated with Bessel's
    n / (n - 1) over the global count, momentum 0.1; the output computed
    in float32 and rounded once to the input's dtype. Eval mode is
    nn.BatchNorm's, on the running statistics. Subclasses of
    nn.BatchNorm2d/3d with the same parameters and buffers, so the
    state_dict names do not change."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        xf = x.float()
        mean, mean2 = xf.mean(dims), xf.square().mean(dims)
        n = x.numel() // x.shape[1]
        if self.mesh is not None:
            mean, mean2 = self.mesh.pmean(torch.cat([mean, mean2])).chunk(2)
            n *= self.mesh.size
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class SyncBatchNorm2d(_SyncBatchNorm, nn.BatchNorm2d):
    pass


class SyncBatchNorm3d(_SyncBatchNorm, nn.BatchNorm3d):
    pass


def convert_sync_batchnorm(module: nn.Module, mesh=None) -> nn.Module:
    """Swap every nn.BatchNorm2d/3d under `module` for SyncBatchNorm2d/3d
    over `mesh` (parallel.mesh.Mesh; None: this process's statistics),
    in place and keeping the same parameter and buffer tensors, so an
    optimizer made before, the state_dict names and a checkpoint are
    unchanged. Returns `module`."""
    for name, child in module.named_children():
        if isinstance(child, _SyncBatchNorm):
            child.mesh = mesh
        elif isinstance(child, (nn.BatchNorm2d, nn.BatchNorm3d)):
            cls = (SyncBatchNorm2d if isinstance(child, nn.BatchNorm2d)
                   else SyncBatchNorm3d)
            new = cls(child.num_features, eps=child.eps,
                      momentum=child.momentum)
            new.weight, new.bias = child.weight, child.bias
            for buf in ("running_mean", "running_var", "num_batches_tracked"):
                setattr(new, buf, getattr(child, buf))
            if hasattr(child, "zero_init"):
                new.zero_init = child.zero_init
            new.train(child.training)
            new.mesh = mesh
            setattr(module, name, new)
        else:
            convert_sync_batchnorm(child, mesh)
    return module


def he_conv(conv: nn.Module) -> nn.Module:
    """Mark a plain conv for the he-normal init of the JAX ConvBN kernels."""
    conv.he_init = True
    return conv


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's random init: conv kernels truncated-normal
    he-normal (ConvBN) or lecun-normal (plain convs and dense layers),
    biases 0; BatchNorm
    scale 1 (0 under zero_bn_scale), bias 0, running mean 0 and var 1;
    GroupNorm scale 1, bias 0. The numbers differ from JAX's (another
    generator); the scheme is the same, which keeps a full-depth
    random-weight forward finite."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = m.weight[0].numel()
                scale = 2.0 if getattr(m, "he_init", False) else 1.0
                std = math.sqrt(scale / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.weight.fill_(0.0 if getattr(m, "zero_init", False) else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest x`factor` upsample of [N, C, H, W] (a repeat for an integer
    factor, hybrid_depth_decoder.py:11-14)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Half-pixel bilinear resize of [N, C, H, W] (align_corners=False),
    torch-1.2 F.upsample(mode='bilinear') (psm_submodule.py:101-110)."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)

