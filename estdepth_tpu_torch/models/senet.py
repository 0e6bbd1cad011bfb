"""Squeeze-and-Excitation encoder family, the alternative matching encoder
(port of estdepth_tpu/models/senet.py; reference networks/senet.py:88-452
and networks/senet_submodule.py:9-142).

The SE module, the three SE bottlenecks (SEBottleneck, SEResNetBottleneck,
SEResNeXtBottleneck), the SENet classifier with its six constructors
(senet154, se_resnet50/101/152, se_resnext50/101_32x4d) and SEFeatureNet,
an SE-bottleneck PSM-style extractor returning the 1/2-scale (128
channels) and 1/4-scale (32 channels) maps. `DepthNetHybrid` builds
SEFeatureNet as its matching encoder under `ModelConfig.feature_net =
"senet"` and uses the 1/4-scale map.

The reference's quirks, as the JAX package keeps them: SENet's stage plane
widths (32, 32, 256, 512) and strides (2, 1, 2, 2) and no maxpool in
layer0. Pretrained Cadene weights are not downloaded (`pretrained` must be
falsy); they come through a converter (utils/convert.py).

NCHW, and every layer computes in the dtype it is given (models/layers.py:
Conv2d, Linear), so the bf16 model holds. The parameter names are the
reference SENet's (`layer0.conv1`, `layer1.0.conv2`, `layer1.0.se_module.
fc1`, `layer1.0.downsample.0`, `last_linear`). SEFeatureNet's are
inferred, since the reference's senet_submodule.py is not available: its
stem, pyramid branches and head are named as PSMFeatureNet's
(`firstconv.0/.2/.4`, `branchN.1`, `lastconv.0`, `lastconv.2`) and its
blocks as SENet's.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.models.layers import (
    Conv2d, Linear, conv_bn, he_conv,
)
from estdepth_tpu_torch.models.psm import pyramid
from estdepth_tpu_torch.ops import shard_context


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, pad: int = 0,
          groups: int = 1) -> Conv2d:
    """Conv(bias=False) with the he-normal init of the JAX kernels."""
    return he_conv(Conv2d(cin, cout, kernel, stride, pad, groups=groups,
                          bias=False))


def _bn(channels: int, zero_init: bool = False) -> nn.BatchNorm2d:
    bn = nn.BatchNorm2d(channels, eps=1e-5)
    bn.zero_init = zero_init
    return bn


class SEModule(nn.Module):
    """Global mean -> 1x1 squeeze -> ReLU -> 1x1 excite -> sigmoid gate
    (senet.py:88-107). The mean accumulates in float32 and is rounded once
    to the input's dtype, as jnp.mean does; the gate multiplies in the
    input's dtype. On a width shard (parallel/spatial.py) the float32
    per-channel sums are all-reduced over every rank's columns, divided by
    H times the whole width and rounded once."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1)
        self.fc2 = Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shards = shard_context.current()
        if shards is None:
            g = x.float().mean((2, 3), keepdim=True)
        else:
            h, w = x.shape[2:]
            g = shards.all_reduce(x.float().sum((2, 3), keepdim=True)) / (
                h * shards.full_width(w))
        g = self.fc2(F.relu(self.fc1(g.to(x.dtype))))
        return x * torch.sigmoid(g)


class _SEBlock(nn.Module):
    """conv1 1x1 -> conv2 3x3 (grouped) -> conv3 1x1 (BN scale 0 at
    init), the SE gate on the residual branch, a projection shortcut
    (`downsample`, kernel `downsample_kernel`, padding kernel // 2) where
    asked, and the post-add ReLU."""

    def __init__(self, inplanes: int, width1: int, width2: int, out: int,
                 groups: int, reduction: int, stride1: int, stride2: int,
                 downsample: bool, downsample_kernel: int):
        super().__init__()
        self.conv1 = _conv(inplanes, width1, 1, stride1)
        self.bn1 = _bn(width1)
        self.conv2 = _conv(width1, width2, 3, stride2, 1, groups)
        self.bn2 = _bn(width2)
        self.conv3 = _conv(width2, out, 1)
        self.bn3 = _bn(out, zero_init=True)
        self.relu = nn.ReLU(inplace=True)
        self.se_module = SEModule(out, reduction)
        k = downsample_kernel
        self.downsample = (nn.Sequential(
            _conv(inplanes, out, k, stride1 * stride2, k // 2), _bn(out))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.se_module(self.bn3(self.conv3(out)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(out + x)


class SEBottleneck(_SEBlock):
    """SENet-154-style bottleneck (senet_submodule.py:9-30): conv1 to
    2*planes, the grouped conv2 keeps 2*planes (4*planes with
    `wide_conv2`, senet.py:138-157) and carries the stride, conv3 to
    4*planes."""

    def __init__(self, inplanes: int, planes: int, groups: int = 32,
                 reduction: int = 16, stride: int = 1,
                 downsample: bool = False, downsample_kernel: int = 1,
                 wide_conv2: bool = False):
        super().__init__(inplanes, planes * 2,
                         planes * (4 if wide_conv2 else 2), planes * 4,
                         groups, reduction, 1, stride, downsample,
                         downsample_kernel)


class SEResNetBottleneck(_SEBlock):
    """SE-ResNet bottleneck (senet.py:162-184): Caffe-style stride on the
    1x1 conv1, mid width `planes`."""

    def __init__(self, inplanes: int, planes: int, groups: int = 1,
                 reduction: int = 16, stride: int = 1,
                 downsample: bool = False, downsample_kernel: int = 1):
        super().__init__(inplanes, planes, planes, planes * 4, groups,
                         reduction, stride, 1, downsample, downsample_kernel)


class SEResNeXtBottleneck(_SEBlock):
    """SE-ResNeXt bottleneck type C (senet.py:186-210): grouped 3x3 of
    width planes * base_width / 64 * groups, stride on conv2."""

    def __init__(self, inplanes: int, planes: int, groups: int = 32,
                 reduction: int = 16, stride: int = 1,
                 downsample: bool = False, downsample_kernel: int = 1,
                 base_width: int = 4):
        width = int(planes * base_width / 64) * groups
        super().__init__(inplanes, width, width, planes * 4, groups,
                         reduction, 1, stride, downsample, downsample_kernel)


_SENET_BLOCKS = {
    "se": SEBottleneck,
    "se_resnet": SEResNetBottleneck,
    "se_resnext": SEResNeXtBottleneck,
}


class SENet(nn.Module):
    """The SENet classifier (senet.py:213-381) in the reference's
    configuration: layer0 (three 3x3 convs or one 7x7, stride 2, no
    maxpool), four stages of plane widths (32, 32, 256, 512) and strides
    (2, 1, 2, 2), a 7x7 VALID average pool, dropout (train mode only) and
    `last_linear`. `forward(x, features_only=True)` returns the layer4
    map (SENet.features, :362-369). The head flattens channels-last, as
    the JAX package does (the same at the 1x1 map of a 224x224 input).
    The shortcut pads kernel // 2, as in the JAX package, which keeps the
    reference's `downsample_padding` as a field it does not read."""

    def __init__(self, block: str, layers: tuple, groups: int,
                 reduction: int = 16, dropout_p: float | None = 0.2,
                 inplanes: int = 128, input_3x3: bool = True,
                 downsample_kernel_size: int = 3, num_classes: int = 1000):
        super().__init__()
        if input_3x3:
            stem = [("conv1", _conv(3, 64, 3, 2, 1)), ("bn1", _bn(64)),
                    ("relu1", nn.ReLU(inplace=True)),
                    ("conv2", _conv(64, 64, 3, 1, 1)), ("bn2", _bn(64)),
                    ("relu2", nn.ReLU(inplace=True)),
                    ("conv3", _conv(64, inplanes, 3, 1, 1)),
                    ("bn3", _bn(inplanes)),
                    ("relu3", nn.ReLU(inplace=True))]
        else:
            stem = [("conv1", _conv(3, inplanes, 7, 2, 3)),
                    ("bn1", _bn(inplanes)),
                    ("relu1", nn.ReLU(inplace=True))]
        self.layer0 = nn.Sequential(OrderedDict(stem))
        block_cls = _SENET_BLOCKS[block]
        # senet.py:138-157: senet154's conv2 widens to 4*planes
        extra = {"wide_conv2": True} if block == "se" else {}
        dks = downsample_kernel_size
        stages = []
        for planes, blocks, stride, dk in ((32, layers[0], 2, 1),
                                           (32, layers[1], 1, dks),
                                           (256, layers[2], 2, dks),
                                           (512, layers[3], 2, dks)):
            ds = stride != 1 or inplanes != planes * 4
            stage = [block_cls(inplanes, planes, groups, reduction, stride,
                               ds, dk, **extra)]
            stage += [block_cls(planes * 4, planes, groups, reduction,
                                **extra) for _ in range(1, blocks)]
            stages.append(nn.Sequential(*stage))
            inplanes = planes * 4
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.dropout = nn.Dropout(dropout_p) if dropout_p is not None else None
        self.last_linear = Linear(inplanes, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer0(x)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x: torch.Tensor,
                features_only: bool = False) -> torch.Tensor:
        x = self.features(x)
        if features_only:
            return x
        x = F.avg_pool2d(x, 7, stride=1)
        if self.dropout is not None:
            x = self.dropout(x)
        return self.last_linear(x.permute(0, 2, 3, 1).flatten(1))


def _ctor(name: str, block: str, layers: tuple, groups: int, **cfg):
    def build(num_classes: int = 1000, pretrained=None, **kw) -> SENet:
        if pretrained:
            raise ValueError(
                f"{name}: pretrained weights must come through the "
                "converter (no model-zoo download); pass pretrained=None")
        return SENet(block, layers, groups, num_classes=num_classes,
                     **cfg, **kw)

    build.__name__ = name
    build.__doc__ = f"Reference constructor {name} (networks/senet.py)."
    return build


# the six reference constructors (senet.py:395-452)
_RESNET_STEM = dict(dropout_p=None, inplanes=64, input_3x3=False,
                    downsample_kernel_size=1)
senet154 = _ctor("senet154", "se", (3, 8, 36, 3), 64, dropout_p=0.2)
se_resnet50 = _ctor("se_resnet50", "se_resnet", (3, 4, 6, 3), 1,
                    **_RESNET_STEM)
se_resnet101 = _ctor("se_resnet101", "se_resnet", (3, 4, 23, 3), 1,
                     **_RESNET_STEM)
se_resnet152 = _ctor("se_resnet152", "se_resnet", (3, 8, 36, 3), 1,
                     **_RESNET_STEM)
se_resnext50_32x4d = _ctor("se_resnext50_32x4d", "se_resnext", (3, 4, 6, 3),
                           32, **_RESNET_STEM)
se_resnext101_32x4d = _ctor("se_resnext101_32x4d", "se_resnext",
                            (3, 4, 23, 3), 32, **_RESNET_STEM)


def _se_layer(inplanes: int, blocks: int, stride: int,
              downsample_kernel: int) -> nn.Sequential:
    """SEFeatureNet's stage: SEBottlenecks of 32 planes (128 channels out),
    the first with the stride and, where the shape changes, the
    projection shortcut."""
    downsample = stride != 1 or inplanes != 32 * 4
    layers = [SEBottleneck(inplanes, 32, stride=stride, downsample=downsample,
                           downsample_kernel=downsample_kernel)]
    layers += [SEBottleneck(128, 32) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class SEFeatureNet(nn.Module):
    """SE-bottleneck PSM-style extractor (senet_submodule.py:33-142):
    returns (1/2-scale 128-channel, 1/4-scale 32-channel) maps."""

    POOLS = (32, 16, 8, 4)

    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(
            conv_bn(3, 32, 3, 2), nn.ReLU(inplace=True),
            conv_bn(32, 32, 3, 1), nn.ReLU(inplace=True),
            conv_bn(32, 32, 3, 1), nn.ReLU(inplace=True),
        )
        self.layer1 = _se_layer(32, 3, 1, 1)    # 1/2, 128 channels
        self.layer2 = _se_layer(128, 3, 2, 3)   # 1/4 from here
        self.layer3 = _se_layer(128, 3, 1, 1)
        self.layer4 = _se_layer(128, 3, 1, 1)
        # index 0 stands for the average pool, which runs in forward()
        # (its window depends on the input size), as in PSMFeatureNet
        for i in range(1, 5):
            setattr(self, f"branch{i}", nn.Sequential(
                nn.Identity(), conv_bn(128, 32, 1, 1, pad=0),
                nn.ReLU(inplace=True),
            ))
        self.lastconv = nn.Sequential(
            conv_bn(384, 128, 3, 1), nn.ReLU(inplace=True),
            he_conv(Conv2d(128, 32, 1, bias=False)),
        )

    def forward(self, x: torch.Tensor):
        x = self.firstconv(x)
        feat_half = self.layer1(x)
        raw = self.layer2(feat_half)
        skip = self.layer4(self.layer3(raw))
        return feat_half, self.lastconv(pyramid(self, raw, skip))
