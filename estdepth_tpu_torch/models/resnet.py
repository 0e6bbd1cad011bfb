"""ResNet context encoder 18/34/50/101/152, torchvision layout (port of
estdepth_tpu/models/resnet.py; reference resnet_encoder.py:17-51).

Returns the 5 post-ReLU feature maps [relu(bn1(conv1)), layer1..layer4]
at strides 2/4/8/16/32 (NCHW). The 7x7 stem is followed by a 3x3/2
max-pool padded with -inf (on a width shard: halo columns,
models/layers.MaxPool2d). The torchvision classification head is absent
(the reference never calls it), so the encoder's names are exactly those
export_state_dict emits under `semanticFeature.encoder`.
"""

from __future__ import annotations

import torch
from torch import nn

from estdepth_tpu_torch.models.layers import (
    Conv2d, MaxPool2d, conv_bn, he_conv,
)

_STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv(cin, cout, kernel, stride=1):
    return he_conv(Conv2d(cin, cout, kernel, stride, kernel // 2,
                          bias=False))


def _bn(c, zero=False):
    bn = nn.BatchNorm2d(c, eps=1e-5)
    bn.zero_init = zero
    return bn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, downsample):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes, zero=True)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (conv_bn(inplanes, planes, 1, stride, pad=0)
                           if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(out + x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) with post-add ReLU (torchvision v1.5)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride, downsample):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4, zero=True)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (conv_bn(inplanes, planes * 4, 1, stride, pad=0)
                           if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(out + x)


class _ResNet(nn.Module):
    def __init__(self, depth: int):
        super().__init__()
        kind, stages = _STAGES[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d(3, 2, 1)
        inplanes, planes = 64, 64
        for stage_i, blocks in enumerate(stages):
            stride = 1 if stage_i == 0 else 2
            layers = []
            for block_i in range(blocks):
                s = stride if block_i == 0 else 1
                ds = block_i == 0 and (s != 1
                                       or inplanes != planes * block.expansion)
                layers.append(block(inplanes, planes, s, ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage_i + 1}", nn.Sequential(*layers))
            planes *= 2


class ResNetEncoder(nn.Module):
    """Context encoder; `num_ch_enc` are the 5 maps' channel counts."""

    def __init__(self, depth: int = 50):
        super().__init__()
        if depth not in _STAGES:
            raise ValueError(f"resnet depth {depth} is not one of "
                             f"{sorted(_STAGES)}")
        mult = 4 if depth > 34 else 1
        self.num_ch_enc = (64, 64 * mult, 128 * mult, 256 * mult, 512 * mult)
        self.encoder = _ResNet(depth)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        e = self.encoder
        x = e.relu(e.bn1(e.conv1(x)))
        feats = [x]
        x = e.maxpool(x)
        for i in range(1, 5):
            x = getattr(e, f"layer{i}")(x)
            feats.append(x)
        return feats
