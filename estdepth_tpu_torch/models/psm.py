"""PSMNet-style matching feature extractor (port of
estdepth_tpu/models/psm.py; reference psm_submodule.py:40-116).

A stride-4, 32-channel feature map per image from residual conv stacks and
a 4-branch spatial-pyramid-pooling head. The output has no trailing
BN/ReLU. NCHW; parameter names are the reference's (`firstconv.0.0`,
`layer2.0.conv1.0.0`, `branch1.1.0`, `lastconv.2`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.models.layers import (
    Conv2d, conv_bn, he_conv, resize_bilinear,
)
from estdepth_tpu_torch.ops import shard_context


class PSMBasicBlock(nn.Module):
    """Residual block without post-add activation (psm_submodule.py:14-37)."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 dilation: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Sequential(
            conv_bn(inplanes, planes, 3, stride, dilation=dilation),
            nn.ReLU(inplace=True),
        )
        self.conv2 = conv_bn(planes, planes, 3, 1, dilation=dilation,
                             zero_bn_scale=True)
        self.downsample = (conv_bn(inplanes, planes, 1, stride, pad=0)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def _layer(inplanes: int, planes: int, blocks: int, stride: int,
           dilation: int) -> nn.Sequential:
    # the first block carries the stride / projection shortcut
    # (psm_submodule.py:77-91)
    downsample = stride != 1 or inplanes != planes
    layers = [PSMBasicBlock(inplanes, planes, stride, dilation, downsample)]
    layers += [PSMBasicBlock(planes, planes, 1, dilation, False)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class PSMFeatureNet(nn.Module):
    """32-channel stride-4 matching features (psm_submodule.py:40-116)."""

    POOLS = (32, 16, 8, 4)

    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(
            conv_bn(3, 32, 3, 2), nn.ReLU(inplace=True),
            conv_bn(32, 32, 3, 1), nn.ReLU(inplace=True),
            conv_bn(32, 32, 3, 1), nn.ReLU(inplace=True),
        )
        self.layer1 = _layer(32, 32, 3, 1, 1)
        self.layer2 = _layer(32, 64, 16, 2, 1)  # stride 4 from here
        self.layer3 = _layer(64, 128, 3, 1, 1)
        self.layer4 = _layer(128, 128, 3, 1, 2)
        # index 0 is the reference's AvgPool2d; the window depends on the
        # input size (below), so the pooling runs in forward()
        for i in range(1, 5):
            setattr(self, f"branch{i}", nn.Sequential(
                nn.Identity(), conv_bn(128, 32, 1, 1, pad=0),
                nn.ReLU(inplace=True),
            ))
        self.lastconv = nn.Sequential(
            conv_bn(320, 128, 3, 1), nn.ReLU(inplace=True),
            he_conv(Conv2d(128, 32, 1, bias=False)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.firstconv(x)
        x = self.layer1(x)
        raw = self.layer2(x)
        skip = self.layer4(self.layer3(raw))
        return self.lastconv(pyramid(self, raw, skip))  # from 320 channels


def pyramid(net: nn.Module, raw: torch.Tensor,
            skip: torch.Tensor) -> torch.Tensor:
    """The spatial-pyramid head's input: `skip` average-pooled at the four
    windows of `net.POOLS`, each through `net.branch1..4` and resized back,
    concatenated in the reference's order raw, skip, branch4, branch3,
    branch2, branch1 (psm.py:97). On a width shard (parallel/spatial.py)
    the pooled maps are whole on every rank (`_sharded_pools`) and each
    branch is resized to the whole width and cut to this rank's columns."""
    h, w = skip.shape[2:]
    shards = shard_context.current()
    full_w = w if shards is None else shards.full_width(w)
    # clamp the window so inputs below the reference resolution still
    # pool to >= 1x1 (psm.py:89; identical at 64x80 and up)
    wins = [(min(pool, h), min(pool, full_w)) for pool in net.POOLS]
    if shards is None:
        pooled = [F.avg_pool2d(skip, win, win) for win in wins]
    else:
        pooled = _sharded_pools(skip, wins, shards)
    start = 0 if shards is None else shards.columns(w)[0]
    branches = []
    for i, b in enumerate(pooled):
        b = getattr(net, f"branch{i + 1}")(b)
        branches.append(resize_bilinear(b, h, full_w).narrow(-1, start, w))
    return torch.cat([raw, skip] + branches[::-1], 1)


def _sharded_pools(skip: torch.Tensor, wins: list,
                   shards) -> list[torch.Tensor]:
    """F.avg_pool2d(whole skip, win, win) for each window of `wins`, whole
    on every rank, from this rank's columns of `skip` [N, C, h, w_r]: the
    float32 sums of each window's rows and of this rank's columns of it,
    all-reduced over the ranks (one all_reduce for all four), divided
    by the window's size. Rows and columns past the last whole window are
    dropped, as avg_pool2d drops them."""
    n, c, h, w = skip.shape
    start, _ = shards.columns(w)
    full_w = shards.full_width(w)
    sums = []
    for wh, ww in wins:
        ph, pw = h // wh, full_w // ww
        x = skip[:, :, :ph * wh].float().reshape(n, c, ph, wh, w).sum(3)
        # this rank's columns placed in the windows they fall in: zeros
        # before `start` and after the shard complete its first and last
        # window, and windows past the pw whole ones are cut
        k0, lead = divmod(start, ww)
        tail = -(lead + w) % ww
        x = F.pad(x, (lead, tail)).reshape(n, c, ph, -1, ww).sum(-1)
        part = x.new_zeros(n, c, ph, pw)
        k1 = min(pw, k0 + x.shape[-1])
        if k1 > k0:
            part[..., k0:k1] = x[..., :k1 - k0]
        sums.append(part)
    total = shards.all_reduce(torch.cat([t.flatten() for t in sums]))
    out, i = [], 0
    for (wh, ww), part in zip(wins, sums):
        out.append((total[i:i + part.numel()].view(part.shape)
                    / (wh * ww)).to(skip.dtype))
        i += part.numel()
    return out
