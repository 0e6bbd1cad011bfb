"""Plain PyTorch reference of the hybrid depth network, float32 only.

A frozen copy of the forward of `estdepth_tpu_torch/models/` (estdepth.py,
decoder.py, est_transformer.py, memory.py, psm.py, senet.py's
SEFeatureNet, resnet.py, layers.py) and of `ops/geometry.py`,
`ops/warp.py` and `ops/warp_exact_z.py`, copied from commit dd5b5eb and cut
to the one configuration the benchmark runs: float32, the exact plane
sweep, the "plane_mix_exact_z" frustum warp, sequential EST fusion, one
device. No kernel of the port is used: both warps sample with
`F.grid_sample` (border padding, align_corners=True) times the hard
in-range mask, which is the port's corner rule in exact arithmetic, and
the EST attention is the plain softmax over neighbours. Nothing of the
port is imported. Module and parameter names are the port's, so one
state_dict loads strictly into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9
EXACT_Z_EPS = 1e-3


# ---------------------------------------------------------------- layers

def conv_bn(cin, cout, kernel, stride=1, pad=None, dilation=1, dims=2,
            zero_bn_scale=False, act=None):
    pad = kernel // 2 if pad is None else pad
    if dilation > 1:
        pad = dilation
    conv_cls, bn_cls = ((nn.Conv2d, nn.BatchNorm2d) if dims == 2
                        else (nn.Conv3d, nn.BatchNorm3d))
    conv = conv_cls(cin, cout, kernel, stride, pad, dilation, bias=False)
    conv.he_init = True
    bn = bn_cls(cout, eps=1e-5)
    bn.zero_init = zero_bn_scale
    layers = [conv, bn]
    if act == "relu":
        layers.append(nn.ReLU(inplace=True))
    elif act == "tanh":
        layers.append(nn.Tanh())
    return nn.Sequential(*layers)


def he_conv(conv):
    conv.he_init = True
    return conv


def upsample_nearest(x, factor=2):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def resize_bilinear(x, height, width):
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------- PSM encoder

class PSMBasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride, dilation, downsample):
        super().__init__()
        self.conv1 = nn.Sequential(
            conv_bn(inplanes, planes, 3, stride, dilation=dilation),
            nn.ReLU(inplace=True))
        self.conv2 = conv_bn(planes, planes, 3, 1, dilation=dilation,
                             zero_bn_scale=True)
        self.downsample = (conv_bn(inplanes, planes, 1, stride, pad=0)
                           if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def _psm_layer(inplanes, planes, blocks, stride, dilation):
    downsample = stride != 1 or inplanes != planes
    layers = [PSMBasicBlock(inplanes, planes, stride, dilation, downsample)]
    layers += [PSMBasicBlock(planes, planes, 1, dilation, False)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


def _branches():
    return [nn.Sequential(nn.Identity(), conv_bn(128, 32, 1, 1, pad=0),
                          nn.ReLU(inplace=True)) for _ in range(4)]


def pyramid(net, raw, skip):
    """skip pooled at 32, 16, 8 and 4 (clamped to the map), each through
    its branch and resized back; concatenated raw, skip, branch4 ... 1."""
    h, w = skip.shape[2:]
    branches = []
    for i, pool in enumerate((32, 16, 8, 4)):
        win = (min(pool, h), min(pool, w))
        b = getattr(net, f"branch{i + 1}")(F.avg_pool2d(skip, win, win))
        branches.append(resize_bilinear(b, h, w))
    return torch.cat([raw, skip] + branches[::-1], 1)


def _first_conv():
    return nn.Sequential(
        conv_bn(3, 32, 3, 2), nn.ReLU(inplace=True),
        conv_bn(32, 32, 3, 1), nn.ReLU(inplace=True),
        conv_bn(32, 32, 3, 1), nn.ReLU(inplace=True))


def _last_conv(cin):
    return nn.Sequential(conv_bn(cin, 128, 3, 1), nn.ReLU(inplace=True),
                         he_conv(nn.Conv2d(128, 32, 1, bias=False)))


class PSMFeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.firstconv = _first_conv()
        self.layer1 = _psm_layer(32, 32, 3, 1, 1)
        self.layer2 = _psm_layer(32, 64, 16, 2, 1)
        self.layer3 = _psm_layer(64, 128, 3, 1, 1)
        self.layer4 = _psm_layer(128, 128, 3, 1, 2)
        for i, b in enumerate(_branches()):
            setattr(self, f"branch{i + 1}", b)
        self.lastconv = _last_conv(320)

    def forward(self, x):
        raw = self.layer2(self.layer1(self.firstconv(x)))
        skip = self.layer4(self.layer3(raw))
        return self.lastconv(pyramid(self, raw, skip))


# -------------------------------------------------------- SENet encoder

class SEModule(nn.Module):
    def __init__(self, channels, reduction=16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x):
        g = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(g))))


def _se_conv(cin, cout, kernel, stride=1, pad=0, groups=1):
    return he_conv(nn.Conv2d(cin, cout, kernel, stride, pad, groups=groups,
                             bias=False))


def _se_bn(channels, zero_init=False):
    bn = nn.BatchNorm2d(channels, eps=1e-5)
    bn.zero_init = zero_init
    return bn


class SEBottleneck(nn.Module):
    """SEFeatureNet's block: 1x1 to 64, grouped 3x3 (32 groups, the
    stride), 1x1 to 128, the SE gate, an optional projection shortcut."""

    def __init__(self, inplanes, stride=1, downsample=False,
                 downsample_kernel=1):
        super().__init__()
        self.conv1 = _se_conv(inplanes, 64, 1)
        self.bn1 = _se_bn(64)
        self.conv2 = _se_conv(64, 64, 3, stride, 1, 32)
        self.bn2 = _se_bn(64)
        self.conv3 = _se_conv(64, 128, 1)
        self.bn3 = _se_bn(128, zero_init=True)
        self.relu = nn.ReLU(inplace=True)
        self.se_module = SEModule(128, 16)
        k = downsample_kernel
        self.downsample = (nn.Sequential(
            _se_conv(inplanes, 128, k, stride, k // 2), _se_bn(128))
            if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.se_module(self.bn3(self.conv3(out)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(out + x)


def _se_layer(inplanes, blocks, stride, downsample_kernel):
    downsample = stride != 1 or inplanes != 128
    layers = [SEBottleneck(inplanes, stride, downsample, downsample_kernel)]
    layers += [SEBottleneck(128) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class SEFeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.firstconv = _first_conv()
        self.layer1 = _se_layer(32, 3, 1, 1)
        self.layer2 = _se_layer(128, 3, 2, 3)
        self.layer3 = _se_layer(128, 3, 1, 1)
        self.layer4 = _se_layer(128, 3, 1, 1)
        for i, b in enumerate(_branches()):
            setattr(self, f"branch{i + 1}", b)
        self.lastconv = _last_conv(384)

    def forward(self, x):
        raw = self.layer2(self.layer1(self.firstconv(x)))
        skip = self.layer4(self.layer3(raw))
        return self.lastconv(pyramid(self, raw, skip))


# ------------------------------------------------------ ResNet encoder

_STAGES = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
           50: ("bottleneck", (3, 4, 6, 3)),
           101: ("bottleneck", (3, 4, 23, 3)),
           152: ("bottleneck", (3, 8, 36, 3))}


def _rconv(cin, cout, kernel, stride=1):
    return he_conv(nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                             bias=False))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, downsample):
        super().__init__()
        self.conv1 = _rconv(inplanes, planes, 3, stride)
        self.bn1 = _se_bn(planes)
        self.conv2 = _rconv(planes, planes, 3)
        self.bn2 = _se_bn(planes, True)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (conv_bn(inplanes, planes, 1, stride, pad=0)
                           if downsample else None)

    def forward(self, x):
        out = self.bn2(self.conv2(self.relu(self.bn1(self.conv1(x)))))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride, downsample):
        super().__init__()
        self.conv1 = _rconv(inplanes, planes, 1)
        self.bn1 = _se_bn(planes)
        self.conv2 = _rconv(planes, planes, 3, stride)
        self.bn2 = _se_bn(planes)
        self.conv3 = _rconv(planes, planes * 4, 1)
        self.bn3 = _se_bn(planes * 4, True)
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
    def __init__(self, depth):
        super().__init__()
        kind, stages = _STAGES[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = _rconv(3, 64, 7, 2)
        self.bn1 = _se_bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
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
    def __init__(self, depth=50):
        super().__init__()
        mult = 4 if depth > 34 else 1
        self.num_ch_enc = (64, 64 * mult, 128 * mult, 256 * mult, 512 * mult)
        self.encoder = _ResNet(depth)

    def forward(self, x):
        e = self.encoder
        x = e.relu(e.bn1(e.conv1(x)))
        feats = [x]
        x = e.maxpool(x)
        for i in range(1, 5):
            x = getattr(e, f"layer{i}")(x)
            feats.append(x)
        return feats


# ------------------------------------------------------------- geometry

def pixel_grid(height, width, device):
    y = torch.arange(height, dtype=torch.float32, device=device)
    x = torch.arange(width, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1),
                        torch.ones_like(xx).reshape(-1)], 0)


def scale_intrinsics(k, scale):
    return k * torch.tensor([scale, scale, 1.0], dtype=k.dtype,
                            device=k.device)[:, None]


def camera_projection(k, pose):
    extr = torch.linalg.inv(pose)
    return torch.cat([torch.matmul(k, extr[:, :3, :4]), extr[:, 3:4, :4]], 1)


def sample_2d(src, x, y):
    """src [B, H, W, C] at pixel coordinates x, y [B, N] -> [B, N, C]:
    bilinear from in-bounds corners where x in [0, W-1] and y in [0, H-1],
    exactly zero elsewhere."""
    b, h, w, c = src.shape
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], -1)
    out = F.grid_sample(src.permute(0, 3, 1, 2), grid[:, None],
                        mode="bilinear", padding_mode="border",
                        align_corners=True)  # [B, C, 1, N]
    return out[:, :, 0].transpose(1, 2) * valid[..., None].to(src.dtype)


def plane_sweep_warp(src_feat, src_proj, ref_proj, depth_values):
    """src [B, H, W, C] swept over the ref camera's planes [B, D]
    -> [B, D, H, W, C] (homo_utils.py:458-504)."""
    b, h, w, c = src_feat.shape
    d = depth_values.shape[1]
    proj = torch.matmul(src_proj, torch.linalg.inv(ref_proj))
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    rot_xyz = torch.matmul(rot, pixel_grid(h, w, src_feat.device))
    pts = rot_xyz[:, :, None, :] * depth_values[:, None, :, None]
    pts = pts + trans[:, :, None, None]
    zb = pts[:, 2] + 1e-8
    x = (pts[:, 0] / zb).reshape(b, -1)
    y = (pts[:, 1] / zb).reshape(b, -1)
    return sample_2d(src_feat, x, y).reshape(b, d, h, w, c)


def zi_field(t, k, depth_values, depth_min, depth_interval, grid):
    b, d = depth_values.shape
    k_inv = torch.linalg.inv(k)
    m0 = torch.matmul(t[:, :3, :3], k_inv)
    a = depth_values[:, :, None, None] * m0[:, None]
    a = torch.cat([a[..., :2], a[..., 2:] + t[:, :3, 3][:, None, :, None]],
                  -1)
    e3 = torch.zeros(b, d, 3, 1, dtype=a.dtype, device=a.device)
    e3[:, :, 2] = 1.0
    n = torch.linalg.solve(a.transpose(-1, -2), e3)[..., 0]
    denom = torch.matmul(n, torch.matmul(k_inv, grid))
    zi = (1.0 / denom - depth_min) / depth_interval
    in_front = (denom > 1e-8) & torch.isfinite(zi)
    return torch.where(in_front, zi, torch.full_like(zi, -2.0))


def frustum_warp_exact_z(volume, rel_pose, k, depth_values, depth_min,
                         depth_interval):
    """Source frustum volume [B, D, H, W, C] resampled into the target
    frustum by the exact-z plane-mix rule (ops/warp_exact_z.py)."""
    b, d, h, w, c = volume.shape
    grid = pixel_grid(h, w, volume.device)
    rays = torch.matmul(torch.linalg.inv(k), grid)
    pts = rays[:, :, None, :] * depth_values[:, None, :, None]
    t = torch.linalg.inv(rel_pose)
    flat = pts.reshape(b, 3, -1)
    pts = torch.matmul(t[:, :3, :3], flat) + t[:, :3, 3:4]
    uvw = torch.matmul(k, pts)
    z = uvw[:, 2]
    x, y = uvw[:, 0] / (z + 1e-10), uvw[:, 1] / (z + 1e-10)
    zi = zi_field(t, k, depth_values, depth_min, depth_interval, grid)
    # per source pixel and target plane: A = v0 - z0 s, s = v1 - v0
    z0 = torch.floor(zi.clamp(0.0, d - 1.0)).clamp(0.0, max(d - 2.0, 0.0))
    z0i = z0.long()
    src = volume.reshape(b, d, h * w, c)
    hw = torch.arange(h * w, device=volume.device)
    bi = torch.arange(b, device=volume.device)[:, None, None]
    v0, v1 = src[bi, z0i, hw], src[bi, z0i + 1, hw]
    s = v1 - v0
    a_s = torch.cat([v0 - z0[..., None] * s, s], -1)
    a_s = sample_2d(a_s.reshape(b * d, h, w, 2 * c), x.reshape(b * d, -1),
                    y.reshape(b * d, -1))
    zi_star = ((z - depth_min) / depth_interval).reshape(b * d, -1)
    out = a_s[..., :c] + zi_star.clamp(0.0, d - 1.0)[..., None] * a_s[..., c:]
    valid = (zi_star >= -EXACT_Z_EPS) & (zi_star <= d - 1.0 + EXACT_Z_EPS)
    return (out * valid[..., None].float()).reshape(b, d, h, w, c)


# --------------------------------------------------------------- memory

class Memory:
    """FIFO of M key/value volumes, newest last; unfilled slots are zeros
    with the identity pose and invalid."""

    def __init__(self, keys, values, poses, valid):
        self.keys, self.values, self.poses, self.valid = (keys, values,
                                                          poses, valid)

    @classmethod
    def create(cls, batch, size, d, h, w, c, device):
        shape = (batch, size, d, h, w, c)
        return cls(torch.zeros(shape, device=device),
                   torch.zeros(shape, device=device),
                   torch.eye(4, device=device).expand(batch, size, 4,
                                                      4).clone(),
                   torch.zeros(batch, size, dtype=torch.bool, device=device))

    @classmethod
    def single(cls, key, value, pose):
        return cls(key[:, None], value[:, None], pose[:, None],
                   torch.ones(key.shape[0], 1, dtype=torch.bool,
                              device=key.device))

    @property
    def size(self):
        return self.keys.shape[1]

    def push(self, key, value, pose):
        return Memory(
            torch.cat([self.keys[:, 1:], key[:, None]], 1),
            torch.cat([self.values[:, 1:], value[:, None]], 1),
            torch.cat([self.poses[:, 1:], pose[:, None]], 1),
            torch.cat([self.valid[:, 1:], torch.ones_like(self.valid[:, :1])],
                      1))


# ------------------------------------------------------ EST transformer

class EpipolarTransformer(nn.Module):
    def __init__(self, c=16):
        super().__init__()
        self.channels = c
        self.gate_conv = nn.Conv3d(2 * c, 2 * c, 3, padding=1)
        self.output_conv = nn.Conv3d(2 * c, c, 3, padding=1)
        self.reset_gate_norm = nn.GroupNorm(1, c, eps=1e-5)
        self.update_gate_norm = nn.GroupNorm(1, c, eps=1e-5)
        self.output_norm = nn.GroupNorm(1, c, eps=1e-5)

    def forward(self, key, value, warped_keys=None, warped_values=None,
                valid=None):
        """key, value [B, D, H, W, C]; warped [N, B, D, H, W, C]; valid
        [N, B] -> fused value [B, D, H, W, C]."""
        c = self.channels
        if warped_keys is None:
            h = torch.zeros_like(value)
        else:
            corr = (key[None] * warped_keys).sum(-1)
            vmask = valid.reshape(valid.shape + (1,) * (corr.dim() - 2))
            logits = torch.where(vmask, corr, torch.full_like(corr, NEG_INF))
            attn = torch.where(vmask, torch.softmax(logits, 0),
                               torch.zeros_like(corr))
            n_valid = valid.float().sum(0).clamp(min=1.0)
            h = (warped_values * attn[..., None]).sum(0)
            h = h / n_valid.reshape((-1,) + (1,) * (h.dim() - 1))
        x = value.permute(0, 4, 1, 2, 3)
        h = h.permute(0, 4, 1, 2, 3)
        gates = self.gate_conv(torch.cat([x, h], 1))
        r = torch.sigmoid(self.reset_gate_norm(gates[:, :c]))
        u = torch.sigmoid(self.update_gate_norm(gates[:, c:]))
        y = torch.tanh(self.output_norm(self.output_conv(
            torch.cat([x, r * h], 1))))
        return (u * h + (1.0 - u) * y).permute(0, 2, 3, 4, 1)


# -------------------------------------------------------------- decoder

class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = conv_bn(cin, cout, 3, 1, act="relu")

    def forward(self, x):
        return self.conv(x)


def _bn_relu_3d(cin, cout, act="relu"):
    return nn.Sequential(conv_bn(cin, cout, 3, 1, dims=3, act=act))


def _stereo_head(c):
    return nn.Sequential(conv_bn(c, c, 3, 1, dims=3, act="relu"),
                         nn.Conv3d(c, 1, 1))


def softargmin_depth(logits, depth_values):
    probs = torch.softmax(logits, 1)
    return torch.einsum("ndhw,nd->nhw", probs, depth_values), probs.amax(1)


class DepthHybridDecoder(nn.Module):
    def __init__(self, enc, ndepths=64, depth_max=10.0):
        super().__init__()
        nd = ndepths
        self.depth_max = depth_max
        self.upconv_4_0 = ConvBlock(enc[4], 256)
        self.upconv_4_1 = ConvBlock(256 + enc[3], 256)
        self.upconv_3_0 = ConvBlock(256, 128)
        self.upconv_3_1 = ConvBlock(128 + enc[2], 128)
        self.upconv_2_0 = ConvBlock(128, nd)
        self.upconv_2_1 = ConvBlock(nd + enc[1], nd)
        self.upconv_1_0 = ConvBlock(2 * nd, 32)
        self.upconv_1_1 = ConvBlock(32 + enc[0], 32)
        self.upconv_0_0 = ConvBlock(32, 16)
        self.upconv_0_1 = ConvBlock(16, 16)
        self.dispconv_1 = nn.Conv2d(32, 1, 3, padding=1)
        self.dispconv_0 = nn.Conv2d(16, 1, 3, padding=1)
        self.dres0 = nn.Sequential(*_bn_relu_3d(32, 32), *_bn_relu_3d(32, 32))
        self.dres1 = nn.Sequential(*_bn_relu_3d(32, 32), *_bn_relu_3d(32, 32))
        self.dres2 = _bn_relu_3d(33, 33)
        self.key_layer = _bn_relu_3d(33, 16)
        self.value_layer = _bn_relu_3d(33, 16, act="tanh")
        self.stereo_head0 = _stereo_head(16)
        self.stereo_head1 = _stereo_head(16)
        self.epipolar_transformer = EpipolarTransformer(16)

    def _fusion(self, key, value, target_poses, k, depth_values, depth_min,
                depth_interval, memory):
        """Targets in order; in-window neighbours j < i already fused
        (hybrid_depth_decoder.py:229-254)."""
        b, num, d, h, w, c = key.shape
        est = self.epipolar_transformer
        window_valid = torch.ones(b, num, dtype=torch.bool, device=key.device)
        if memory is not None:
            all_poses = torch.cat([target_poses, memory.poses], 1)
            all_valid = torch.cat([window_valid, memory.valid], 1)
        else:
            all_poses, all_valid = target_poses, window_valid
        s = all_poses.shape[1]
        if s == 1:
            return est(key[:, 0], value[:, 0])[:, None]
        values = [value[:, i] for i in range(num)]
        keys = [key[:, i] for i in range(num)]
        if memory is not None:
            keys += [memory.keys[:, m] for m in range(memory.size)]
        for i in range(num):
            nb = [j for j in range(s) if j != i]
            rel = torch.matmul(torch.stack([all_poses[:, j] for j in nb], 1),
                               torch.linalg.inv(target_poses[:, i])[:, None])
            nb_v = torch.stack([values[j] if j < num
                                else memory.values[:, j - num] for j in nb],
                               1)
            kv = torch.cat([torch.stack([keys[j] for j in nb], 1), nb_v], -1)
            n = len(nb)
            warped = frustum_warp_exact_z(
                kv.reshape(b * n, d, h, w, 2 * c), rel.reshape(b * n, 4, 4),
                k[:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3),
                depth_values[:, None].expand(b, n, d).reshape(b * n, d),
                depth_min, depth_interval,
            ).reshape(b, n, d, h, w, 2 * c).transpose(0, 1)
            valid_i = torch.stack([all_valid[:, j] for j in nb], 0)
            values[i] = est(key[:, i], values[i], warped[..., :c],
                            warped[..., c:], valid_i)
        return torch.stack(values, 1)

    def forward(self, cost_volumes, feats, target_poses, k, depth_values,
                depth_min, depth_interval, memory, use_est):
        b, num, _, d, h, w = cost_volumes.shape
        bn = b * num
        x = self.upconv_4_0(feats[4])
        x = self.upconv_4_1(torch.cat([upsample_nearest(x), feats[3]], 1))
        x = self.upconv_3_0(x)
        x = self.upconv_3_1(torch.cat([upsample_nearest(x), feats[2]], 1))
        x = self.upconv_2_0(x)
        semantic_vs = self.upconv_2_1(torch.cat([upsample_nearest(x),
                                                 feats[1]], 1))
        mx = self.dres1(self.dres0(cost_volumes.reshape(bn, -1, d, h, w)))
        x3 = self.dres2(torch.cat([semantic_vs[:, None], mx], 1))
        value = self.value_layer(x3)
        key = self.key_layer(x3)
        dv_bn = depth_values.repeat_interleave(num, 0)
        depth3, prob3 = softargmin_depth(self.stereo_head0(value)[:, 0],
                                         dv_bn)
        key_w = key.permute(0, 2, 3, 4, 1).reshape(b, num, d, h, w, -1)
        value_w = value.permute(0, 2, 3, 4, 1).reshape(b, num, d, h, w, -1)
        if use_est:
            fused = self._fusion(key_w, value_w, target_poses, k,
                                 depth_values, depth_min, depth_interval,
                                 memory)
            fused_logits = self.stereo_head1(
                fused.reshape(bn, d, h, w, -1).permute(0, 4, 1, 2, 3))[:, 0]
            state_value = fused[:, -1]
        else:
            fused_logits = self.stereo_head1(value)[:, 0]
            state_value = value_w[:, -1]
        depth2, prob2 = softargmin_depth(fused_logits, dv_bn)
        x = self.upconv_1_0(torch.cat([semantic_vs, F.relu(fused_logits)], 1))
        x = self.upconv_1_1(torch.cat([upsample_nearest(x), feats[0]], 1))
        depth1 = self.depth_max * torch.sigmoid(self.dispconv_1(x))
        x = self.upconv_0_1(upsample_nearest(self.upconv_0_0(x)))
        depth0 = self.depth_max * torch.sigmoid(self.dispconv_0(x))

        def full(m, factor):
            if m.dim() == 3:
                m = m[:, None]
            if factor > 1:
                m = upsample_nearest(m, factor)
            return m.reshape(b, num, 4 * h, 4 * w)

        outputs = {
            "depth": torch.stack([full(depth0, 1), full(depth1, 2),
                                  full(depth2, 4), full(depth3, 4)], 2),
            "init_prob": full(prob3, 4), "fused_prob": full(prob2, 4)}
        return (outputs, key_w[:, -1].detach(), state_value.detach(),
                target_poses[:, -1])


# ---------------------------------------------------------------- model

class DepthNetHybrid(nn.Module):
    """The network of `feature_net` ("psm" or "senet"), ndepths planes in
    [depth_min, depth_max], a ResNet-`resnet` context encoder."""

    def __init__(self, feature_net="psm", ndepths=64, depth_min=0.01,
                 depth_max=10.0, resnet=50):
        super().__init__()
        self.ndepths, self.depth_min = ndepths, depth_min
        self.depth_interval = (depth_max - depth_min) / (ndepths - 1)
        self.matchingFeature = (PSMFeatureNet() if feature_net == "psm"
                                else SEFeatureNet())
        self.semanticFeature = ResNetEncoder(resnet)
        self.CostRegNet = DepthHybridDecoder(self.semanticFeature.num_ch_enc,
                                             ndepths, depth_max)
        self.pre0 = conv_bn(64, 32, 1, 1, pad=0, dims=3)
        self.pre1 = conv_bn(32, 32, 3, 1, dims=3, act="relu")
        self.pre2 = conv_bn(32, 32, 3, 1, dims=3, zero_bn_scale=True)

    def matching(self, imgs):
        """[N, H, W, 3] in 0..255 -> [N, H/4, W/4, 32]."""
        x = (2.0 * (imgs.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
        return self.matchingFeature(x).permute(0, 2, 3, 1)

    def forward(self, imgs, poses, intr, memory=None, use_est=False,
                feats=None):
        """imgs [B, V, H, W, 3] in 0..255, poses [B, V, 4, 4] cam-to-world,
        intr [B, 3, 3]; feats [B, V, H/4, W/4, 32] or None. Returns
        (outputs, (key, value, pose)) as the port's model."""
        b, v, hi, wi, _ = imgs.shape
        t = v - 2
        x = 2.0 * (imgs.float() / 255.0) - 1.0
        if feats is None:
            feats = self.matching(imgs.reshape(b * v, hi, wi, 3)).reshape(
                b, v, hi // 4, wi // 4, -1)
        semantic = self.semanticFeature(
            x[:, 1:1 + t].reshape(b * t, hi, wi, 3).permute(0, 3, 1, 2))
        k1 = scale_intrinsics(intr, 0.25)
        dv = (torch.arange(self.ndepths, dtype=torch.float32,
                           device=imgs.device) * self.depth_interval
              + self.depth_min)[None].expand(b, -1)
        cost = self._cost_volumes(feats, poses, k1, dv)
        outputs, key, value, pose = self.CostRegNet(
            cost, semantic, poses[:, 1:1 + t], k1, dv, self.depth_min,
            self.depth_interval, memory, use_est)
        return outputs, (key, value, pose)

    def _cost_volumes(self, feats, poses, k1, dv):
        b, v, h, w, c = feats.shape
        t = v - 2
        d = dv.shape[1]
        proj = camera_projection(
            k1[:, None].expand(b, v, 3, 3).reshape(b * v, 3, 3),
            poses.reshape(b * v, 4, 4)).reshape(b, v, 4, 4)
        bp = 2 * b * t
        src = torch.stack([feats[:, 0:t], feats[:, 2:2 + t]], 0)
        src_proj = torch.stack([proj[:, 0:t], proj[:, 2:2 + t]], 0)
        ref_proj = proj[:, 1:1 + t][None].expand(2, b, t, 4, 4)
        warped = plane_sweep_warp(
            src.reshape(bp, h, w, c), src_proj.reshape(bp, 4, 4),
            ref_proj.reshape(bp, 4, 4),
            dv[None, :, None].expand(2, b, t, d).reshape(bp, d))
        ref = feats[:, 1:1 + t].permute(0, 1, 4, 2, 3)
        ref = ref[None, :, :, :, None].expand(2, b, t, c, d, h, w)
        x = torch.cat([ref.reshape(bp, c, d, h, w),
                       warped.permute(0, 4, 1, 2, 3)], 1)
        x = self.pre0(x)
        x = x + self.pre2(self.pre1(x))
        return x.reshape(2, b, t, -1, d, h, w).mean(0)


# ------------------------------------------------------------- training

def multi_scale_loss(pred_depths, gt, mask, weight=0.8):
    """Sum over the 4 scales of weight**s times the mean over targets of
    the masked mean |pred - gt| pooled over (B, H, W)."""
    m = mask.float()
    den = m.sum((0, 2, 3)).clamp(min=1.0)
    total = pred_depths.new_zeros(())
    for s in range(4):
        per_t = ((pred_depths[:, :, s] - gt).abs() * m).sum((0, 2, 3)) / den
        total = total + weight ** s * per_t.mean()
    return total


def clip_grad_norm(params, max_norm):
    """Scale every gradient by min(1, max_norm / global norm)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(max_norm / norm.clamp(min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm
