"""VGGT: Visual Geometry Grounded Transformer (Wang, Chen, Karaev, Vedaldi,
Rupprecht, Novotny, CVPR 2025, arXiv:2503.11347; facebookresearch/vggt),
its depth and camera branches at the published widths and depth of
`config.VGGTConfig`.

Given the S frames of one scene (imgs [B, S, H, W, 3] in 0..255), the
network predicts, in one forward pass, each frame's depth map with a
confidence and each frame's camera:

- the frames are resized on the device to `img_height` x `img_width`
  (bicubic with antialias, clamped to 0..255, then over 255), and
  normalised by ImageNet's mean and std;
- patch tokens (`vggt_patch_embed`): a DINOv2 ViT-L/14 with 4 registers
  on each frame (a 14x14 patch convolution, a class token, the learned
  37x37 position embedding interpolated bicubically with antialias to
  the patch grid, 4 register tokens, 24 pre-LayerNorm blocks with
  LayerScale, eps 1e-6), its final-LayerNorm patch tokens;
- the aggregator: each frame's tokens are a camera token, 4 register
  tokens (one learned set for the first frame, one shared by the others)
  and its patch tokens, P = 5 + h w a frame; 24 iterations of a frame
  block (`vggt_frame`: attention within each frame, tokens [B S, P, C])
  and a global block (`vggt_global`: attention over every frame's tokens
  at once, [B, S P, C]). Each block is pre-LayerNorm (eps 1e-5), its
  attention with a qkv bias, LayerNorm of q and k per head (QK-norm) and
  2D rotary embeddings of the patch's row and column (base 100, the
  special tokens at position 0, patches from 1), then an MLP of ratio 4
  with GELU; LayerScale on both branches. Iteration i outputs the frame
  block's and the global block's tokens side by side, width 2 C; only
  the outputs that the heads read are kept;
- the camera head (`vggt_camera`): the last output's camera tokens,
  LayerNorm, then 4 iterations of adaLN modulation from an embedding of
  the previous pose encoding (a learned empty one first), 4 trunk blocks
  at width 2 C attending across the frames, and an MLP to a 9-number
  update of the pose encoding (translation 3, quaternion 4, field of view
  2, the last through ReLU);
- the depth head (`vggt_depth_head`): DPT on outputs 4, 11, 17 and 23
  (LayerNorm, 1x1 projections to 256 / 512 / 1024 / 1024 channels with a
  sin-cos position embedding of the patch grid x 0.1, resampled by x4 and
  x2 transposed convolutions, identity and a stride-2 convolution, four
  fusion blocks of residual conv units at 256 channels, a 3x3
  convolution to 128, bilinear upsampling to the resized frame, the
  position embedding again, then 3x3 to 32, ReLU and 1x1 to 2 channels),
  8 frames at a time: depth = exp(x), confidence = 1 + exp(c).

Precision as the published inference: the aggregator runs inside an
autocast region of `compute_dtype` (bf16 GEMMs and attention, float32
weights, norms and residual stream); the heads run in float32 with
autocast off. Every softmax attention is one `estdepth::attention` op
(ops/attention.py, `F.scaled_dot_product_attention`), its q and k cast
to v's dtype as autocast casts them. The point head and the track head
are not built. Module and parameter names are the published ones, except
DINOv2's training-only `mask_token`, which is not built.

Returns {"depth", "confidence", "depth_logit", "confidence_logit"}
[B, S, h, w] at the resized size and "pose_enc" [B, S, 9]. The cameras of
`MVSRunner.run_view` are accepted and not read.

Spans (utils/trace.py): `vggt_patch_embed`, `vggt_frame` and
`vggt_global` (each block), `vggt_camera`, `vggt_depth_head`; no host
wait. Counters:
`vggt.frames` (depth maps a forward computes, B S), `vggt.scans` (the
scans it takes, B) and `vggt.global_tokens` (S P a scan: the tokens each
global block attends over, once for each scan).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.config import VGGTConfig, torch_dtype
from estdepth_tpu_torch.models.layers import init_weights
from estdepth_tpu_torch.ops.attention import attention
from estdepth_tpu_torch.utils import trace

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EPS_DINO = 1e-6  # DINOv2's LayerNorms
EPS = 1e-5  # nn.LayerNorm's default: the aggregator, QK-norm, the heads
EPS_ADALN = 1e-6
POSE_DIM = 9
SPECIAL = 1  # the camera token ahead of the registers
LAYER_SCALE_DINO = 1.0  # VGGT's init_values for DINOv2
LAYER_SCALE = 0.01  # the aggregator's and the camera trunk's
DPT_POS_RATIO = 0.1
DPT_OMEGA = 100.0
DPT_HEAD_FEATURES = 32
FRAMES_CHUNK = 8  # frames the depth head takes at a time, as published


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Rope2D:
    """2D rotary embedding of token positions [N, 2] (row, column, each
    below `top`) for heads of width `dim`: the first half of a head
    rotated by the row, the second by the column, each half's pairs
    (i, i + dim / 4) at frequencies base^(-4 i / dim), as the published
    RotaryPositionEmbedding2D. The cos / sin tables [N, dim] are made once
    a forward, on the positions' device."""

    def __init__(self, pos: torch.Tensor, top: int, dim: int, base: float):
        dev = pos.device
        half = dim // 2
        inv = 1.0 / (base ** (torch.arange(0, half, 2, device=dev).float()
                              / half))
        angles = torch.arange(top, device=dev, dtype=torch.float32)[
            :, None] * inv[None]
        angles = torch.cat((angles, angles), -1)
        cos, sin = angles.cos(), angles.sin()
        self.cos = torch.cat((cos[pos[:, 0]], cos[pos[:, 1]]), -1)
        self.sin = torch.cat((sin[pos[:, 0]], sin[pos[:, 1]]), -1)
        self.quarter = dim // 4

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., N, dim] -> x cos + rotate(x) sin, rotate taking each
        half (a, b) to (-b, a)."""
        parts = x.unflatten(-1, (2, 2, self.quarter))
        rotated = torch.stack((-parts[..., 1, :], parts[..., 0, :]),
                              -2).flatten(-3)
        return x * self.cos + rotated * self.sin


def positions(h: int, w: int, special: int, device) -> torch.Tensor:
    """[special + h w, 2] long: the special tokens at (0, 0), patch (y, x)
    at (y + 1, x + 1)."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    patch = torch.stack((yy.reshape(-1), xx.reshape(-1)), -1) + 1
    return torch.cat((torch.zeros(special, 2, dtype=torch.long,
                                  device=device), patch))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False,
                 eps: float = EPS):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = (nn.LayerNorm(self.head_dim, eps=eps) if qk_norm
                       else nn.Identity())
        self.k_norm = (nn.LayerNorm(self.head_dim, eps=eps) if qk_norm
                       else nn.Identity())
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, rope: Rope2D | None = None):
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = rope(q), rope(k)
        x = attention(q.to(v.dtype), k.to(v.dtype), v)
        return self.proj(x.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 init_values: float, qk_norm: bool = False,
                 eps: float = EPS):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qk_norm, eps)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: torch.Tensor, rope: Rope2D | None = None):
        x = x + self.ls1(self.attn(self.norm1(x), rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoVisionTransformer(nn.Module):
    """DINOv2 ViT with registers; forward gives the final-LayerNorm patch
    tokens [N, h w, C] of normalised frames [N, 3, H, W]."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        d, r = cfg.embed_dim, cfg.num_register_tokens
        self.patch_size = cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.register_tokens = nn.Parameter(torch.zeros(1, r, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + cfg.pos_embed_grid ** 2, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, LAYER_SCALE_DINO,
                  eps=EPS_DINO) for _ in range(cfg.dino_depth))
        self.norm = nn.LayerNorm(d, eps=EPS_DINO)

    def interpolate_pos_encoding(self, h: int, w: int) -> torch.Tensor:
        """The position embedding [1, 1 + h w, C] of an h x w patch grid:
        the learned grid bicubically resized with antialias (DINOv2's
        interpolate_offset 0), the class token's kept."""
        pos = self.pos_embed.float()
        m = int(round((pos.shape[1] - 1) ** 0.5))
        grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(h, w), mode="bicubic",
                             antialias=True)
        grid = grid.permute(0, 2, 3, 1).reshape(1, h * w, -1)
        return torch.cat((pos[:, :1], grid), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, height, width = x.shape
        h, w = height // self.patch_size, width // self.patch_size
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat((self.cls_token.expand(n, -1, -1), x), 1)
        x = x + self.interpolate_pos_encoding(h, w).to(x.dtype)
        x = torch.cat((x[:, :1], self.register_tokens.expand(n, -1, -1),
                       x[:, 1:]), 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.register_tokens.shape[1]:]


@functools.lru_cache(maxsize=4)
def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std [1, 1, 3, 1, 1] on `device`, made once."""
    return (torch.tensor(IMAGENET_MEAN, device=device).view(1, 1, 3, 1, 1),
            torch.tensor(IMAGENET_STD, device=device).view(1, 1, 3, 1, 1))


def _first_and_rest(tokens: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """tokens [1, 2, X, C] -> [B S, X, C]: set 0 for each scan's first
    frame, set 1 for the others."""
    first = tokens[:, :1].expand(b, 1, *tokens.shape[2:])
    rest = tokens[:, 1:].expand(b, s - 1, *tokens.shape[2:])
    return torch.cat((first, rest), 1).reshape(b * s, *tokens.shape[2:])


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        d, r = cfg.embed_dim, cfg.num_register_tokens
        self.cfg = cfg
        self.patch_embed = DinoVisionTransformer(cfg)
        self.frame_blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, LAYER_SCALE, qk_norm=True)
            for _ in range(cfg.aa_depth))
        self.global_blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, LAYER_SCALE, qk_norm=True)
            for _ in range(cfg.aa_depth))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, d))
        self.register_token = nn.Parameter(torch.zeros(1, 2, r, d))
        self.patch_start_idx = SPECIAL + r

    def forward(self, images: torch.Tensor, keep) -> dict:
        """images [B, S, 3, H, W] in [0, 1] -> {i: output i [B, S, P, 2 C]}
        for i in `keep`."""
        b, s, _, height, width = images.shape
        cfg = self.cfg
        h, w = height // cfg.patch_size, width // cfg.patch_size
        mean, std = _imagenet(images.device)
        images = (images - mean) / std
        with trace.span("vggt_patch_embed"):
            patches = self.patch_embed(images.view(b * s, 3, height, width))
        tokens = torch.cat((_first_and_rest(self.camera_token, b, s),
                            _first_and_rest(self.register_token, b, s),
                            patches), 1)
        p, c = tokens.shape[1:]
        trace.count("vggt.global_tokens", b * s * p)
        pos = positions(h, w, self.patch_start_idx, images.device)
        head, top = c // cfg.num_heads, max(h, w) + 1
        frame_rope = Rope2D(pos, top, head, cfg.rope_frequency)
        global_rope = Rope2D(pos.repeat(s, 1), top, head, cfg.rope_frequency)
        out = {}
        for i in range(cfg.aa_depth):
            with trace.span("vggt_frame"):
                tokens = self.frame_blocks[i](tokens.view(b * s, p, c),
                                              frame_rope)
            frame = tokens.view(b, s, p, c)
            with trace.span("vggt_global"):
                tokens = self.global_blocks[i](tokens.view(b, s * p, c),
                                               global_rope)
            if i in keep:
                out[i] = torch.cat((frame, tokens.view(b, s, p, c)), -1)
        return out


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        dim = 2 * cfg.embed_dim
        self.iterations = cfg.camera_iterations
        self.trunk = nn.Sequential(*(
            Block(dim, cfg.num_heads, cfg.mlp_ratio, LAYER_SCALE)
            for _ in range(cfg.camera_trunk_depth)))
        self.token_norm = nn.LayerNorm(dim)
        self.trunk_norm = nn.LayerNorm(dim)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, POSE_DIM))
        self.embed_pose = nn.Linear(POSE_DIM, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(),
                                               nn.Linear(dim, 3 * dim))
        self.adaln_norm = nn.LayerNorm(dim, elementwise_affine=False,
                                       eps=EPS_ADALN)
        self.pose_branch = Mlp(dim, dim // 2, POSE_DIM)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S, P, 2 C], the last output -> the pose encoding
        [B, S, 9] of the last iteration."""
        pose_tokens = self.token_norm(tokens[:, :, 0])
        b, s, _ = pose_tokens.shape
        normed = self.adaln_norm(pose_tokens)
        pred = None
        for _ in range(self.iterations):
            inp = self.embed_pose(self.empty_pose_tokens.expand(b, s, -1)
                                  if pred is None else pred)
            shift, scale, gate = self.poseLN_modulation(inp).chunk(3, -1)
            x = gate * (normed * (1 + scale) + shift) + pose_tokens
            x = self.trunk(x)
            delta = self.pose_branch(self.trunk_norm(x))
            pred = delta if pred is None else pred + delta
        return torch.cat((pred[..., :7], F.relu(pred[..., 7:])), -1)


class ResidualConvUnit(nn.Module):
    """ReLU, 3x3, ReLU, 3x3, plus the skip. The published unit's ReLU is
    in place, so its skip carries ReLU(x)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, has_residual: bool = True):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.has_residual = has_residual
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                size=None) -> torch.Tensor:
        if self.has_residual:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            size = (2 * x.shape[-2], 2 * x.shape[-1])
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.out_conv(x)


@functools.lru_cache(maxsize=16)
def _dpt_pos_embed(h: int, w: int, channels: int, aspect: float,
                   device: torch.device) -> torch.Tensor:
    """The DPT head's position embedding [1, channels, h, w] x 0.1: a uv
    grid of the frame's aspect over the map, each coordinate's sin-cos
    embedding at frequencies 100^(-k / (channels / 4)), made in float64.
    A function of shapes alone, made once."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w,
                        dtype=torch.float32)
    ys = torch.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h,
                        dtype=torch.float32)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")

    def embed(p: torch.Tensor) -> torch.Tensor:
        half = channels // 4
        omega = torch.arange(half, dtype=torch.float64) / (channels / 4.0)
        omega = 1.0 / DPT_OMEGA ** omega
        out = p.reshape(-1).double()[:, None] * omega[None]
        return torch.cat((out.sin(), out.cos()), 1).float()

    emb = torch.cat((embed(uu), embed(vv)), -1).view(h, w, channels)
    return (emb * DPT_POS_RATIO).permute(2, 0, 1)[None].to(device)


class Scratch(nn.Module):
    def __init__(self, out_channels, features: int):
        super().__init__()
        for k, c in enumerate(out_channels):
            setattr(self, f"layer{k + 1}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        self.refinenet1 = FeatureFusionBlock(features)
        self.refinenet2 = FeatureFusionBlock(features)
        self.refinenet3 = FeatureFusionBlock(features)
        self.refinenet4 = FeatureFusionBlock(features, has_residual=False)
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, DPT_HEAD_FEATURES, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(DPT_HEAD_FEATURES, 2, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        dim, oc = 2 * cfg.embed_dim, cfg.dpt_out_channels
        self.cfg = cfg
        self.norm = nn.LayerNorm(dim)
        self.projects = nn.ModuleList(nn.Conv2d(dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(oc, cfg.dpt_features)

    def _pos(self, x: torch.Tensor, aspect: float) -> torch.Tensor:
        return x + _dpt_pos_embed(x.shape[-2], x.shape[-1], x.shape[1],
                                  aspect, x.device)

    def _chunk(self, outs, lo: int, hi: int, start: int, h: int, w: int):
        """The logits [n, 2, H, W] of frames lo..hi of every scan."""
        cfg = self.cfg
        aspect = w / h
        feats = []
        for k, layer in enumerate(cfg.dpt_layers):
            x = outs[layer][:, lo:hi, start:]
            x = self.norm(x.reshape(-1, *x.shape[2:]))
            ph, pw = h // cfg.patch_size, w // cfg.patch_size
            x = x.transpose(1, 2).reshape(x.shape[0], -1, ph, pw)
            x = self._pos(self.projects[k](x), aspect)
            feats.append(self.resize_layers[k](x))
        sc = self.scratch
        l1, l2, l3, l4 = (getattr(sc, f"layer{k + 1}_rn")(f)
                          for k, f in enumerate(feats))
        x = sc.refinenet4(l4, size=l3.shape[-2:])
        x = sc.refinenet3(x, l3, size=l2.shape[-2:])
        x = sc.refinenet2(x, l2, size=l1.shape[-2:])
        x = sc.output_conv1(sc.refinenet1(x, l1))
        x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
        return sc.output_conv2(self._pos(x, aspect))

    def forward(self, outs: dict, start: int, h: int, w: int):
        """outs {layer: [B, S, P, 2 C]} -> (x, c) [B, S, h, w]: the depth
        and confidence logits at the resized frame's size."""
        b, s = outs[self.cfg.dpt_layers[0]].shape[:2]
        logits = torch.cat([
            self._chunk(outs, lo, min(lo + FRAMES_CHUNK, s), start, h,
                        w).view(b, -1, 2, h, w)
            for lo in range(0, s, FRAMES_CHUNK)], 1)
        return logits[:, :, 0], logits[:, :, 1]


class VGGT(nn.Module):
    def __init__(self, cfg: VGGTConfig = VGGTConfig(), seed: int = 0):
        """Random weights from `seed` by the port's init scheme
        (models/layers.init_weights; LayerNorms at 1 and 0, tokens at 0,
        LayerScale at the published inits); load a state_dict for real
        ones."""
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = DPTHead(cfg)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()

    def resize(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs [B, S, H, W, 3] in 0..255 -> [B, S, 3, h, w] in [0, 1],
        float32, at the configuration's size."""
        b, s, height, width, _ = imgs.shape
        cfg = self.cfg
        x = imgs.reshape(b * s, height, width, 3).permute(0, 3, 1, 2).float()
        if (height, width) != (cfg.img_height, cfg.img_width):
            x = F.interpolate(x, size=(cfg.img_height, cfg.img_width),
                              mode="bicubic", antialias=True,
                              align_corners=False).clamp_(0.0, 255.0)
        return (x / 255.0).view(b, s, 3, cfg.img_height, cfg.img_width)

    def forward(self, imgs: torch.Tensor, cam_poses=None,
                cam_intr=None) -> dict:
        """imgs [B, S, H, W, 3] in 0..255 (uint8 or float), every frame of
        each scan; the cameras are not read. See the module's docstring
        for the output."""
        cfg = self.cfg
        b, s = imgs.shape[:2]
        trace.count("vggt.frames", b * s)
        trace.count("vggt.scans", b)
        images = self.resize(imgs)
        last = cfg.aa_depth - 1
        keep = {*cfg.dpt_layers, last}
        with torch.autocast(images.device.type,
                            dtype=torch_dtype(cfg.compute_dtype),
                            enabled=cfg.compute_dtype != "float32"):
            outs = self.aggregator(images, keep)
        h, w = cfg.img_height, cfg.img_width
        with torch.autocast(images.device.type, enabled=False):
            with trace.span("vggt_camera"):
                pose = self.camera_head(outs[last])
            with trace.span("vggt_depth_head"):
                x, c = self.depth_head(outs,
                                       self.aggregator.patch_start_idx, h, w)
        return {"depth": x.exp(), "confidence": 1 + c.exp(),
                "depth_logit": x, "confidence_logit": c, "pose_enc": pose}
