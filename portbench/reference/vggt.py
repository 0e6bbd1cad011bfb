"""Plain PyTorch reference of VGGT (Wang et al., CVPR 2025,
arXiv:2503.11347; facebookresearch/vggt), its depth and camera branches:
the forward pass of the published Aggregator (with DINOv2 ViT-L/14-reg
as its patch embedding), CameraHead and DPTHead, written from the paper
and the published description with no kernel, autocast, fused attention
or cache of the port. Float32 by default, TF32 off for matmuls and cuDNN
(the harness sets it); the module can be cast whole to another dtype
(the output check's control casts it to bfloat16), and then computes
everything, the residual stream included, in that dtype. Nothing of the
port is imported; module and parameter names are the published ones and
the port's (estdepth_tpu_torch/models/vggt.py), so one state_dict loads
strictly into both.

Softmax attention is written out, softmax(q k^T / sqrt(d)) v, in blocks
of `ROWS` query rows: the 49-frame global attention's 49,196 x 49,196
score matrix a head would not fit, and the softmax is taken row by row,
so the blocks give the same result.

Departures from the published code, each also in the configuration's
`assumed`:

- the point head and the track head are not built, nor DINOv2's
  training-only mask token;
- frames are resized with `F.interpolate` (bicubic, antialias, clamped
  to 0..255, not rounded to uint8) in place of PIL's bicubic resize;
- LayerNorm epsilons: 1e-6 in DINOv2 and the camera head's adaLN norm,
  PyTorch's default 1e-5 elsewhere (the aggregator's blocks, QK-norm, the
  camera trunk and the heads' norms);
- the residual conv unit's skip carries ReLU(x), as the published unit's
  in-place ReLU makes it;
- DINOv2's position embedding is resized to the patch grid by size
  (interpolate_offset 0), bicubic with antialias.

`forward` returns {"depth_logit", "confidence_logit"} [B, S, h, w] and
"pose_enc" [B, S, 9], the last camera iteration's; the depth is
exp(depth_logit), the confidence 1 + exp(confidence_logit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

ROWS = 1024  # query rows a block of attention
FRAMES = 8  # frames the depth head takes at a time (frames_chunk_size)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v of q, k, v [B, heads, N, d], in blocks of
    ROWS query rows. q is scaled before the product, which saves a pass
    over the scores and is exact where sqrt(d) is a power of two (d = 64)."""
    q = q * q.shape[-1] ** -0.5
    kt = k.transpose(-2, -1)
    return torch.cat([torch.matmul(torch.softmax(
        torch.matmul(q[..., i:i + ROWS, :], kt), dim=-1), v)
        for i in range(0, q.shape[-2], ROWS)], dim=-2)


class RotaryPositionEmbedding2D(nn.Module):
    """The published 2D RoPE: a head's first half rotated by the token's
    row, the second by its column, each by a 1D RoPE of base `frequency`
    (x cos + rotate_half(x) sin)."""

    def __init__(self, frequency=100.0):
        super().__init__()
        self.frequency = frequency

    def components(self, dim, seq_len, device, dtype):
        exponents = torch.arange(0, dim, 2, device=device).float() / dim
        inv_freq = 1.0 / (self.frequency ** exponents)
        positions = torch.arange(seq_len, device=device,
                                 dtype=inv_freq.dtype)
        angles = torch.einsum("i,j->ij", positions, inv_freq).to(dtype)
        angles = torch.cat((angles, angles), dim=-1)
        return angles.cos().to(dtype), angles.sin().to(dtype)

    @staticmethod
    def rotate(x):
        d = x.shape[-1]
        return torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)

    def rope_1d(self, x, pos, cos, sin):
        cos = F.embedding(pos, cos)[:, None]
        sin = F.embedding(pos, sin)[:, None]
        return x * cos + self.rotate(x) * sin

    def forward(self, tokens, pos):
        """tokens [B, heads, N, d], pos [B, N, 2] long (row, column), each
        below N. The tables hold a row for each of the N tokens, which
        covers every position without reading the largest on the host."""
        dim = tokens.shape[-1] // 2
        cos, sin = self.components(dim, pos.shape[-2], tokens.device,
                                   tokens.dtype)
        rows, cols = tokens.chunk(2, dim=-1)
        return torch.cat((self.rope_1d(rows, pos[..., 0], cos, sin),
                          self.rope_1d(cols, pos[..., 1], cos, sin)), dim=-1)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim, heads, qk_norm=False, rope=None, eps=1e-5):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = nn.LayerNorm(dim // heads, eps=eps) if qk_norm else \
            nn.Identity()
        self.k_norm = nn.LayerNorm(dim // heads, eps=eps) if qk_norm else \
            nn.Identity()
        self.proj = nn.Linear(dim, dim)
        self.rope = rope

    def forward(self, x, pos=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        q, k = self.q_norm(q), self.k_norm(k)
        if self.rope is not None:
            q, k = self.rope(q, pos), self.rope(k, pos)
        x = attention(q, k, v)
        return self.proj(x.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim, heads, qk_norm=False, rope=None, eps=1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, qk_norm, rope, eps)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x, pos=None):
        x = x + self.ls1(self.attn(self.norm1(x), pos))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoVisionTransformer(nn.Module):
    def __init__(self, dim, heads, depth, registers, patch, grid):
        super().__init__()
        self.patch = patch
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, registers, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, eps=1e-6)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        """x [N, 3, H, W] -> the final-LayerNorm patch tokens."""
        n, _, height, width = x.shape
        h, w = height // self.patch, width // self.patch
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat((self.cls_token.expand(n, -1, -1), x), dim=1)
        pos = self.pos_embed.float()
        m = round((pos.shape[1] - 1) ** 0.5)
        grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(h, w), mode="bicubic",
                             antialias=True)
        grid = grid.permute(0, 2, 3, 1).reshape(1, h * w, -1)
        x = x + torch.cat((pos[:, :1], grid), dim=1).to(x.dtype)
        x = torch.cat((x[:, :1], self.register_tokens.expand(n, -1, -1),
                       x[:, 1:]), dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1 + self.register_tokens.shape[1]:]


def slice_expand_and_flatten(tokens, b, s):
    """[1, 2, X, C] -> [B S, X, C]: set 0 for each first frame, set 1 for
    the others."""
    first = tokens[:, 0:1].expand(b, 1, *tokens.shape[2:])
    rest = tokens[:, 1:].expand(b, s - 1, *tokens.shape[2:])
    return torch.cat((first, rest), dim=1).reshape(b * s, *tokens.shape[2:])


class Aggregator(nn.Module):
    def __init__(self, dim, heads, dino_depth, depth, registers, patch,
                 grid, frequency):
        super().__init__()
        self.patch = patch
        self.rope = RotaryPositionEmbedding2D(frequency)
        self.patch_embed = DinoVisionTransformer(dim, heads, dino_depth,
                                                 registers, patch, grid)
        self.frame_blocks = nn.ModuleList(
            Block(dim, heads, qk_norm=True, rope=self.rope)
            for _ in range(depth))
        self.global_blocks = nn.ModuleList(
            Block(dim, heads, qk_norm=True, rope=self.rope)
            for _ in range(depth))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, dim))
        self.register_token = nn.Parameter(torch.zeros(1, 2, registers, dim))
        self.patch_start_idx = 1 + registers

    def forward(self, images):
        """images [B, S, 3, H, W] in [0, 1] -> the list of every
        iteration's output [B, S, P, 2 C]."""
        b, s, _, height, width = images.shape
        mean = torch.tensor(MEAN, device=images.device,
                            dtype=images.dtype).view(1, 1, 3, 1, 1)
        std = torch.tensor(STD, device=images.device,
                           dtype=images.dtype).view(1, 1, 3, 1, 1)
        images = (images - mean) / std
        patches = self.patch_embed(images.reshape(b * s, 3, height, width))
        tokens = torch.cat((slice_expand_and_flatten(self.camera_token, b, s),
                            slice_expand_and_flatten(self.register_token, b,
                                                     s),
                            patches), dim=1)
        h, w = height // self.patch, width // self.patch
        yy, xx = torch.meshgrid(torch.arange(h, device=images.device),
                                torch.arange(w, device=images.device),
                                indexing="ij")
        pos = torch.stack((yy.reshape(-1), xx.reshape(-1)), dim=-1) + 1
        pos = torch.cat((torch.zeros(self.patch_start_idx, 2,
                                     dtype=pos.dtype, device=pos.device),
                         pos))
        _, p, c = tokens.shape
        frame_pos = pos[None].expand(b * s, p, 2)
        global_pos = pos[None].expand(b, s, p, 2).reshape(b, s * p, 2)
        outputs = []
        for frame_block, global_block in zip(self.frame_blocks,
                                             self.global_blocks):
            tokens = frame_block(tokens.reshape(b * s, p, c), frame_pos)
            frame = tokens.reshape(b, s, p, c)
            tokens = global_block(tokens.reshape(b, s * p, c), global_pos)
            outputs.append(torch.cat((frame, tokens.reshape(b, s, p, c)),
                                     dim=-1))
        return outputs


class CameraHead(nn.Module):
    def __init__(self, dim, heads, trunk_depth, iterations):
        super().__init__()
        self.iterations = iterations
        self.trunk = nn.Sequential(*(Block(dim, heads)
                                     for _ in range(trunk_depth)))
        self.token_norm = nn.LayerNorm(dim)
        self.trunk_norm = nn.LayerNorm(dim)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(),
                                               nn.Linear(dim, 3 * dim))
        self.adaln_norm = nn.LayerNorm(dim, elementwise_affine=False,
                                       eps=1e-6)
        self.pose_branch = Mlp(dim, dim // 2, 9)

    def forward(self, tokens):
        pose_tokens = self.token_norm(tokens[:, :, 0])
        b, s, _ = pose_tokens.shape
        pred = None
        for _ in range(self.iterations):
            if pred is None:
                module_input = self.embed_pose(
                    self.empty_pose_tokens.expand(b, s, -1))
            else:
                module_input = self.embed_pose(pred)
            shift, scale, gate = self.poseLN_modulation(
                module_input).chunk(3, dim=-1)
            x = gate * (self.adaln_norm(pose_tokens) * (1 + scale) + shift)
            x = self.trunk(x + pose_tokens)
            delta = self.pose_branch(self.trunk_norm(x))
            pred = delta if pred is None else pred + delta
        return torch.cat((pred[..., :3], pred[..., 3:7],
                          F.relu(pred[..., 7:])), dim=-1)


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        x = F.relu(x)  # the published ReLU is in place: the skip is ReLU(x)
        out = self.conv2(F.relu(self.conv1(x)))
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, has_residual=True):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.has_residual = has_residual
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, *xs, size=None):
        out = xs[0]
        if self.has_residual:
            out = out + self.resConfUnit1(xs[1])
        out = self.resConfUnit2(out)
        if size is None:
            size = (out.shape[-2] * 2, out.shape[-1] * 2)
        out = F.interpolate(out, size=size, mode="bilinear",
                            align_corners=True)
        return self.out_conv(out)


def make_sincos_pos_embed(dim, pos, omega_0=100.0):
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device)
    omega = 1.0 / omega_0 ** (omega / (dim / 2.0))
    out = torch.einsum("m,d->md", pos.reshape(-1).double(), omega)
    return torch.cat((torch.sin(out), torch.cos(out)), dim=1).float()


def uv_position_embed(x, aspect, ratio=0.1):
    """x [N, C, h, w] plus the sin-cos embedding of a uv grid of the
    frame's aspect over its h x w, times `ratio`."""
    _, c, h, w = x.shape
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w,
                        device=x.device)
    ys = torch.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h,
                        device=x.device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")
    emb = torch.cat((make_sincos_pos_embed(c // 2, uu),
                     make_sincos_pos_embed(c // 2, vv)), dim=-1)
    emb = emb.view(h, w, c).permute(2, 0, 1)[None].to(x.dtype)
    return x + emb * ratio


class Scratch(nn.Module):
    def __init__(self, out_channels, features):
        super().__init__()
        self.layer1_rn = nn.Conv2d(out_channels[0], features, 3, padding=1,
                                   bias=False)
        self.layer2_rn = nn.Conv2d(out_channels[1], features, 3, padding=1,
                                   bias=False)
        self.layer3_rn = nn.Conv2d(out_channels[2], features, 3, padding=1,
                                   bias=False)
        self.layer4_rn = nn.Conv2d(out_channels[3], features, 3, padding=1,
                                   bias=False)
        self.refinenet1 = FeatureFusionBlock(features)
        self.refinenet2 = FeatureFusionBlock(features)
        self.refinenet3 = FeatureFusionBlock(features)
        self.refinenet4 = FeatureFusionBlock(features, has_residual=False)
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 2, 1))


class DPTHead(nn.Module):
    def __init__(self, dim, patch, features, out_channels, layers):
        super().__init__()
        self.patch, self.layers = patch, layers
        self.norm = nn.LayerNorm(dim)
        self.projects = nn.ModuleList(nn.Conv2d(dim, c, 1)
                                      for c in out_channels)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, 4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, 2, 1)])
        self.scratch = Scratch(out_channels, features)

    def forward(self, outputs, start, height, width):
        """FRAMES frames at a time, as published: the logits
        [B, S, 2, H, W]."""
        b, s = outputs[0].shape[:2]
        h, w = height // self.patch, width // self.patch
        chunks = []
        for lo in range(0, s, FRAMES):
            feats = []
            for k, layer in enumerate(self.layers):
                x = self.norm(outputs[layer][:, lo:lo + FRAMES, start:])
                n = x.shape[0] * x.shape[1]
                x = x.reshape(n, h * w, -1).permute(0, 2, 1).reshape(
                    n, -1, h, w)
                x = uv_position_embed(self.projects[k](x), width / height)
                feats.append(self.resize_layers[k](x))
            sc = self.scratch
            l1, l2 = sc.layer1_rn(feats[0]), sc.layer2_rn(feats[1])
            l3, l4 = sc.layer3_rn(feats[2]), sc.layer4_rn(feats[3])
            x = sc.refinenet4(l4, size=l3.shape[2:])
            x = sc.refinenet3(x, l3, size=l2.shape[2:])
            x = sc.refinenet2(x, l2, size=l1.shape[2:])
            x = sc.output_conv1(sc.refinenet1(x, l1))
            x = F.interpolate(x, size=(height, width), mode="bilinear",
                              align_corners=True)
            x = sc.output_conv2(uv_position_embed(x, width / height))
            chunks.append(x.reshape(b, -1, *x.shape[1:]))
        return torch.cat(chunks, dim=1)


class VGGT(nn.Module):
    def __init__(self, img_height=378, img_width=518, patch_size=14,
                 embed_dim=1024, num_heads=16, num_register_tokens=4,
                 dino_depth=24, aa_depth=24, pos_embed_grid=37,
                 rope_frequency=100.0, camera_trunk_depth=4,
                 camera_iterations=4, dpt_features=256,
                 dpt_out_channels=(256, 512, 1024, 1024),
                 dpt_layers=(4, 11, 17, 23)):
        super().__init__()
        self.size = (img_height, img_width)
        self.aggregator = Aggregator(
            embed_dim, num_heads, dino_depth, aa_depth, num_register_tokens,
            patch_size, pos_embed_grid, rope_frequency)
        self.camera_head = CameraHead(2 * embed_dim, num_heads,
                                      camera_trunk_depth, camera_iterations)
        self.depth_head = DPTHead(2 * embed_dim, patch_size, dpt_features,
                                  dpt_out_channels, dpt_layers)

    def forward(self, imgs, cam_poses=None, cam_intr=None):
        """imgs [B, S, H, W, 3] in 0..255; the cameras are not read."""
        dtype = self.aggregator.camera_token.dtype
        b, s, height, width, _ = imgs.shape
        x = imgs.reshape(b * s, height, width, 3).permute(0, 3, 1, 2)
        x = x.to(torch.float32)
        if (height, width) != self.size:
            x = F.interpolate(x, size=self.size, mode="bicubic",
                              antialias=True, align_corners=False)
            x = x.clamp(0.0, 255.0)
        images = (x / 255.0).to(dtype).reshape(b, s, 3, *self.size)
        outputs = self.aggregator(images)
        pose = self.camera_head(outputs[-1])
        logits = self.depth_head(outputs, self.aggregator.patch_start_idx,
                                 *self.size)
        return {"depth_logit": logits[:, :, 0], "confidence_logit":
                logits[:, :, 1], "pose_enc": pose}
