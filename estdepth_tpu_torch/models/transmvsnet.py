"""TransMVSNet: global context-aware multi-view stereo with transformers
(Ding et al., CVPR 2022, arXiv:2111.14600; megvii-research/TransMVSNet),
at the published widths on CasMVSNet's cascade (models/casmvsnet.py) and
the DTU evaluation setting of `config.CascadeConfig`.

Given the inputs of `CascadeMVSNet` (V views [B, V, H, W, 3] in 0..255,
view 0 the reference; cam-to-world poses; full-resolution intrinsics),
the network predicts the reference view's depth in three stages at 1/4,
1/2 and full resolution:

- CasMVSNet's FPN `FeatureNet(8)` gives each view 32, 16 and 8 channels
  (`mvs_features`);
- the Adaptive Receptive Field (ARF, `mvs_arf`): one modulated deformable
  3x3 convolution (DCNv2) on each of the three maps, channels kept, no
  bias, its 18 offsets (dy, dx a tap, taps row by row) and 9 sigmoid
  masks from one 3x3 convolution of the same map; bilinear taps, zero
  outside the map (`modulated_deform_conv3x3`: `F.grid_sample` and a 1x1
  convolution over the nine weighted taps);
- the Feature Matching Transformer (FMT, `mvs_fmt`) on the stage-1 maps,
  h w tokens of width 32 a view: SuperGlue's keypoint encoder of the
  normalised pixel positions added, then LoFTR's encoder layers
  ["self", "cross"] x 4 with linear attention (8 heads of 4). The
  reference view runs the self layers 0, 2, 4, 6 and keeps each output;
  each source view runs all 8, cross layer 2j + 1 attending to the
  reference's output j (its keys and values made once and shared by the
  sources). The reference's stage-1 map becomes its last output. A
  top-down pathway then carries the transformed stage-1 maps into stages
  2 and 3: stage k+1 = smooth_k(up(dim_reduction_k(stage k)) + stage k+1);
- stage k's per-pixel hypotheses and kernel 1's sweep are CasMVSNet's
  (`MVSCascade`); each swept source volume is correlated with the
  reference, the mean over channels of the product, [B, D, h, w] (one
  op, `estdepth::view_correlation`: a hand-written kernel on the card,
  the plain product and mean on the CPU); at
  stage 1 `PixelwiseNet` gives each source a weight a pixel (the max over
  D of the sigmoid of a 1x1x1 3D net), reused at stages 2 and 3 upsampled
  x2 (nearest); the volume is sum_i w_i c_i / (1e-5 + sum_i w_i), in view
  order (`mvs_cost_volume`);
- one `CostRegNet(1, 8)` a stage (`mvs_regularization`), under cuDNN's
  measured plans, its BatchNorms folded as CasMVSNet's;
- winner-take-all readout (`mvs_regression`): the softmax over D, the
  hypothesis at its argmax (the first maximum) as the stage's depth, the
  maximum probability as the confidence.

The output is CasMVSNet's dict ("depth", "confidence", "index" and
"stage_depths", the final stage's index its argmax) and "stage_indices",
each stage's argmax [B, h, w] (int64). Float32 with TF32 off only.

Counters (utils/trace.py): CasMVSNet's `mvs.targets` and
`mvs.feature_views`, and `mvs.fmt_tokens`: tokens times the FMT layers
they pass, h w (4 + 8 (V - 1)) a reference view (36 x 115,200 at
1152x1600 with 5 views). Host waits: CasMVSNet's, and
`host_wait.constant` around the copy of the position encoding's image
size, made on the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.config import CascadeConfig
from estdepth_tpu_torch.models.casmvsnet import (
    BASE_CHANNELS, CostRegNet, FeatureNet, MVSCascade,
)
from estdepth_tpu_torch.models.layers import (
    Conv2d, Conv3d, Linear, conv_bn, init_weights, upsample_nearest,
)
from estdepth_tpu_torch.ops.cuda.view_correlation import view_correlation
from estdepth_tpu_torch.ops.warp import plane_sweep_warp
from estdepth_tpu_torch.utils import trace

D_MODEL = 32  # the FMT's width: the stage-1 map's channels
N_HEAD = 8
LAYER_NAMES = ("self", "cross") * 4
EPS_ATTENTION = 1e-6  # LoFTR's LinearAttention
EPS_VIEW_WEIGHTS = 1e-5  # TransMVSNet's view_weight_sum
# row blocks of the K^T V sum over the source tokens (attention_memory)
BLOCKS = 256


def modulated_deform_conv3x3(x: torch.Tensor, offset: torch.Tensor,
                             mask: torch.Tensor,
                             weight: torch.Tensor) -> torch.Tensor:
    """DCNv2 with a 3x3 kernel, stride 1, padding 1: x [N, C, H, W],
    offset [N, 18, H, W] ((dy, dx) of tap k = 3 i + j at channels 2k,
    2k + 1), mask [N, 9, H, W], weight [O, C, 3, 3] -> [N, O, H, W]. Tap
    (i, j) of pixel (y, x) samples x bilinearly at (y + i - 1 + dy,
    x + j - 1 + dx), corners outside the map counting zero."""
    n, c, h, w = x.shape
    dev = x.device
    taps = torch.arange(-1, 2, dtype=x.dtype, device=dev)
    ty = taps.repeat_interleave(3).view(1, 9, 1, 1)
    tx = taps.repeat(3).view(1, 9, 1, 1)
    py = torch.arange(h, dtype=x.dtype, device=dev).view(1, 1, h, 1) + ty \
        + offset[:, 0::2]
    px = torch.arange(w, dtype=x.dtype, device=dev).view(1, 1, 1, w) + tx \
        + offset[:, 1::2]
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1)
    cols = F.grid_sample(x, grid.view(n, 9 * h, w, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=True)
    cols = cols.view(n, c, 9, h, w).mul_(mask[:, None])
    return F.conv2d(cols.view(n, c * 9, h, w),
                    weight.reshape(weight.shape[0], c * 9, 1, 1))


class DeformConv2d(nn.Conv2d):
    """ARF: a modulated deformable 3x3 convolution of C channels to C, no
    bias (`weight`), its offsets and masks from `offset_mask`, a 3x3
    convolution with bias (18 offsets, then 9 mask logits)."""

    def __init__(self, c: int):
        super().__init__(c, c, 3, padding=1, bias=False)
        self.offset_mask = Conv2d(c, 27, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.offset_mask(x)
        return modulated_deform_conv3x3(x, om[:, :18],
                                        torch.sigmoid(om[:, 18:]),
                                        self.weight)


class KeypointEncoder(nn.Module):
    """SuperGlue's MLP of 1x1 Conv1d layers 2 -> 32 -> 64 -> 128 -> 32,
    BatchNorm and ReLU after all but the last (`encoder`)."""

    def __init__(self, d: int = D_MODEL, widths=(32, 64, 128)):
        super().__init__()
        chans = (2, *widths, d)
        layers = []
        for i in range(1, len(chans)):
            layers.append(nn.Conv1d(chans[i - 1], chans[i], 1, bias=True))
            if i < len(chans) - 1:
                layers += [nn.BatchNorm1d(chans[i]), nn.ReLU()]
        self.encoder = nn.Sequential(*layers)


class PositionEncoding(nn.Module):
    """TransMVSNet's PositionEncodingSuperGule: pixel positions x = 1..w,
    y = 1..h, normalised as (p - size / 2) / (0.7 max(w, h)), through
    `kenc`; [1, D, h w], added to every view's map."""

    def __init__(self, d: int = D_MODEL):
        super().__init__()
        self.kenc = KeypointEncoder(d)

    def forward(self, h: int, w: int, device) -> torch.Tensor:
        ones = torch.ones(h, w, device=device)
        xy = torch.stack([ones.cumsum(1), ones.cumsum(0)]).view(2, -1)
        with trace.host_wait("constant"):
            size = torch.tensor([w, h], dtype=torch.float32, device=device)
        xy = (xy - (size / 2)[:, None]) / (size.max() * 0.7)
        return self.kenc.encoder(xy[None])


def linear_attention(q: torch.Tensor, kv: torch.Tensor, k_sum: torch.Tensor,
                     length: int) -> torch.Tensor:
    """LoFTR's LinearAttention for queries q [N, L, H, Dh], given the
    source's `attention_memory`: phi(Q) KV Z * S with
    Z = 1 / (phi(Q) . sum_s phi(K_s) + eps) -> [N, L, H, Dv]."""
    q = F.elu(q) + 1
    z = 1 / (torch.einsum("nlhd,nhd->nlh", q, k_sum) + EPS_ATTENTION)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * length


def attention_memory(k: torch.Tensor, v: torch.Tensor):
    """(KV [N, H, Dk, Dv], sum_s phi(K_s) [N, H, Dk], S) of keys and
    values [N, S, H, D], in LoFTR's order: the values divided by S first,
    phi(x) = elu(x) + 1.

    KV = sum_s phi(K_s)^T V_s / S is LoFTR's einsum "nshd,nshv->nhdv".
    As one GEMM a head, cuBLAS gives each 4x4 output a tile and sums the
    S rows in it alone: 3.2-3.5 ms a layer at S = 115,200 on an H100, 40
    of the FMT's 73 ms a view. Here the S rows are cut into `BLOCKS`
    blocks, each block's K^T V over all heads at once ([H Dk, H Dv]) is
    one matrix of a batched GEMM, the blocks are summed, and each head's
    KV is the diagonal [Dk, Dv] block: the same sums, added in another
    order."""
    k = F.elu(k) + 1
    n, length, h, dk = k.shape
    dv = v.shape[-1]
    v = v / length
    blocks = math.gcd(length, BLOCKS)
    rows = length // blocks
    full = torch.bmm(k.reshape(n * blocks, rows, h * dk).transpose(1, 2),
                     v.reshape(n * blocks, rows, h * dv))
    full = full.view(n, blocks, h, dk, h, dv).sum(1)
    kv = full.diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    return kv, k.sum(dim=1), length


class EncoderLayer(nn.Module):
    """LoFTR's LoFTREncoderLayer with linear attention, d_model 32, 8
    heads: the message merge(attention(q(x), k(src), v(src))), LayerNorm,
    an MLP on [x, message], LayerNorm, then x + message."""

    def __init__(self, d: int = D_MODEL, nhead: int = N_HEAD):
        super().__init__()
        self.nhead, self.dim = nhead, d // nhead
        self.q_proj = Linear(d, d, bias=False)
        self.k_proj = Linear(d, d, bias=False)
        self.v_proj = Linear(d, d, bias=False)
        self.merge = Linear(d, d, bias=False)
        self.mlp = nn.Sequential(Linear(2 * d, 2 * d, bias=False),
                                 nn.ReLU(True),
                                 Linear(2 * d, d, bias=False))
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[0], -1, self.nhead, self.dim)

    def memory(self, source: torch.Tensor):
        """This layer's keys and values of source tokens [N, S, D], as
        `attention_memory` gives them."""
        return attention_memory(self._heads(self.k_proj(source)),
                                self._heads(self.v_proj(source)))

    def forward(self, x: torch.Tensor, memory=None) -> torch.Tensor:
        """x [N, L, D]; `memory` of the source (None: x itself, a self
        layer)."""
        if memory is None:
            memory = self.memory(x)
        n = x.shape[0]
        message = linear_attention(self._heads(self.q_proj(x)), *memory)
        message = self.norm1(self.merge(message.reshape(n, -1, D_MODEL)))
        message = self.norm2(self.mlp(torch.cat([x, message], dim=2)))
        return x + message


class FeatureMatchingTransformer(nn.Module):
    """The FMT with its top-down pathway (TransMVSNet's FMT_with_pathway)
    over the three maps of B requests of V views."""

    def __init__(self, c: int = BASE_CHANNELS):
        super().__init__()
        self.pos_encoding = PositionEncoding(D_MODEL)
        self.layers = nn.ModuleList(EncoderLayer() for _ in LAYER_NAMES)
        self.dim_reduction_1 = Conv2d(4 * c, 2 * c, 1, bias=False)
        self.dim_reduction_2 = Conv2d(2 * c, c, 1, bias=False)
        self.smooth_1 = Conv2d(2 * c, 2 * c, 3, padding=1, bias=False)
        self.smooth_2 = Conv2d(c, c, 3, padding=1, bias=False)

    def _transform(self, stage1: torch.Tensor, b: int,
                   v: int) -> torch.Tensor:
        """Stage-1 maps [B V, D, h, w] -> the FMT's [B V, D, h, w]."""
        _, c, h, w = stage1.shape
        trace.count("mvs.fmt_tokens", b * h * w * (len(LAYER_NAMES) // 2
                                                    + len(LAYER_NAMES)
                                                    * (v - 1)))
        x = stage1.view(b * v, c, h * w) + self.pos_encoding(h, w,
                                                              stage1.device)
        x = x.transpose(1, 2).contiguous().view(b, v, h * w, c)
        ref, src = x[:, 0], x[:, 1:].reshape(b * (v - 1), h * w, c)
        for layer, name in zip(self.layers, LAYER_NAMES):
            if name == "self":
                ref, src = layer(ref), layer(src)
            else:  # the ref's keys and values, made once for its sources
                kv, k_sum, length = layer.memory(ref)
                src = layer(src, (kv.repeat_interleave(v - 1, 0),
                                  k_sum.repeat_interleave(v - 1, 0), length))
        out = torch.cat([ref[:, None], src.view(b, v - 1, h * w, c)], 1)
        return out.view(b * v, h * w, c).transpose(1, 2).reshape(
            b * v, c, h, w)

    @staticmethod
    def _upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                             align_corners=False) + y

    def forward(self, feats: list, b: int, v: int) -> list:
        s1 = self._transform(feats[0], b, v)
        s2 = self.smooth_1(self._upsample_add(self.dim_reduction_1(s1),
                                              feats[1]))
        s3 = self.smooth_2(self._upsample_add(self.dim_reduction_2(s2),
                                              feats[2]))
        return [s1, s2, s3]


class PixelwiseNet(nn.Module):
    """PatchmatchNet's PixelwiseNet: a 1x1x1 3D net 1 -> 16 -> 8 -> 1 of a
    correlation [B, 1, D, h, w], then the max over D of its sigmoid,
    [B, 1, h, w]."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv_bn(1, 16, 1, dims=3, act="relu")
        self.conv1 = conv_bn(16, 8, 1, dims=3, act="relu")
        self.conv2 = Conv3d(8, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(self.conv0(x)))[:, 0]
        return torch.sigmoid(x).amax(1, keepdim=True)


class TransMVSNet(MVSCascade):
    def __init__(self, cfg: CascadeConfig = CascadeConfig(), seed: int = 0):
        """Random weights from `seed` by the port's init scheme
        (models/layers.init_weights); load a state_dict for real ones."""
        super().__init__(cfg)
        c = BASE_CHANNELS
        self.feature = FeatureNet(c)
        self.arf = nn.ModuleList(DeformConv2d(4 * c >> k) for k in range(3))
        self.fmt = FeatureMatchingTransformer(c)
        self.pixel_wise_net = PixelwiseNet()
        self.cost_regularization = nn.ModuleList(
            CostRegNet(1, c) for _ in range(3))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()

    def _refine(self, feats, batch, views):
        with trace.span("mvs_arf"):
            feats = [arf(f) for arf, f in zip(self.arf, feats)]
        with trace.span("mvs_fmt"):
            return self.fmt(feats, batch, views)

    def _cost_volume(self, stage, maps, proj, hyp, weights):
        """The view-weighted correlation [B, 1, D, h, w] and the view
        weights [B, V - 1, h, w]: PixelwiseNet's at stage 1, the previous
        stage's upsampled x2 (nearest) after."""
        ref = maps[:, 0].contiguous()
        if weights is not None:
            weights = upsample_nearest(weights)
        made, num, den = [], None, None
        for i in range(1, maps.shape[1]):
            warped = plane_sweep_warp(maps[:, i].contiguous(), proj[:, i],
                                      proj[:, 0], hyp)
            corr = view_correlation(ref, warped)  # [B, D, h, w]
            del warped
            if weights is None:
                w_i = self.pixel_wise_net(corr[:, None])
                made.append(w_i)
            else:
                w_i = weights[:, i - 1:i]
            num = corr * w_i if num is None else num + corr * w_i
            den = EPS_VIEW_WEIGHTS + w_i if den is None else den + w_i
        volume = (num / den)[:, None]
        return volume, torch.cat(made, 1) if weights is None else weights

    def _readout(self, logits, hyp, last, out):
        """Winner take all: the hypothesis at the argmax of the softmax;
        its probability the confidence."""
        probs = torch.softmax(logits, 1)
        confidence, index = probs.max(1)
        out.setdefault("stage_indices", []).append(index)
        if last:
            out["confidence"], out["index"] = confidence, index
        return hyp.gather(1, index[:, None])[:, 0]
