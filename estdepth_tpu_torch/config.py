"""Model and eval configuration (port of estdepth_tpu/config.py).

The JAX package picks its warp implementation with a backend probe
(`resolve_warp_args`). Here the choice is a plain argument: the frustum
warp mode is `ModelConfig.frustum_mode`, one of "exact", "plane_mix" and
the eval tools' default "plane_mix_exact_z" (`resolve_frustum_mode` maps
the tools' flags to it). The kernel-backed warps run their CUDA kernel on
CUDA tensors and their plain PyTorch version on CPU tensors (ops/warp.py).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DepthNetHybrid hyper-parameters (reference model_hybrid.py:15-16)."""

    ndepths: int = 64
    depth_min: float = 0.01
    depth_max: float = 10.0
    resnet: int = 50
    # matching encoder family (model_hybrid.py:22 "featureNet: psm or
    # senet"): "psm" (models/psm.py) or "senet" (models/senet.py)
    feature_net: str = "psm"
    est_transformer: bool = True
    frustum_mode: str = "plane_mix_exact_z"
    # targets fused in the reference's order, each seeing the already fused
    # values of earlier targets; False fuses all targets in one batch
    sequential_fusion: bool = True
    # EST attention through the CUDA kernel (ops/cuda/epipolar_attention.py);
    # forward-only, so not for training
    use_fused_attention: bool = False
    # plane sweep through the fused two-pass resample (ops/cuda/two_pass.py)
    # instead of the exact bilinear sample: the counterpart of the JAX
    # package's pallas_warp=True under ESTDEPTH_FUSED_WARP=1
    two_pass_warp: bool = False
    # training only: the cost-volume pre-stack once per (target, neighbour)
    # pair and stereo_head1 once per target, in the reference's loop order,
    # so BatchNorm takes its batch statistics per call as the reference does
    sequential_cost_bn: bool = False
    # the dtype the model computes in (the JAX package's `compute_dtype`):
    # "float32" or "bfloat16". Parameters, BatchNorm statistics, attention
    # logits, softmaxes and the depth heads stay float32; activations, the
    # K/V volumes and the ESTM memory take this dtype.
    compute_dtype: str = "float32"

    @property
    def depth_interval(self) -> float:
        return (self.depth_max - self.depth_min) / (self.ndepths - 1)


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """CasMVSNet hyper-parameters (Gu et al., CVPR 2020, arXiv:1912.06378;
    cascade-stereo CasMVSNet/models/cas_mvsnet.py), defaults at the
    published DTU evaluation setting: `--ndepths 48,32,8
    --depth_inter_r 4,2,1`, 192 base planes of 2.5 mm x 1.06
    (`--interval_scale`) from 425 mm, in metres. The channel widths are
    the published FeatureNet(base_channels=8) and CostRegNet(8) and are
    not settings. Float32 only: `compute_dtype` takes no other value."""

    # planes of each cascade stage, at 1/4, 1/2 and full resolution
    stage_planes: tuple[int, ...] = (48, 32, 8)
    # each stage's hypothesis spacing in base intervals, stages 2 and 3
    # centred on the previous stage's depth (stage 1 spans the range)
    interval_ratios: tuple[int, ...] = (4, 2, 1)
    ndepths: int = 192  # base planes D0 of the scan's depth range
    depth_min: float = 0.425
    depth_interval: float = 0.00265  # the base interval
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: "
                             f"CascadeConfig computes float32 only")
        if len(self.stage_planes) != 3 or len(self.interval_ratios) != 3:
            raise ValueError(f"stage_planes {self.stage_planes} and "
                             f"interval_ratios {self.interval_ratios}: "
                             f"three stages each")
        if any(d % 8 for d in self.stage_planes):
            raise ValueError(f"stage_planes {self.stage_planes}: the 3D "
                             f"U-Net halves D three times (multiples of 8)")

    @property
    def depth_max(self) -> float:
        """The last of the D0 base planes."""
        return self.depth_min + (self.ndepths - 1) * self.depth_interval

    @property
    def forward_interval(self) -> float:
        """The interval the published forward spaces stages 2 and 3 by:
        (depth_max - depth_min) / D0 (cas_mvsnet.py), 191/192 of the base
        interval at D0 = 192."""
        return (self.depth_max - self.depth_min) / self.ndepths


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    """VGGT hyper-parameters (Wang et al., CVPR 2025, arXiv:2503.11347;
    facebookresearch/vggt, the `facebook/VGGT-1B` model), defaults at the
    published widths: a DINOv2 ViT-L/14 with 4 registers, 24 frame and 24
    global blocks of width 1024 (16 heads of 64), a camera head of 4 trunk
    blocks at width 2048 and 4 refinement iterations, and a DPT depth head
    of 256 features on aggregator outputs 4, 11, 17 and 23. Frames are
    resized to `img_height` x `img_width` (518 wide, a height that is a
    multiple of the patch: 378 for 1152x1600 frames)."""

    img_height: int = 378
    img_width: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    dino_depth: int = 24  # DINOv2's blocks
    aa_depth: int = 24  # the aggregator's frame / global block pairs
    pos_embed_grid: int = 37  # DINOv2's learned grid, 518 / 14
    rope_frequency: float = 100.0
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    dpt_features: int = 256
    dpt_out_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    dpt_layers: tuple[int, ...] = (4, 11, 17, 23)
    # the aggregator's autocast dtype ("float32": no autocast region)
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: "
                             f"bfloat16 (autocast) or float32")
        if self.embed_dim % (4 * self.num_heads):
            raise ValueError(f"embed_dim {self.embed_dim} over "
                             f"{self.num_heads} heads: 2D RoPE needs a "
                             f"head width that is a multiple of 4")
        if (self.img_height % self.patch_size
                or self.img_width % self.patch_size):
            raise ValueError(f"{self.img_height}x{self.img_width}: a "
                             f"multiple of the patch {self.patch_size}")
        if len(self.dpt_layers) != 4 or len(self.dpt_out_channels) != 4:
            raise ValueError("the DPT head reads four layers")
        if not all(0 <= i < self.aa_depth for i in self.dpt_layers):
            raise ValueError(f"dpt_layers {self.dpt_layers}: outputs of "
                             f"{self.aa_depth} aggregator iterations")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline settings (reference data/scannet.py,
    general_eval*.py)."""

    height: int = 256
    width: int = 320
    n_frames: int = 5  # training window length (train_hybrid.py defaults)
    frame_interval: int = 10  # every 10th frame (data/scannet.py:258)
    # ScanNet default intrinsics at 640x480 (data/scannet.py:83-87)
    fx: float = 577.870605
    fy: float = 577.870605
    cx: float = 319.5
    cy: float = 239.5
    depth_min: float = 0.01
    depth_max: float = 10.0
    min_valid_ratio: float = 0.5  # >= 50% valid depth (scannet.py:147-149)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (reference train_hybrid.py:80-97). The recipe
    card of the defaults; the train tool takes the same values as flags."""

    lr: float = 4e-5
    weight_decay: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.999
    epochs: int = 7
    lr_decay_epochs: tuple[int, ...] = (2, 4, 6)
    lr_decay_factor: float = 0.5
    warmup_steps: int = 500
    warmup_factor: float = 1.0 / 3.0
    # grad clip 10 for epochs < 3, then 1 (train_hybrid.py:94-97)
    clip_early: float = 10.0
    clip_late: float = 1.0
    clip_switch_epoch: int = 3
    batch_per_device: int = 1
    grad_accum: int = 1  # microbatches per step (trainer.make_train_step)
    remat: bool = False  # recompute the forward during the backward
    # BatchNorm statistics averaged over the data mesh in a data-parallel
    # run (models/layers.convert_sync_batchnorm; the reference's apex
    # sync-BN, train_hybrid.py:291-295)
    sync_bn: bool = True
    seed: int = 1
    loss_scale_weight: float = 0.8  # per-scale weight 0.8**scale
    summary_freq: int = 10
    ckpt_steps: int = 5000


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation protocol (eval_hybrid.py:76-78, eval_hybrid_seq.py:70),
    with the eval tools' frame size."""

    height: int = 256
    width: int = 320
    seq_length: int = 5  # Joint window
    lwindow: int = 3  # ESTM local window
    memory_size: int = 2  # ESTM FIFO memory entries
    eval_depth_min: float = 0.3  # scoring valid range (metric.py:4)
    eval_depth_max: float = 5.0


@dataclasses.dataclass(frozen=True)
class Config:
    """The four settings groups together (the JAX package's Config)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """`ModelConfig.compute_dtype` as a torch dtype."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}; one of "
                         f"{tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def tiny_config() -> tuple[ModelConfig, EvalConfig]:
    """Small shapes for unit tests and CPU dry runs."""
    return ModelConfig(ndepths=8), EvalConfig(height=64, width=96)


def resolve_frustum_mode(exact_warp: bool = False,
                         exact_z: bool = True) -> str:
    """The eval tools' warp flags as a `frustum_mode` (counterpart of the
    JAX package's `resolve_warp_args`, without its backend probe): the
    default is the exact-z plane-mix warp, `--no-exact-z` the plain
    plane-mix warp, and `--exact-warp` the reference's trilinear warp."""
    if exact_warp:
        return "exact"
    return "plane_mix_exact_z" if exact_z else "plane_mix"


def add_model_flags(parser) -> None:
    """The warp, attention and dtype flags shared by the eval tools."""
    parser.add_argument("--exact-warp", action="store_true",
                        help="the reference's trilinear frustum warp")
    parser.add_argument("--exact-z", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="exact-z correction on the plane-mix warp "
                             "(default on; --no-exact-z: plain plane-mix)")
    parser.add_argument("--fused-attention", action="store_true",
                        help="EST attention through its CUDA kernel")
    add_bf16_flag(parser)


def add_bf16_flag(parser) -> None:
    """`--bf16`: the model computes in bfloat16 (ModelConfig.compute_dtype),
    as the JAX tools' flag."""
    parser.add_argument("--bf16", action="store_true",
                        help="compute in bfloat16 (parameters, BatchNorm "
                             "statistics, softmaxes and depth heads stay "
                             "float32)")


def compute_dtype_flag(args) -> str:
    """The compute_dtype of a tool's `--bf16` flag."""
    return "bfloat16" if args.bf16 else "float32"


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; raise rather than run on the CPU when
    there is none. Pass `device="cpu"` to run the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def set_fp32_numerics() -> None:
    """Full-fp32 matmuls and convolutions: TF32 keeps ~3 decimal digits,
    and one-pass reduced precision measures ~1.15e-3 abs_rel against the
    fp32 reference (PARITY.md), over the 1e-3 gate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
