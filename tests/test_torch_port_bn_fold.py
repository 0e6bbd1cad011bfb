"""Eval-mode BatchNorm folded into the epilogue of the convolution before
it (models/layers.ConvBN, the block `conv_bn` and `deconv_bn` build).

On the CPU: each kind of block, with randomized running statistics, scale
and shift, run folded (eval mode, grad off, float32) against the same
block run as its children (nn.Sequential's forward), within float32
rounding: 1e-5 of the output's scale. A width shard's folded block
against the unsharded one; the calls that keep BatchNorm as its own op
(train mode, grad on, bf16, torch.export) and the counters
`layers.bn_folded` / `layers.bn_unfolded`; the folded pair's cache; the
state_dict names; CasMVSNet and both ESTDepth models folded against
themselves unfolded, within their parity rows' tolerances.

On the card (marked `cuda`): one CasMVSNet CostRegNet at a cut stage-2
shape folded against unfolded, and a profile of it that holds no cuDNN
BatchNorm kernel. The file imports no JAX, so the card runs it:

    python -m pytest tests/test_torch_port_bn_fold.py -m cuda --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

from estdepth_tpu_torch.config import CascadeConfig, ModelConfig
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_window,
)
from estdepth_tpu_torch.models import layers
from estdepth_tpu_torch.models.casmvsnet import CascadeMVSNet, CostRegNet
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.ops import shard_context
from estdepth_tpu_torch.utils import trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op PyTorch thread while the module runs, as
    tests/test_torch_port_common.one_torch_thread (which this file cannot
    import: that module imports JAX, and the card's machine has none)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(model: nn.Module, seed: int) -> nn.Module:
    """Scale, shift and running statistics away from the identity (a
    scale left at 0 by `zero_bn_scale` stays 0)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                if bool(m.weight.any()):
                    m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def _unfolded(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return nn.Sequential.forward(block, x)


def _close(got: torch.Tensor, want: torch.Tensor, rel: float = 1e-5):
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= rel * scale


def _counts():
    c = trace.counts()
    return c.get("layers.bn_folded", 0), c.get("layers.bn_unfolded", 0)


def _sync_bn3d(cin, cout):
    return layers.convert_sync_batchnorm(layers.conv_bn(cin, cout, 3, dims=3,
                                                        act="relu"))


# (block, input shape)
BLOCKS = {
    "2d": (lambda: layers.conv_bn(4, 6, 3, act="relu"), (2, 4, 12, 16)),
    "2d_strided_tanh": (lambda: layers.conv_bn(4, 6, 5, 2, act="tanh"),
                        (2, 4, 12, 16)),
    "2d_dilated": (lambda: layers.conv_bn(4, 6, 3, dilation=2),
                   (1, 4, 12, 16)),
    "2d_1x1": (lambda: layers.conv_bn(4, 6, 1, 2, pad=0), (1, 4, 12, 16)),
    "2d_zero_bn_scale": (lambda: layers.conv_bn(4, 6, 3, zero_bn_scale=True,
                                                act="relu"), (1, 4, 12, 16)),
    "3d": (lambda: layers.conv_bn(4, 6, 3, dims=3, act="relu"),
           (1, 4, 6, 8, 10)),
    "3d_strided": (lambda: layers.conv_bn(4, 6, 3, 2, dims=3, act="relu"),
                   (1, 4, 6, 8, 10)),
    "3d_dilated_tanh": (lambda: layers.conv_bn(4, 6, 3, dilation=2, dims=3,
                                               act="tanh"), (1, 4, 6, 8, 10)),
    "3d_1x1": (lambda: layers.conv_bn(4, 6, 1, pad=0, dims=3),
               (1, 4, 6, 8, 10)),
    "deconv": (lambda: layers.deconv_bn(6, 4), (1, 6, 3, 4, 5)),
    "deconv_no_act": (lambda: layers.deconv_bn(6, 4, act=None),
                      (1, 6, 3, 4, 5)),
    "sync_bn3d": (lambda: _sync_bn3d(4, 6), (1, 4, 6, 8, 10)),
}


def _block(name, seed=0):
    make, shape = BLOCKS[name]
    block = make()
    layers.init_weights(block, torch.Generator().manual_seed(seed))
    block = _randomize_bn(block, seed + 1).eval()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 2))
    return block, x


@pytest.mark.parametrize("name", list(BLOCKS))
def test_folded_block_is_the_block_within_rounding(name):
    block, x = _block(name)
    with torch.no_grad():
        want = _unfolded(block, x)
        before = _counts()
        got = block(x)
        assert _counts() == (before[0] + 1, before[1])
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    if name == "2d_zero_bn_scale":
        # a zero BatchNorm scale: the epilogue's scale is 0, the output
        # the shift
        assert not bool(block._fold[1].any())


class _TwoShards:
    """Rank `rank` of two width shards of one input, in one process: its
    halo columns are read from the whole input, zeros past its edges."""

    def __init__(self, whole: torch.Tensor, rank: int):
        self.whole, self.rank = whole, rank

    def halo(self, x, dim, left, right, value=0.0):
        assert dim == -1
        w = self.whole.shape[-1]
        lo, hi = self.rank * w // 2, (self.rank + 1) * w // 2
        assert x.shape[-1] == hi - lo
        padded = nn.functional.pad(self.whole, (left, right), value=value)
        return padded[..., lo:hi + left + right]


@pytest.mark.parametrize("name", ["2d", "2d_strided_tanh", "3d"])
def test_width_sharded_folded_block_is_the_unsharded_one(name):
    block, x = _block(name)
    w = x.shape[-1]
    with torch.no_grad():
        whole = block(x)
        parts = []
        for rank in range(2):
            shard = x[..., rank * w // 2:(rank + 1) * w // 2]
            with shard_context.width_sharded(_TwoShards(x, rank)):
                parts.append(block(shard))
        want = _unfolded(block, x)
    torch.testing.assert_close(torch.cat(parts, -1), whole, rtol=1e-6,
                               atol=1e-6)
    _close(whole, want)


def _export(block, x):
    class Wrap(nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, x):
            return self.block(x)

    with torch.no_grad():
        program = torch.export.export(Wrap().eval(), (x,), strict=False)
    ops = {str(n.target) for n in program.graph.nodes
           if n.op == "call_function"}
    assert any("batch_norm" in op for op in ops), ops
    return program.module()(x)


@pytest.mark.parametrize("mode, counted", [
    ("train", (0, 0)), ("grad", (0, 0)), ("bfloat16", (0, 1)),
    ("export", (0, 1)), ("inference_parameters", (0, 1))])
def test_batchnorm_runs_as_its_own_op_where_it_must(mode, counted):
    """Train mode (batch statistics), eval with grad on (the backward of
    the separate op), a bf16 input (a scale and shift rounded to bf16
    would be another result), an export (the artifact keeps the BatchNorm
    node) and a block built under torch.inference_mode (its inference
    tensors keep no version for the cache) run the children as they
    are."""
    if mode == "inference_parameters":
        with torch.inference_mode():
            block, x = _block("3d")
    else:
        block, x = _block("3d")
    ref = _randomize_bn(BLOCKS["3d"][0](), 1)
    ref.load_state_dict(block.state_dict())
    before = _counts()
    if mode == "train":
        block.train(), ref.train()
        with torch.no_grad():
            got, want = block(x), _unfolded(ref, x)
        torch.testing.assert_close(block[1].running_var, ref[1].running_var,
                                   rtol=0, atol=0)
    elif mode == "grad":
        # explicitly: another test file turns grad mode off at import
        with torch.enable_grad():
            got, want = block(x), _unfolded(ref.eval(), x)
        assert got.requires_grad
    elif mode == "bfloat16":
        x = x.to(torch.bfloat16)
        with torch.no_grad():
            got, want = block(x), _unfolded(ref.eval(), x)
        assert got.dtype == torch.bfloat16
    elif mode == "export":
        got = _export(block, x)
        with torch.no_grad():
            want = _unfolded(ref.eval(), x)
    else:
        with torch.inference_mode():
            got, want = block(x), _unfolded(ref.eval(), x)
    assert torch.equal(got, want)
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == counted
    assert block._fold is None


def test_fold_is_cached_and_rebuilt_when_its_sources_change():
    block, x = _block("3d")
    with torch.no_grad():
        block(x)
        fold = block._fold
        block(x)
        assert block._fold is fold  # no refold on a later call
        # an in-place edit of a running statistic
        block[1].running_var.mul_(2.0)
        _close(block(x), _unfolded(block, x))
        assert block._fold is not fold
        fold = block._fold
    # load_state_dict copies into the same tensors, bumping their versions
    other, _ = _block("3d", seed=5)
    block.load_state_dict(other.state_dict())
    with torch.no_grad():
        got = block(x)
        assert block._fold is not fold
        _close(got, _unfolded(other, x))
        # a new scale tensor (as .to() gives)
        block[1].weight = nn.Parameter(2 * block[1].weight)
        _close(block(x), _unfolded(block, x))


def test_state_dict_names_are_the_sequentials():
    block, x = _block("deconv")
    plain = nn.Sequential(*block)
    with torch.no_grad():
        block(x)
    assert isinstance(block, nn.Sequential)
    assert list(block.state_dict()) == list(plain.state_dict()) == [
        "0.weight", "1.weight", "1.bias", "1.running_mean",
        "1.running_var", "1.num_batches_tracked"]
    assert list(CostRegNet(16).state_dict())[:2] == ["conv0.0.weight",
                                                     "conv0.1.weight"]


def _no_fold(monkeypatch):
    monkeypatch.setattr(layers.ConvBN, "forward", nn.Sequential.forward)


def test_casmvsnet_folded_is_itself_unfolded(monkeypatch):
    """CasMVSNet at 64x96, 3 views, 16/8/8 planes: each stage's depth
    within 1e-5 m and the confidence within 1e-5 where idx agrees (at
    most a few idx flip on rounding), the tolerances of its row against
    the reference (tests/test_torch_port_casmvsnet.py)."""
    h, w = 64, 96
    model = _randomize_bn(CascadeMVSNet(CascadeConfig(stage_planes=(16, 8, 8)),
                                        seed=3), 4).eval()
    cfg = SyntheticSceneConfig(height=h, width=w, focal=2892.33 * w / 1600,
                               plane_offset=0.7, step_x=0.03, step_z=-0.0045,
                               yaw_per_frame=0.002)
    win = synthetic_window(cfg, 3, depth_min=0.5, depth_max=1.0)
    poses = win["cam_poses"].copy()
    poses[:, 1:, 1, 3] += np.float32(0.004)  # off the hard border mask
    args = (torch.from_numpy(win["imgs"]), torch.from_numpy(poses),
            torch.from_numpy(win["cam_intr"]))
    before = _counts()
    with torch.inference_mode():
        got = model(*args)
    folded = _counts()[0] - before[0]
    assert folded == 8 + 3 * 10  # the feature net's, ten a U-Net
    _no_fold(monkeypatch)
    with torch.inference_mode():
        want = model(*args)
    assert _counts()[0] == before[0] + folded
    for g, r in zip(got["stage_depths"], want["stage_depths"]):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    same = got["index"] == want["index"]
    assert (~same).sum() <= 6
    torch.testing.assert_close(got["confidence"][same],
                               want["confidence"][same], atol=1e-5, rtol=0)


@pytest.mark.parametrize("feature_net", ["psm", "senet"])
def test_depthnet_folded_is_itself_unfolded(monkeypatch, feature_net):
    """ESTDepth at 64x96, 8 planes, ResNet-18, a 5-frame window, EST off:
    the maps and probabilities within 1e-5 (absolute and relative), the
    tolerance of the serving artifacts' rows against the live runners
    (tests/test_torch_port_serving.py)."""
    model = _randomize_bn(DepthNetHybrid(ModelConfig(
        ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
        feature_net=feature_net), seed=0), 1).eval()
    cfg = SyntheticSceneConfig(height=64, width=96, focal=80.0)
    win = synthetic_window(cfg, 5, depth_min=0.5, depth_max=8.0)
    poses = win["cam_poses"].copy()
    poses[:, :, 1, 3] += np.float32(0.011) * np.arange(5, dtype=np.float32)
    args = (torch.from_numpy(win["imgs"]), torch.from_numpy(poses),
            torch.from_numpy(win["cam_intr"]))
    before = _counts()
    with torch.inference_mode():
        got = model(*args, use_est=False)[0]
    assert _counts()[0] > before[0]
    _no_fold(monkeypatch)
    with torch.inference_mode():
        want = model(*args, use_est=False)[0]
    for k in ("depth", "init_prob", "fused_prob"):
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   msg=k)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stage2_regnet(dev):
    """Stage 2's U-Net (16 channels in) on a cut stage-2 volume: 32 planes
    at 144x200, a sixteenth of the cell's 576x800."""
    torch.manual_seed(0)
    net = _randomize_bn(CostRegNet(16), 1).eval().to(dev)
    x = torch.randn(1, 16, 32, 144, 200, device=dev)
    return net, x


@pytest.mark.cuda
def test_card_regnet_folded_is_unfolded(dev, monkeypatch):
    net, x = _stage2_regnet(dev)
    with torch.inference_mode():
        got = net(x)
        torch.cuda.synchronize()
    _no_fold(monkeypatch)
    with torch.inference_mode():
        want = net(x)
    _close(got, want)


@pytest.mark.cuda
def test_card_regnet_folded_runs_no_batchnorm_kernel(dev):
    net, x = _stage2_regnet(dev)
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("conv" in n.lower() or "gemm" in n.lower() for n in names), \
        names  # the profiler saw the device's kernels
    assert not [n for n in names if "bn_fw" in n or "batch_norm" in n], names
