"""VGGT in the port (models/vggt.py, eval/mvs.py) against the benchmark's
plain reference (portbench/reference/vggt.py), whole and by part, and its
structure at the published widths.

The small size is width 64 with 4 heads of 16, 2 DINOv2 blocks, 2
aggregator iterations, 3 frames of 64x80 resized to 56x70 (4 x 5 patches,
25 tokens a frame), a DPT head of 32 features, on seeded random weights
with LayerNorm scales and biases, LayerScales and tokens away from the
identity. The JAX package has no VGGT: the reference is the plain float32
forward written from the published code.

Tolerances: the port and the reference compute the same float32
expressions in other orders (SDPA's fused softmax against the written-out
one, the port's RoPE tables against the reference's per-call ones), which
moves results by a few ulp of values of order 1 through 4 blocks and a
convolution stack: 1e-5 absolute (measured below 2e-6) where a whole
forward or a head is compared, 1e-5 for one block.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from estdepth_tpu_torch.config import VGGTConfig
from estdepth_tpu_torch.eval.mvs import MVSRunner
from estdepth_tpu_torch.models import vggt
from estdepth_tpu_torch.utils import trace
from portbench.harness import models
from portbench.reference import vggt as reference
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(img_height=56, img_width=70, embed_dim=64, num_heads=4,
             dino_depth=2, aa_depth=2, pos_embed_grid=5,
             camera_trunk_depth=2, dpt_features=32,
             dpt_out_channels=(16, 32, 64, 64), dpt_layers=(0, 1, 1, 1),
             compute_dtype="float32")
CPU = torch.device("cpu")
ATOL = 1e-5


def _config(**model) -> dict:
    m = dataclasses.asdict(VGGTConfig(**dict(SMALL, **model)))
    return {"family": "vggt", "model": {k: list(v) if isinstance(v, tuple)
                                        else v for k, v in m.items()}}


def _state(cfg: dict, seed: int) -> dict:
    """The family's state of the seed, with every LayerNorm and LayerScale
    moved off the identity."""
    state = models.family(cfg)._with_rest(cfg, models.weights(cfg, seed,
                                                              CPU))
    gen = torch.Generator().manual_seed(seed)
    for k, t in state.items():
        if k.endswith(("norm.weight", "norm1.weight", "norm2.weight",
                       "q_norm.weight", "k_norm.weight", ".gamma")):
            state[k] = torch.empty_like(t).uniform_(0.5, 1.5, generator=gen)
        elif k.endswith(("norm.bias", "norm1.bias", "norm2.bias",
                         "q_norm.bias", "k_norm.bias")):
            state[k] = torch.empty_like(t).uniform_(-0.2, 0.2, generator=gen)
    return state


def _pair(seed: int = 3, **model):
    cfg = _config(**model)
    state = _state(cfg, seed)
    port = models.port(cfg, state, CPU)
    ref = models.reference(cfg, state, CPU)
    return port, ref


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _imgs(seed: int, frames: int = 3, h: int = 64, w: int = 80):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (1, frames, h, w, 3), generator=gen,
                         dtype=torch.uint8)


@torch.inference_mode()
def test_forward_follows_the_reference(pair):
    port, ref = pair
    imgs = _imgs(1)
    got, want = port(imgs), ref(imgs)
    for k in ("depth_logit", "confidence_logit", "pose_enc"):
        assert got[k].shape == want[k].shape
        torch.testing.assert_close(got[k], want[k], atol=ATOL, rtol=0)
    assert got["depth_logit"].shape == (1, 3, 56, 70)
    assert got["pose_enc"].shape == (1, 3, 9)
    assert torch.equal(got["depth"], got["depth_logit"].exp())
    assert torch.equal(got["confidence"], 1 + got["confidence_logit"].exp())
    assert float(want["depth_logit"].std()) > 1e-2  # no constant map


def _tokens(seed: int, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", ["frame", "global"])
@torch.inference_mode()
def test_a_block_alone_follows_the_reference(pair, kind):
    """Block 1 of each kind on tokens of 3 frames of 25 (5 special),
    [3, 25, 64] in a frame block, [1, 75, 64] in a global block, with
    their positions."""
    port, ref = pair
    b, s, p, c = 1, 3, 25, 64
    x = _tokens(5, b * s, p, c)
    pos = vggt.positions(4, 5, 5, CPU)
    if kind == "frame":
        rope, ref_pos = vggt.Rope2D(pos, 6, 16, 100.0), pos[None].expand(
            b * s, p, 2)
    else:
        x = x.reshape(b, s * p, c)
        rope = vggt.Rope2D(pos.repeat(s, 1), 6, 16, 100.0)
        ref_pos = pos.repeat(s, 1)[None]
    blocks = f"{kind}_blocks"
    got = getattr(port.aggregator, blocks)[1](x, rope)
    want = getattr(ref.aggregator, blocks)[1](x, ref_pos)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert float((got - x).abs().max()) > 0.1


def test_rope_positions_put_the_special_tokens_at_zero():
    """The camera token and 4 registers at (0, 0), patch (y, x) at
    (y + 1, x + 1) row by row; position 0 rotates nothing, and the port's
    tables rotate as the reference's RoPE."""
    pos = vggt.positions(4, 5, 5, CPU)
    assert pos.shape == (25, 2)
    assert torch.equal(pos[:5], torch.zeros(5, 2, dtype=torch.long))
    assert pos[5].tolist() == [1, 1] and pos[6].tolist() == [1, 2]
    assert pos[10].tolist() == [2, 1] and pos[-1].tolist() == [4, 5]
    x = _tokens(7, 2, 4, 25, 16)
    got = vggt.Rope2D(pos, 6, 16, 100.0)(x)
    want = reference.RotaryPositionEmbedding2D(100.0)(x, pos[None].expand(
        2, 25, 2))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(got[:, :, :5], x[:, :, :5])
    assert float((got[:, :, 5:] - x[:, :, 5:]).abs().max()) > 0.1
    # the row rotates the first half alone, the column the second: one
    # token at (1, 1) and at (1, 3) keeps its first half, not its second
    same_row = vggt.Rope2D(torch.tensor([[1, 1], [1, 3]]), 6, 16, 100.0)
    y = same_row(x[:, :, 5:6].expand(2, 4, 2, 16))
    assert torch.equal(y[..., 0, :8], y[..., 1, :8])
    assert float((y[..., 0, 8:] - y[..., 1, 8:]).abs().max()) > 0.1


def test_first_frame_and_other_frames_take_their_token_sets():
    tokens = torch.stack([torch.full((1, 3), 1.0), torch.full((1, 3), 2.0)])[
        None]  # [1, 2, 1, 3]
    out = vggt._first_and_rest(tokens, 2, 3)
    assert out.shape == (6, 1, 3)
    assert out[:, 0, 0].tolist() == [1.0, 2.0, 2.0, 1.0, 2.0, 2.0]
    assert torch.equal(out, reference.slice_expand_and_flatten(tokens, 2, 3))


@torch.inference_mode()
def test_first_frame_token_set_reaches_the_output(pair):
    """Moving the first-frame camera token moves the first frame's pose
    the most: the two sets are read where they belong."""
    port, ref = pair
    imgs = _imgs(2)
    base = port(imgs)["pose_enc"]
    saved = port.aggregator.camera_token.detach().clone()
    try:
        port.aggregator.camera_token[:, 0] += 2.0
        moved = port(imgs)["pose_enc"]
    finally:
        port.aggregator.camera_token.copy_(saved)
    gap = (moved - base).abs().amax(-1)[0]
    assert float(gap[0]) > float(gap[1:].max())


@torch.inference_mode()
def test_dpt_head_alone_follows_the_reference(pair):
    port, ref = pair
    b, s, p, c = 1, 3, 25, 128
    outs = [_tokens(11 + i, b, s, p, c) for i in range(2)]
    x, conf = port.depth_head({0: outs[0], 1: outs[1]}, 5, 56, 70)
    want = ref.depth_head(outs, 5, 56, 70)
    torch.testing.assert_close(x, want[:, :, 0], atol=ATOL, rtol=0)
    torch.testing.assert_close(conf, want[:, :, 1], atol=ATOL, rtol=0)
    assert x.shape == (1, 3, 56, 70)


@pytest.mark.parametrize("iterations", [1, 4])
@torch.inference_mode()
def test_camera_head_iterations_follow_the_reference(pair, iterations):
    """Each refinement iteration adds an update of the pose encoding; the
    port's last iteration equals the reference's after 1 and after 4."""
    port, ref = pair
    tokens = _tokens(13, 1, 3, 25, 128)
    port.camera_head.iterations = ref.camera_head.iterations = iterations
    try:
        got, want = port.camera_head(tokens), ref.camera_head(tokens)
    finally:
        port.camera_head.iterations = ref.camera_head.iterations = 4
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert float(got[..., 7:].min()) >= 0.0  # the field of view's ReLU
    if iterations == 4:
        once = port.camera_head.__class__.forward
        port.camera_head.iterations = 1
        try:
            first = once(port.camera_head, tokens)
        finally:
            port.camera_head.iterations = 4
        assert float((got - first).abs().max()) > 1e-3


@torch.inference_mode()
def test_global_attention_sees_the_other_frames(pair):
    """Changing frame 2 moves frame 0's depth, in the port and the
    reference alike; a frame block alone would leave it."""
    port, ref = pair
    imgs = _imgs(4)
    other = imgs.clone()
    other[0, 2] = _imgs(9)[0, 0]
    for model in (port, ref):
        a, b = model(imgs)["depth_logit"], model(other)["depth_logit"]
        assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-3
    got = port(other)["depth_logit"] - port(imgs)["depth_logit"]
    want = ref(other)["depth_logit"] - ref(imgs)["depth_logit"]
    torch.testing.assert_close(got[0, 0], want[0, 0], atol=2 * ATOL, rtol=0)


def test_autocast_region_holds_the_aggregator_alone():
    """Under the configuration's bf16 autocast (on the CPU here), the
    aggregator's linear layers compute bfloat16 while the heads take
    float32 inputs with autocast off and return float32."""
    port, _ = _pair(compute_dtype="bfloat16")
    seen = {}

    def record(name):
        def hook(_module, args, out):
            seen[name] = (args[0].dtype, out.dtype if torch.is_tensor(out)
                          else out[0].dtype,
                          torch.is_autocast_enabled("cpu"))
        return hook

    handles = [port.aggregator.frame_blocks[0].attn.qkv.register_forward_hook(
        record("qkv")),
        port.camera_head.register_forward_hook(record("camera")),
        port.camera_head.trunk[0].attn.qkv.register_forward_hook(
            record("camera_qkv")),
        port.depth_head.scratch.output_conv1.register_forward_hook(
            record("dpt_conv"))]
    try:
        with torch.inference_mode():
            out = port(_imgs(1))
    finally:
        for h in handles:
            h.remove()
    assert seen["qkv"][1:] == (torch.bfloat16, True)
    assert seen["camera"][:2] == (torch.float32, torch.float32)
    assert seen["camera_qkv"] == (torch.float32, torch.float32, False)
    assert seen["dpt_conv"] == (torch.float32, torch.float32, False)
    assert all(t.dtype == torch.float32 for t in out.values())


@pytest.mark.parametrize("part, count", [
    ("aggregator.patch_embed", 304_371_712),
    ("aggregator", 909_111_296),
    ("camera_head", 216_174_610),
    ("depth_head", 32_654_562)])
def test_structure_at_the_published_widths(part, count):
    """On the meta device: the port's and the reference's parameters of
    each part, name for name and shape for shape, at VGGT-1B's widths."""
    cfg = VGGTConfig()
    with torch.device("meta"):
        port = vggt.VGGT(cfg)
        ref = reference.VGGT(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)
                                if f.name not in ("mlp_ratio",
                                                  "compute_dtype")})
    got = dict(port.get_submodule(part).named_parameters())
    want = dict(ref.get_submodule(part).named_parameters())
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert sum(v.numel() for v in got.values()) == count


@torch.inference_mode()
def test_runner_runs_vggt_with_its_spans_and_counters(pair):
    """MVSRunner.run_view takes VGGT with the cascade models' call: the
    cameras are accepted and not read; the counters count frames, scans
    and S P tokens a scan; the spans open while a profiler records."""
    port, _ = pair
    runner = MVSRunner(port, device="cpu")
    imgs = _imgs(3)
    before = trace.counts()
    depth, conf = runner.run_view(imgs, torch.eye(4).expand(1, 3, 4, 4),
                                  torch.eye(3)[None])
    after = trace.counts()
    assert depth.shape == conf.shape == (1, 3, 56, 70)
    grow = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("vggt.frames", "vggt.scans", "vggt.global_tokens")}
    assert grow == {"vggt.frames": 3, "vggt.scans": 1,
                    "vggt.global_tokens": 3 * 25}
    again, _ = runner.run_view(imgs, torch.zeros(1, 3, 4, 4),
                               torch.zeros(1, 3, 3))
    assert torch.equal(depth, again)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner.run_view(imgs, torch.zeros(1, 3, 4, 4), torch.eye(3)[None])
    names = [e.name for e in prof.events()]
    for span, n in (("vggt_patch_embed", 1), ("vggt_frame", 2),
                    ("vggt_global", 2), ("vggt_camera", 1),
                    ("vggt_depth_head", 1), ("step", 1)):
        assert names.count(f"estdepth::{span}") == n, span
    # DINOv2 2, frame 2, global 2, camera trunk 2 x 4 iterations
    assert names.count("estdepth::attention") == 14


@pytest.mark.parametrize("bad, match", [
    (dict(compute_dtype="float16"), "compute_dtype"),
    (dict(embed_dim=72, num_heads=4), "multiple of 4"),
    (dict(img_height=57), "multiple of the patch"),
    (dict(dpt_layers=(0, 1, 2, 24)), "dpt_layers")])
def test_config_refuses_what_it_cannot_compute(bad, match):
    with pytest.raises(ValueError, match=match):
        VGGTConfig(**bad)
