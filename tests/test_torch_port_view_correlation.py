"""TransMVSNet's correlation of a swept view with the reference as one op
(ops/cuda/view_correlation.py, `estdepth::view_correlation`) on the CPU,
where it runs its plain version.

The plain version is the expression the model ran before the op, held to
it bit for bit; `TransMVSNet._cost_volume` through the op is held to a
verbatim copy of the loop it ran before, bit for bit; the op passes
`torch.library.opcheck`; the wrapper refuses what the kernel does not
take on either device. The kernel itself is held to the plain version on
the card by tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import pytest
import torch

from estdepth_tpu_torch.config import CascadeConfig
from estdepth_tpu_torch.models.layers import upsample_nearest
from estdepth_tpu_torch.models.transmvsnet import (
    EPS_VIEW_WEIGHTS, TransMVSNet,
)
from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.ops.cuda import view_correlation as vc
from estdepth_tpu_torch.ops.warp import plane_sweep_warp
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, H, W = 2, 12, 16


def _cost_volume_before(model, maps, proj, hyp, weights):
    """TransMVSNet._cost_volume before the op, verbatim."""
    ref = maps[:, 0, None]
    if weights is not None:
        weights = upsample_nearest(weights)
    made, num, den = [], None, None
    for i in range(1, maps.shape[1]):
        warped = plane_sweep_warp(maps[:, i].contiguous(), proj[:, i],
                                  proj[:, 0], hyp)
        corr = (warped * ref).mean(-1)  # [B, D, h, w]
        del warped
        if weights is None:
            w_i = model.pixel_wise_net(corr[:, None])
            made.append(w_i)
        else:
            w_i = weights[:, i - 1:i]
        num = corr * w_i if num is None else num + corr * w_i
        den = EPS_VIEW_WEIGHTS + w_i if den is None else den + w_i
    volume = (num / den)[:, None]
    return volume, torch.cat(made, 1) if weights is None else weights


def _stage(v: int, c: int, d: int, seed: int = 0):
    """maps [B, V, H, W, C], proj [B, V, 4, 4] of V cameras a few cm
    apart, per-pixel hypotheses [B, D, H, W] around 1 m."""
    gen = torch.Generator().manual_seed(seed)
    maps = torch.randn(B, v, H, W, c, generator=gen)
    k = torch.tensor([[20.0, 0, (W - 1) / 2], [0, 20.0, (H - 1) / 2],
                      [0, 0, 1]]).expand(B * v, 3, 3)
    poses = torch.eye(4).repeat(B * v, 1, 1)
    poses[:, :3, 3] = 0.05 * torch.randn(B * v, 3, generator=gen)
    proj = geometry.camera_projection(k, poses).reshape(B, v, 4, 4)
    hyp = 0.8 + 0.4 * torch.rand(B, d, H, W, generator=gen)
    return maps, proj, hyp


def _volumes(c: int = 8, d: int = 5, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, W, c, generator=gen),
            torch.randn(B, d, H, W, c, generator=gen))


@pytest.mark.parametrize("d", [1, 5, 8])
@pytest.mark.parametrize("c", [8, 16, 32])
def test_plain_version_is_the_models_expression_before_the_op(c, d):
    """The op and its plain version, each bit for bit the expression the
    model ran before the op, `(warped * ref[:, None]).mean(-1)`, on
    random volumes; the inputs are left as they were."""
    ref, warped = _volumes(c, d)
    kept = ref.clone(), warped.clone()
    want = (warped * ref[:, None]).mean(-1)
    assert want.shape == (B, d, H, W) and want.is_contiguous()
    got = vc.view_correlation(ref, warped)
    assert got.is_contiguous() and torch.equal(got, want)
    assert torch.equal(vc.view_correlation_plain(ref, warped), want)
    assert torch.equal(ref, kept[0]) and torch.equal(warped, kept[1])


@pytest.fixture(scope="module")
def model():
    return TransMVSNet(CascadeConfig(stage_planes=(8, 8, 8)), seed=3)


@pytest.mark.parametrize("v,c,d,carried", [
    (3, 32, 8, False), (5, 16, 6, True), (5, 8, 8, False),
    (3, 8, 4, True)])
def test_cost_volume_is_the_models_loop_before_the_op(model, v, c, d,
                                                      carried):
    """`TransMVSNet._cost_volume` through the op, at batch 2 (the
    reference's map a strided view of the features) on real sweeps
    (kernel 1's plain version) of V views: the volume and the view
    weights bit for bit those of the loop the model ran before the op,
    with PixelwiseNet's weights made (stage 1) or carried from the stage
    before at half the size."""
    maps, proj, hyp = _stage(v, c, d)
    carry = (torch.rand(B, v - 1, H // 2, W // 2,
                        generator=torch.Generator().manual_seed(2))
             if carried else None)
    with torch.inference_mode():
        want = _cost_volume_before(model, maps, proj, hyp, carry)
        got = model._cost_volume(0, maps, proj, hyp, carry)
    assert want[0].shape == (B, 1, d, H, W)
    assert want[1].shape == (B, v - 1, H, W)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[0] != 0).any()


def test_op_passes_opcheck():
    ref, warped = _volumes()
    torch.library.opcheck(vc.OP, (ref, warped))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = vc.OP(mode.from_tensor(ref), mode.from_tensor(warped))
    assert fake.shape == (B, 5, H, W) and fake.dtype == torch.float32
    assert fake.is_contiguous()


def _refusal_cases():
    ref, warped = _volumes(8, 5)
    return {
        "float64 ref": (TypeError, ref.double(), warped),
        "bfloat16 volume": (TypeError, ref, warped.bfloat16()),
        "strided ref": (ValueError, ref.transpose(1, 2).contiguous()
                        .transpose(1, 2), warped),
        "strided volume": (ValueError, ref,
                           torch.zeros(B, 5, H, W, 16)[..., 8:]),
        "ref of 5 dims": (ValueError, ref[:, None], warped),
        "volume of 4 dims": (ValueError, ref, warped[:, 0]),
        "volume of another size": (ValueError, ref, warped[:, :, 1:]
                                   .contiguous()),
        "other channels": (ValueError, ref, warped[..., :4].contiguous()),
        "C % 4": (ValueError, ref[..., :6].contiguous(),
                  warped[..., :6].contiguous()),
        "C > 512": (ValueError, torch.zeros(1, 2, 2, 516),
                    torch.zeros(1, 3, 2, 2, 516)),
        "volume on another device": (ValueError, ref,
                                     warped.to("meta")),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    error, ref, warped = _refusal_cases()[case]
    with pytest.raises(error):
        vc.view_correlation(ref, warped)
