"""CasMVSNet's variance over the views as one op (ops/cuda/view_variance.py,
`estdepth::view_variance`) on the CPU, where it runs its plain version.

The plain version is the arithmetic the model ran before the op, held to
a verbatim copy of that loop bit for bit; the op passes
`torch.library.opcheck`; the wrapper refuses what the kernel does not
take on either device. The kernel itself is held to the plain version on
the card by tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import pytest
import torch

from estdepth_tpu_torch.models.casmvsnet import CascadeMVSNet
from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.ops.cuda import view_variance as vv
from estdepth_tpu_torch.ops.warp import plane_sweep_warp
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, H, W, D = 2, 12, 16, 5


def _variance_before(maps, proj, hyp):
    """CascadeMVSNet._variance before the op, verbatim."""
    b, v, h, w, c = maps.shape
    d = hyp.shape[1]
    ref = maps[:, 0, None].expand(b, d, h, w, c)
    total = ref.clone()
    squares = ref.square()
    for i in range(1, v):
        warped = plane_sweep_warp(maps[:, i].contiguous(), proj[:, i],
                                  proj[:, 0], hyp)
        total += warped
        squares += warped.square_()
        del warped
    var = squares.div_(v).sub_(total.div_(v).square_())
    return var.permute(0, 4, 1, 2, 3).contiguous()


def _stage(v: int, c: int, seed: int = 0):
    """maps [B, V, H, W, C], proj [B, V, 4, 4] of V cameras a few cm
    apart, per-pixel hypotheses [B, D, H, W] around 1 m."""
    gen = torch.Generator().manual_seed(seed)
    maps = torch.randn(B, v, H, W, c, generator=gen)
    k = torch.tensor([[20.0, 0, (W - 1) / 2], [0, 20.0, (H - 1) / 2],
                      [0, 0, 1]]).expand(B * v, 3, 3)
    poses = torch.eye(4).repeat(B * v, 1, 1)
    poses[:, :3, 3] = 0.05 * torch.randn(B * v, 3, generator=gen)
    proj = geometry.camera_projection(k, poses).reshape(B, v, 4, 4)
    hyp = 0.8 + 0.4 * torch.rand(B, D, H, W, generator=gen)
    return maps, proj, hyp


def _volumes(v: int = 3, c: int = 8, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    ref = torch.randn(B, H, W, c, generator=gen)
    return ref, [torch.randn(B, D, H, W, c, generator=gen)
                 for _ in range(v - 1)]


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("v", [2, 3, 5])
def test_plain_version_is_the_models_loop_before_the_op(v, c):
    """The model's `_variance`, the op and its plain version, each bit for
    bit the loop the model ran before the op, on real sweeps (kernel 1's
    plain version) of V views; the swept volumes are left as they were."""
    maps, proj, hyp = _stage(v, c)
    want = _variance_before(maps, proj, hyp)
    assert want.shape == (B, c, D, H, W) and want.is_contiguous()
    assert torch.equal(CascadeMVSNet._variance(maps, proj, hyp), want)
    ref = maps[:, 0].contiguous()
    warped = [plane_sweep_warp(maps[:, i].contiguous(), proj[:, i],
                               proj[:, 0], hyp) for i in range(1, v)]
    kept = [w.clone() for w in warped]
    got = vv.view_variance(ref, warped)
    assert got.is_contiguous() and torch.equal(got, want)
    assert torch.equal(vv.view_variance_plain(ref, warped), want)
    assert all(torch.equal(a, b) for a, b in zip(warped, kept))
    assert (want != 0).any()


def test_op_passes_opcheck():
    ref, warped = _volumes()
    torch.library.opcheck(vv.OP, (ref, warped))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = vv.OP(mode.from_tensor(ref),
                     [mode.from_tensor(w) for w in warped])
    assert fake.shape == (B, 8, D, H, W) and fake.dtype == torch.float32
    assert fake.is_contiguous()


def test_sixteen_source_views_are_taken():
    ref, warped = _volumes(17, 4)
    got = vv.view_variance(ref, warped)
    assert torch.equal(got, vv.view_variance_plain(ref, warped))


def _refusal_cases():
    ref, warped = _volumes(3, 8)
    other_d = torch.zeros(B, D + 1, H, W, 8)
    return {
        "17 sources": (ValueError, ref, warped * 8 + warped[:1]),
        "no source": (ValueError, ref, []),
        "volumes of two depths": (ValueError, ref, [warped[0], other_d]),
        "other channels": (ValueError, ref, [w[..., :4].contiguous()
                                             for w in warped]),
        "ref of 5 dims": (ValueError, ref[:, None], warped),
        "float64 ref": (TypeError, ref.double(), warped),
        "bfloat16 volume": (TypeError, ref, [warped[0].bfloat16(),
                                             warped[1]]),
        "strided ref": (ValueError, ref.transpose(1, 2).contiguous()
                        .transpose(1, 2), warped),
        "strided volume": (ValueError, ref,
                           [warped[0], torch.zeros(B, D, H, W, 16)[..., 8:]]),
        "C % 4": (ValueError, ref[..., :6].contiguous(),
                  [w[..., :6].contiguous() for w in warped]),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    error, ref, warped = _refusal_cases()[case]
    with pytest.raises(error):
        vv.view_variance(ref, warped)
