"""Kernels 1, 2, 3 and 4 at an output column window, on the CPU.

A width shard (parallel/spatial.py) passes the warps the coordinates of
its own columns as [B, D, H, Wo] (kernel 3: [P, H*Wo] with the line
coefficients [P, 2, Wo] of those columns) and gets exactly those columns
of the whole output, from the whole source map or volume. Here the plain
versions (what the ops run on CPU tensors) at windows of the flagship's
layout in small: both halves, a ragged middle, one column, the whole
width in the 4-D form; `torch.equal` to the whole output's columns, in
float32 and bfloat16. The line coefficients of a window's columns are
bit for bit the whole call's. The ops' fake implementations give the
window's shape (torch.library.opcheck), and a coordinate shape that
names no grid raises. tests/test_torch_port_cuda.py holds the kernels
themselves so on the card.
"""

from __future__ import annotations

import pytest
import torch

from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import plane_mix, plane_warp, two_pass
from estdepth_tpu_torch.ops.cuda import plane_warp_exact_z as exact_z
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, D, H, W, C = 2, 6, 5, 20, 16
WINDOWS = [(0, 8), (8, 20), (3, 14), (19, 20), (0, 20)]
DMIN, DINT = 0.5, 0.25


def _homographies(g):
    """Near-identity plane homographies [B*D, 3, 3] with shifts, shear and
    perspective, so the source lines cross rows."""
    scale = torch.tensor([[0.08, 0.08, 3.0], [0.08, 0.08, 2.0],
                          [1e-3, 1e-3, 0.02]])
    return torch.eye(3) + torch.randn(B * D, 3, 3, generator=g) * scale


def _inputs(dtype):
    g = torch.Generator().manual_seed(0)
    # coordinates reach past the image by a column or row on every side
    x = torch.rand(B, D, H, W, generator=g) * (W + 1) - 1
    y = torch.rand(B, D, H, W, generator=g) * (H + 1) - 1
    z = torch.rand(B, D, H, W, generator=g) * (D + 1) * DINT + DMIN - DINT
    zi = torch.rand(B, D, H * W, generator=g) * (D + 1) - 1
    zi[:, :, ::7] = -2.0  # the sentinel behind the camera
    src = torch.randn(B, H, W, C, generator=g).to(dtype)
    vol = torch.randn(B, D, H, W, C, generator=g).to(dtype)
    ab = two_pass.line_coeffs(_homographies(g), W)
    return src, vol, zi, ab, x, y, z


def _run(kernel, inputs, window=None):
    """The kernel's plain version on the whole output grid, or on the
    output columns `window` (lo, hi) -> [B, D, H, Wo, C]."""
    src, vol, zi, ab, *coords = inputs
    if window is None:
        x, y, z = (q.reshape(B, -1) for q in coords)
    else:
        lo, hi = window
        x, y, z = (q[..., lo:hi].contiguous() for q in coords)
        ab = ab[..., lo:hi].contiguous()
    if kernel == "plane_sweep":
        return plane_warp.plane_sweep_sample(src, x, y)
    if kernel == "two_pass":
        out = two_pass.two_pass_resample(src, ab, x.reshape(B * D, -1),
                                         y.reshape(B * D, -1), D)
        return out.reshape(B, D, H, -1, C)
    if kernel == "exact_z":
        return exact_z.exact_z_resample(vol, zi, x, y, z, DMIN, DINT)
    return plane_mix.plane_mix_resample(vol, zi, x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["plane_sweep", "exact_z", "two_pass",
                                    "plane_mix"])
def test_window_is_the_whole_outputs_columns(kernel, dtype):
    inputs = _inputs(dtype)
    whole = _run(kernel, inputs)
    assert whole.shape == (B, D, H, W, C) and whole.dtype == dtype
    assert (whole == 0).any() and (whole != 0).any()
    for lo, hi in WINDOWS:
        got = _run(kernel, inputs, (lo, hi))
        assert got.shape == (B, D, H, hi - lo, C)
        assert torch.equal(got, whole[:, :, :, lo:hi]), (lo, hi)


def test_line_coeffs_of_columns_are_the_whole_calls():
    """Kernel 3's line coefficients at a window's global columns, from
    homographies and from a plane sweep's rotation and translation, bit
    for bit the whole width's columns."""
    g = torch.Generator().manual_seed(2)
    hm = _homographies(g)
    rot, trans = hm[:B], hm[:B, :, 2]
    dv = torch.linspace(DMIN, 4.0, D).expand(B, D)
    whole = two_pass.line_coeffs(hm, W)
    sweep = warp.plane_sweep_line_coeffs(rot, trans, dv, W)
    for lo, hi in WINDOWS:
        assert torch.equal(two_pass.line_coeffs(hm, W, (lo, hi)),
                           whole[..., lo:hi]), (lo, hi)
        assert torch.equal(warp.plane_sweep_line_coeffs(
            rot, trans, dv, W, (lo, hi)), sweep[..., lo:hi]), (lo, hi)
    for columns in ((4, 21), (5, 5), (-1, 3)):
        with pytest.raises(ValueError, match="columns"):
            two_pass.line_coeffs(hm, W, columns)


def test_ops_fake_shapes_at_a_window():
    """The ops' fake implementations (what torch.export traces) agree
    with the plain versions at a window."""
    src, vol, zi, ab, x, y, z = _inputs(torch.float32)
    x, y, z = (q[..., 3:14].contiguous() for q in (x, y, z))
    checks = ("test_schema", "test_faketensor")
    torch.library.opcheck(plane_warp.OP, (src, x, y), test_utils=checks)
    torch.library.opcheck(two_pass.OP, (
        src, ab[..., 3:14].contiguous(), x.reshape(B * D, -1),
        y.reshape(B * D, -1), D), test_utils=checks)
    torch.library.opcheck(exact_z.OP, (vol, zi, x, y, z, DMIN, DINT),
                          test_utils=checks)
    torch.library.opcheck(plane_mix.OP, (vol, zi, x, y), test_utils=checks)


def test_coordinates_that_name_no_grid_raise():
    src, vol, zi, ab, x, y, z = _inputs(torch.float32)
    wrong_rows = x[:, :, 1:].contiguous()
    for coords in (wrong_rows, x.reshape(B, -1)[:, :-1]):
        with pytest.raises(ValueError, match="coordinates"):
            plane_warp.plane_sweep_sample(src, coords, coords)
        with pytest.raises(ValueError, match="coordinates"):
            plane_mix.plane_mix_resample(vol, zi, coords, coords)
    with pytest.raises(ValueError, match="coordinates"):  # D != the planes
        exact_z.exact_z_resample(vol, zi, x[:, 1:], y[:, 1:], z[:, 1:],
                                 DMIN, DINT)
    # kernel 3: coordinates of other columns than the coefficients'
    xs = x[..., 3:14].reshape(B * D, -1)
    for window in (ab, ab[..., 3:13]):
        with pytest.raises(ValueError, match="coordinates"):
            two_pass.two_pass_resample(src, window.contiguous(), xs, xs, D)


def test_pixel_grid_columns_are_the_whole_grids():
    whole = geometry.pixel_grid(H, W).reshape(3, H, W)
    for lo, hi in WINDOWS:
        got = geometry.pixel_grid(H, W, columns=(lo, hi))
        assert torch.equal(got, whole[:, :, lo:hi].reshape(3, -1))
    with pytest.raises(ValueError):
        geometry.pixel_grid(H, W, columns=(4, 21))
