"""Kernels 1, 2 and 4 at an output column window, on the CPU.

A width shard (parallel/spatial.py) passes the warps the coordinates of
its own columns as [B, D, H, Wo] and gets exactly those columns of the
whole output, from the whole source map or volume. Here the plain
versions (what the ops run on CPU tensors) at windows of the flagship's
layout in small: both halves, a ragged middle, one column, the whole
width in the 4-D form; `torch.equal` to the whole output's columns, in
float32 and bfloat16. The ops' fake implementations give the window's
shape (torch.library.opcheck), and a coordinate shape that names no grid
raises. tests/test_torch_port_cuda.py holds the kernels themselves so on
the card.
"""

from __future__ import annotations

import pytest
import torch

from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.ops.cuda import plane_mix, plane_warp
from estdepth_tpu_torch.ops.cuda import plane_warp_exact_z as exact_z
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, D, H, W, C = 2, 6, 5, 20, 16
WINDOWS = [(0, 8), (8, 20), (3, 14), (19, 20), (0, 20)]
DMIN, DINT = 0.5, 0.25


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
    return src, vol, zi, x, y, z


def _run(kernel, src, vol, zi, coords):
    x, y, z = coords
    if kernel == "plane_sweep":
        return plane_warp.plane_sweep_sample(src, x, y)
    if kernel == "exact_z":
        return exact_z.exact_z_resample(vol, zi, x, y, z, DMIN, DINT)
    return plane_mix.plane_mix_resample(vol, zi, x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["plane_sweep", "exact_z", "plane_mix"])
def test_window_is_the_whole_outputs_columns(kernel, dtype):
    src, vol, zi, x, y, z = _inputs(dtype)
    whole = _run(kernel, src, vol, zi, [q.reshape(B, -1) for q in (x, y, z)])
    assert whole.shape == (B, D, H, W, C) and whole.dtype == dtype
    assert (whole == 0).any() and (whole != 0).any()
    for lo, hi in WINDOWS:
        got = _run(kernel, src, vol, zi,
                   [q[..., lo:hi].contiguous() for q in (x, y, z)])
        assert got.shape == (B, D, H, hi - lo, C)
        assert torch.equal(got, whole[:, :, :, lo:hi]), (lo, hi)


def test_ops_fake_shapes_at_a_window():
    """The ops' fake implementations (what torch.export traces) agree
    with the plain versions at a window."""
    src, vol, zi, x, y, z = _inputs(torch.float32)
    x, y, z = (q[..., 3:14].contiguous() for q in (x, y, z))
    checks = ("test_schema", "test_faketensor")
    torch.library.opcheck(plane_warp.OP, (src, x, y), test_utils=checks)
    torch.library.opcheck(exact_z.OP, (vol, zi, x, y, z, DMIN, DINT),
                          test_utils=checks)
    torch.library.opcheck(plane_mix.OP, (vol, zi, x, y), test_utils=checks)


def test_coordinates_that_name_no_grid_raise():
    src, vol, zi, x, y, z = _inputs(torch.float32)
    wrong_rows = x[:, :, 1:].contiguous()
    for coords in (wrong_rows, x.reshape(B, -1)[:, :-1]):
        with pytest.raises(ValueError, match="coordinates"):
            plane_warp.plane_sweep_sample(src, coords, coords)
        with pytest.raises(ValueError, match="coordinates"):
            plane_mix.plane_mix_resample(vol, zi, coords, coords)
    with pytest.raises(ValueError, match="coordinates"):  # D != the planes
        exact_z.exact_z_resample(vol, zi, x[:, 1:], y[:, 1:], z[:, 1:],
                                 DMIN, DINT)


def test_pixel_grid_columns_are_the_whole_grids():
    whole = geometry.pixel_grid(H, W).reshape(3, H, W)
    for lo, hi in WINDOWS:
        got = geometry.pixel_grid(H, W, columns=(lo, hi))
        assert torch.equal(got, whole[:, :, lo:hi].reshape(3, -1))
    with pytest.raises(ValueError):
        geometry.pixel_grid(H, W, columns=(4, 21))
