"""Kernel 3: the fused two-pass resample, csrc/two_pass_resample.cu.

Replaces estdepth_tpu/ops/pallas/plane_warp.py:_two_pass, the fused branch
(ESTDEPTH_FUSED_WARP=1, _make_fused_pass_kernel). The function is the TPU
package's row-crossing approximation of a bilinear sample under a
homography: column w of a target plane maps to the source line
x = a_w * y + b_w, so pass 1 resamples every source ROW h horizontally at
x = a_w * h + b_w and pass 2 blends rows y0 and y0 + 1 of that image at the
exact y. It equals the exact bilinear sample where the line is vertical
(pure translations) and deviates by a sub-pixel amount under rotation.

`two_pass_resample` calls the op `estdepth::two_pass_resample`
(ops/cuda/library.py). On a CUDA tensor it launches the kernel, which
keeps no pass-1 image: pass 2 at (i, w) reads column w of it at rows y0
and y0 + 1 only, so the kernel computes those two values from four gathers of
the source map and blends them, the same operations in the same order (bit
for bit the two passes). On a CPU tensor it runs
`two_pass_resample_plain`, the two passes written with `torch.gather`.
`src` is float32 or bfloat16 (the kernel's two instances; C % 4 == 0 or
C % 8 == 0), the line coefficients and coordinates float32, the result in
src's dtype. The coefficients and coordinates name the output grid: ab
[P, 2, W] and x, y [P, H*W] the source's own W columns, ab [P, 2, Wo]
and x, y [P, H*Wo] a window of Wo columns (a width shard's own,
parallel/spatial.py), whose coefficients are those of the columns' global
indices (`line_coeffs(..., columns=)`): the result is exactly those
columns of the whole output, from the whole source map. A bfloat16 map
is resampled in float32 and rounded once, where the TPU kernel also
rounds its pass-1 image to bfloat16. The line coefficients are computed
in PyTorch by the caller (`line_coeffs`), as the JAX package computes
them outside its `pallas_call`.

Gradient, as the JAX package's `custom_vjp` (_psweep_bwd): the kernel is
forward-only; the backward is autograd of the EXACT bilinear sample
(ops/cuda/plane_warp.plane_sweep_sample_plain) at the same (x, y) with
respect to `src`, on either device. `ab`, `x` and `y` get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from estdepth_tpu_torch.ops.cuda import build, library
from estdepth_tpu_torch.ops.cuda.plane_warp import plane_sweep_sample_plain
from estdepth_tpu_torch.ops.sampling import corner, upcast_half

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("two_pass_resample", "two_pass_resample",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def line_coeffs(hmat: torch.Tensor, width: int,
                columns: tuple[int, int] | None = None) -> torch.Tensor:
    """Source-line coefficients of every target column from homographies.

    hmat [P, 3, 3] maps a target pixel (u, v, 1) to source (x', y', z').
    For a fixed u the target column's image is the source line
    x = a_u y + b_u; with c = H[:, 0] u + H[:, 2] and d = H[:, 1]:
      a = (d0 c2 - d2 c0) / den,  b = (c0 d1 - c1 d0) / den,
      den = d1 c2 - d2 c1
    (a near-zero den is a near-horizontal source line, which this
    decomposition cannot express). Returns [P, 2, W] stacked (a, b); with
    `columns` (start, stop) those of the columns u = start .. stop-1 only,
    [P, 2, stop - start], bit for bit the whole call's columns (u is the
    whole width's, sliced, and every operation is elementwise)."""
    hmat = hmat.float()
    u = torch.arange(width, dtype=torch.float32, device=hmat.device)
    if columns is not None:
        start, stop = columns
        if not 0 <= start < stop <= width:
            raise ValueError(f"line_coeffs: columns {columns} of a width "
                             f"of {width}")
        u = u[start:stop]
    c = hmat[:, :, 0:1] * u[None, None, :] + hmat[:, :, 2:3]  # [P, 3, W]
    d = hmat[:, :, 1:2]  # [P, 3, 1]
    den = d[:, 1] * c[:, 2] - d[:, 2] * c[:, 1]  # [P, W]
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    a = (d[:, 0] * c[:, 2] - d[:, 2] * c[:, 0]) / den
    b = (c[:, 0] * d[:, 1] - c[:, 1] * d[:, 0]) / den
    return torch.stack([a, b], 1)


def _mix(g0: torch.Tensor, g1: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return g0 * (1.0 - f) + g1 * f


def two_pass_resample_plain(src: torch.Tensor, ab: torch.Tensor,
                            x: torch.Tensor, y: torch.Tensor,
                            planes_per_map: int) -> torch.Tensor:
    """src [M, H, W, C], ab [P, 2, Wo], exact source x, y [P, H*Wo] with
    P = M * planes_per_map -> [P, H, Wo, C] in src's dtype (Wo = W: the
    whole output; else a window, module doc). Plain version of kernel 3:
    pass 1 resamples every source row at the Wo output columns' lines; a
    bfloat16 src is resampled in float32 and rounded once."""
    m, h, w, c = src.shape
    dtype, src = src.dtype, upcast_half(src)
    p, _, wo = ab.shape
    dev = src.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(wo, device=dev)
    # pass 1: every source row resampled along its column's source line
    xq = ab[:, 0, None, :].float() * rows + ab[:, 1, None, :].float()
    x0, f = corner(xq, w)  # [P, H, Wo]
    idx = (rows.long() * w + x0).reshape(m, planes_per_map * h * wo, 1)
    flat = src.reshape(m, h * w, c)
    g0 = torch.gather(flat, 1, idx.expand(-1, -1, c))
    g1 = torch.gather(flat, 1, (idx + 1).expand(-1, -1, c))
    j = _mix(g0, g1, f.reshape(m, -1, 1).to(src.dtype)).reshape(p, h * wo, c)
    # pass 2: rows y0 and y0 + 1 of that image, masked at the exact (x, y)
    x = x.float().reshape(p, h, wo)
    y = y.float().reshape(p, h, wo)
    valid = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    y0, f2 = corner(y, h)
    idx = (y0 * wo + cols).reshape(p, h * wo, 1)
    h0 = torch.gather(j, 1, idx.expand(-1, -1, c))
    h1 = torch.gather(j, 1, (idx + wo).expand(-1, -1, c))
    out = _mix(h0, h1, f2.reshape(p, h * wo, 1).to(src.dtype))
    out = torch.where(valid.reshape(p, h * wo, 1), out, torch.zeros_like(out))
    return out.reshape(p, h, wo, c).to(dtype)


def _launch(src: torch.Tensor, ab: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor, planes_per_map: int) -> torch.Tensor:
    m, h, w, c = src.shape
    p, wo = m * planes_per_map, ab.shape[-1]
    dev = src.device
    build.require(src, "src", (m, h, w, c), dev, allow_grad=True)
    build.require_channels("two_pass_resample: src", src.shape, src.dtype)
    build.require(ab, "ab", (p, 2, wo), dev, dtype=torch.float32)
    build.require(x, "x", (p, h * wo), dev, dtype=torch.float32)
    build.require(y, "y", (p, h * wo), dev, dtype=torch.float32)
    out = torch.empty((p, h, wo, c), dtype=src.dtype, device=dev)
    with torch.cuda.device(dev):  # the C entry launches there
        KERNEL(src.dtype, src.data_ptr(), ab.data_ptr(), x.data_ptr(),
               y.data_ptr(), out.data_ptr(), p, h, w, wo, c, planes_per_map,
               torch.cuda.current_stream().cuda_stream)
    return out


def _fake(src, ab, x, y, planes_per_map):
    m, h, w, c = src.shape
    return src.new_empty((m * planes_per_map, h, ab.shape[-1], c))


OP = library.define("two_pass_resample", two_pass_resample_plain, _launch,
                    _fake)


def two_pass_resample(src: torch.Tensor, ab: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor, planes_per_map: int) -> torch.Tensor:
    """src [M, H, W, C], ab [P, 2, Wo], exact source x, y [P, H*Wo] with
    P = M * planes_per_map -> [P, H, Wo, C] (Wo = W, or a window of output
    columns: module doc): the kernel on CUDA tensors, the plain version on
    CPU tensors; the gradient for `src` is the exact bilinear sample's on
    both (module doc)."""
    library.check_device("two_pass_resample", src)
    m, h, w, c = src.shape
    p = m * planes_per_map
    if (planes_per_map < 1 or ab.dim() != 3 or ab.shape[:2] != (p, 2)
            or min(h, w) < 2):
        raise ValueError(f"two_pass_resample: src {tuple(src.shape)} "
                         f"(H, W >= 2) with ab {tuple(ab.shape)} and "
                         f"planes_per_map {planes_per_map}")
    wo = ab.shape[2]
    if x.shape != (p, h * wo) or y.shape != x.shape:
        raise ValueError(f"two_pass_resample: coordinates {tuple(x.shape)}"
                         f", {tuple(y.shape)} for ab {tuple(ab.shape)}: "
                         f"[P, H*Wo] = {(p, h * wo)}")

    def exact(s, xs, ys):  # the same voxels by kernel 1's plain version
        out = plane_sweep_sample_plain(s, xs.reshape(m, -1, h, wo),
                                       ys.reshape(m, -1, h, wo))
        return out.reshape(-1, h, wo, c)

    return build.sample_with_plain_grad(
        lambda s, a, xs, ys: OP(s, a, xs, ys, planes_per_map),
        lambda s, a, xs, ys: exact(s, xs, ys),
        "two_pass_resample", src, ab, x, y)
