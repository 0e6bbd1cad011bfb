"""Camera geometry in fp32 (port of estdepth_tpu/ops/geometry.py).

Conventions:
  * camera poses are cam-to-world [.., 4, 4]
  * intrinsics K are [.., 3, 3]
  * pixel coordinate (x, y) has x along width, y along height, origin at
    the corner pixel center (align_corners=True).

The JAX code pins these products to Precision.HIGHEST; here they are
plain fp32 matmuls, which stay fp32 as long as TF32 is off for matmuls
(config.set_fp32_numerics).

Host waits (utils/trace.py): `host_wait.inverse` around every
`torch.linalg.inv` of the port (`inverse`: on CUDA it checks each
matrix's factorization on the host), `host_wait.constant` around the
copy of `scale_intrinsics`' row scale, made on the host.
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.utils import trace


def pixel_grid(height: int, width: int, device=None,
               dtype=torch.float32,
               columns: tuple[int, int] | None = None) -> torch.Tensor:
    """Homogeneous pixel grid [3, H*W] with rows (x, y, 1), row-major over
    (y, x) (homo_utils.py:7-14). `columns` (start, stop) keeps the pixels
    of those columns of the `width`: [3, H*(stop-start)] with their
    global x (a width shard's, parallel/spatial.py)."""
    start, stop = (0, width) if columns is None else columns
    if not 0 <= start < stop <= width:
        raise ValueError(f"columns {columns} of a width of {width}")
    y = torch.arange(height, dtype=dtype, device=device)
    x = torch.arange(start, stop, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack(
        [xx.reshape(-1), yy.reshape(-1), torch.ones_like(xx).reshape(-1)], 0
    )


def scale_intrinsics(cam_intr: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale the first two rows of K (model_hybrid.py:104-108)."""
    with trace.host_wait("constant"):
        row_scale = torch.tensor([scale, scale, 1.0], dtype=cam_intr.dtype,
                                 device=cam_intr.device)
    return cam_intr * row_scale[:, None]


def inverse(mat: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.inv(mat)` of [..., n, n], inside
    `host_wait("inverse")`."""
    with trace.host_wait("inverse"):
        return torch.linalg.inv(mat)


def camera_projection(cam_intr: torch.Tensor,
                      cam_pose: torch.Tensor) -> torch.Tensor:
    """World->pixel projection [B, 4, 4]: rows [K @ E[:3, :4]; 0 0 0 1]
    with E = inverse(pose) (model_hybrid.py:85-88)."""
    extr = inverse(cam_pose)
    top = torch.matmul(cam_intr, extr[:, :3, :4])
    return torch.cat([top, extr[:, 3:4, :4]], dim=1)


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor):
    """rot [B, 3, 3] and trans [B, 3] of src_proj @ inv(ref_proj)
    (homo_utils.py:469-471)."""
    proj = torch.matmul(src_proj, inverse(ref_proj))
    return proj[:, :3, :3], proj[:, :3, 3]


def backproject(cam_intr: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Unit-depth camera rays K^-1 @ grid: [B, 3, N] (homo_utils.py:40-62)."""
    return torch.matmul(inverse(cam_intr), grid)


def transform_points(mat4: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [B, 4, 4] rigid transform to [B, 3, ...] points
    (homo_utils.py:26-37)."""
    b = pts.shape[0]
    flat = pts.reshape(b, 3, -1)
    out = torch.matmul(mat4[:, :3, :3], flat) + mat4[:, :3, 3:4]
    return out.reshape(pts.shape)


def project_points(cam_intr: torch.Tensor, pts: torch.Tensor,
                   eps: float = 1e-10):
    """Project [B, 3, N] camera points to pixels; returns (x, y, z) each
    [B, N] (homo_utils.py:107-134, including its 1e-10 epsilon)."""
    uvw = torch.matmul(cam_intr, pts)
    z = uvw[:, 2].contiguous()
    return uvw[:, 0] / (z + eps), uvw[:, 1] / (z + eps), z
