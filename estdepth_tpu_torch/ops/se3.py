"""SE(3) Lie-group helpers and rotation conversions (port of
estdepth_tpu/ops/se3.py; reference utils/homo_utils.py:322-455).

skew, the exponential and logarithmic maps between se(3) twists and 4x4
rigid transforms in torch (batched), and the two numpy conversions
(rotation matrix -> euler, quaternion -> rotation matrix), copied.

The JAX package pins its pose products to Precision.HIGHEST. Here the
3x3 products are broadcast multiplies and sums (`_matmul`), which stay
float32 whatever the TF32 setting of matmuls.
"""

from __future__ import annotations

import numpy as np
import torch


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, I, J] @ b [B, J, K] (or b [B, J] -> [B, I]) without a GEMM."""
    if b.dim() == 2:
        return (a * b[:, None, :]).sum(-1)
    return (a[:, :, :, None] * b[:, None, :, :]).sum(2)


def skew(phi: torch.Tensor) -> torch.Tensor:
    """[B, 3] -> [B, 3, 3] cross-product matrices (homo_utils.py:322-334)."""
    zeros = torch.zeros_like(phi[:, 0])
    rows = [
        torch.stack([zeros, -phi[:, 2], phi[:, 1]], -1),
        torch.stack([phi[:, 2], zeros, -phi[:, 0]], -1),
        torch.stack([-phi[:, 1], phi[:, 0], zeros], -1),
    ]
    return torch.stack(rows, 1)


def exp_map(ksai: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """se(3) twist [B, 6] (omega, upsilon) -> SE(3) [B, 4, 4]
    (homo_utils.py:337-365), with the JAX package's small-angle guard."""
    b = ksai.shape[0]
    omega, upsilon = ksai[:, :3], ksai[:, 3:]
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    theta = torch.clamp(theta, min=eps)[:, :, None]  # [B, 1, 1]
    om = skew(omega)
    om2 = _matmul(om, om)
    eye = torch.eye(3, dtype=ksai.dtype, device=ksai.device).expand(b, 3, 3)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    rot = eye + sin_t * om / theta + (1 - cos_t) * om2 / theta ** 2
    v = (eye + (1 - cos_t) * om / theta ** 2
         + (theta - sin_t) * om2 / theta ** 3)
    t = _matmul(v, upsilon)
    top = torch.cat([rot, t[:, :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=ksai.dtype,
                          device=ksai.device).expand(b, 1, 4)
    return torch.cat([top, bottom], 1)


def log_map(se3: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SE(3) [B, 4, 4] -> twist [B, 6] (omega, upsilon)
    (homo_utils.py:368-400)."""
    b = se3.shape[0]
    r, t = se3[:, :3, :3], se3[:, :3, 3]
    d = 0.5 * (r[:, 0, 0] + r[:, 1, 1] + r[:, 2, 2] - 1.0)
    d = torch.clamp(d, -1.0 + eps, 1.0 - eps)[:, None]
    dr = torch.stack([r[:, 2, 1] - r[:, 1, 2], r[:, 0, 2] - r[:, 2, 0],
                      r[:, 1, 0] - r[:, 0, 1]], -1)
    theta = torch.arccos(d)
    omega = theta * dr / (2.0 * torch.sqrt(1.0 - d * d))
    om = skew(omega)
    om2 = _matmul(om, om)
    eye = torch.eye(3, dtype=se3.dtype, device=se3.device).expand(b, 3, 3)
    th = torch.clamp(theta, min=eps)[:, :, None]
    v_inv = (eye - 0.5 * om
             + (1.0 - th / (2.0 * torch.tan(th / 2.0))) * om2 / th ** 2)
    return torch.cat([omega, _matmul(v_inv, t)], -1)


def mat2euler_np(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix -> euler XYZ, numpy (homo_utils.py:403-426)."""
    r11, r12, r13 = rot[0][0], rot[0][1], rot[0][2]
    r23, r33 = rot[1][2], rot[2][2]
    rx = np.arctan2(-r23, r33)
    ry = np.arctan2(r13, np.sqrt(r11 * r11 + r12 * r12))
    rz = np.arctan2(-r12, r11)
    return np.stack([rx, ry, rz])


def quat2mat_np(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation, numpy
    (homo_utils.py:429-455)."""
    w, x, y, z = q
    nq = w * w + x * x + y * y + z * z
    if nq < 1e-8:
        return np.eye(3)
    s = 2.0 / nq
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])
