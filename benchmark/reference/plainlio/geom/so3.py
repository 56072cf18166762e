"""SO(3) primitives in PyTorch (``ptudes_tpu.geom.so3``).

Same conventions and the same small-angle switches (``_EPS = 1e-8``):
rotation vectors are axis*angle in radians, quaternions are ``[x, y, z, w]``
(scalar last), matrices act on column vectors. Every function takes leading
batch dimensions and builds its constants on the input's device.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], dim=-2)


def exp_rotvec(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(v * v, -1)
    theta = torch.sqrt(theta2)
    small = theta < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.sqrt(safe_t2))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    k = hat(v)
    kk = k @ k
    return _eye3(v) + a[..., None, None] * k + b[..., None, None] * kk


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw: rot(q1*q2) == rot(q1) @ rot(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    return torch.stack([
        torch.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], -1),
    ], dim=-2)


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (xyzw), Shepperd's method as selects."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1)
    qx = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20,
                      m21 - m12], -1)
    qy = torch.stack([m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21,
                      m02 - m20], -1)
    qz = torch.stack([m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11,
                      m10 - m01], -1)
    cands = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                         m22 - m00 - m11], -1)
    best = torch.argmax(cands, dim=-1)[..., None]
    q = torch.where(best == 0, qw,
                    torch.where(best == 1, qx,
                                torch.where(best == 2, qy, qz)))
    return normalize_quat(q)


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    q = normalize_quat(q)
    qv, w = q[..., :3], q[..., 3]
    n = torch.linalg.vector_norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    small = n < _EPS
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                        angle / torch.where(small, torch.ones_like(n), n))
    return qv * scale[..., None]


def log_rotmat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector via the quaternion path."""
    return quat_to_rotvec(mat_to_quat(r))


def rotvec_to_quat(v: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    small = theta < _EPS
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(theta),
                                                  theta))
    return normalize_quat(torch.cat([v * k, torch.cos(half)], -1))


def quat_from_euler_xyz(rpy: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ Euler angles -> quaternion."""
    z = torch.zeros_like(rpy[..., 0])
    rx = rotvec_to_quat(torch.stack([rpy[..., 0], z, z], -1))
    ry = rotvec_to_quat(torch.stack([z, rpy[..., 1], z], -1))
    rz = rotvec_to_quat(torch.stack([z, z, rpy[..., 2]], -1))
    return quat_mul(rx, quat_mul(ry, rz))

