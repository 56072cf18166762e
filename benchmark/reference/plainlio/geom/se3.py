"""SE(3) primitives in PyTorch (``ptudes_tpu.geom.se3``).

Poses are 4x4 homogeneous matrices (..., 4, 4); twists are 6-vectors
``[rot(3), trans(3)]``, rotation first.
"""
from __future__ import annotations

import torch

from . import so3

_EPS = 1e-8


def make_pose(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) pose."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], -1)
    bottom = torch.cat([
        torch.zeros(batch + (1, 3), dtype=r.dtype, device=r.device),
        torch.ones(batch + (1, 1), dtype=r.dtype, device=r.device)], -1)
    return torch.cat([top, bottom], -2)


def rot(p: torch.Tensor) -> torch.Tensor:
    return p[..., :3, :3]


def trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., :3, 3]


def inv(p: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid pose (exact, no linear solve)."""
    rt = rot(p).transpose(-1, -2)
    return make_pose(rt, -(rt @ trans(p)[..., None])[..., 0])


def transform(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a pose to points: (4, 4) x (N, 3) -> (N, 3)."""
    return pts @ rot(p).transpose(-1, -2) + trans(p)[..., None, :]


def exp_twist(tw: torch.Tensor) -> torch.Tensor:
    """se(3) exp: twist (..., 6) [rot, trans] -> pose (..., 4, 4)."""
    w, v = tw[..., :3], tw[..., 3:]
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2)
    small = theta < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    r = so3.exp_rotvec(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (safe_t2 * torch.sqrt(safe_t2)))
    k = so3.hat(w)
    kk = k @ k
    vmat = so3._eye3(tw) + b[..., None, None] * k + c[..., None, None] * kk
    return make_pose(r, (vmat @ v[..., None])[..., 0])


def log_pose(p: torch.Tensor) -> torch.Tensor:
    """SE(3) log: pose (..., 4, 4) -> twist (..., 6) [rot, trans]."""
    w = so3.log_rotmat(rot(p))
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2)
    small = theta < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    k = so3.hat(w)
    kk = k @ k
    half_t = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t)
         / torch.clamp(torch.sin(half_t), min=_EPS)) / safe_t2)
    vinv = so3._eye3(p) - 0.5 * k + cot_term[..., None, None] * kk
    return torch.cat([w, (vinv @ trans(p)[..., None])[..., 0]], -1)
