"""Closed-form plane fits (``ptudes_tpu.ops.plane``): the smallest
eigenpair of a symmetric 3x3."""
from __future__ import annotations

import math

import torch


def smallest_eigvec_sym3(a: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpair of symmetric 3x3 matrices (..., 3, 3): (unit
    eigenvector (..., 3), planarity (l_mid - l_min) / l_max in [0, 1])."""
    eps = 1e-12
    axx, ayy, azz = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    axy, axz, ayz = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    m = (axx + ayy + azz) / 3.0
    bxx, byy, bzz = axx - m, ayy - m, azz - m
    q = (bxx * bxx + byy * byy + bzz * bzz
         + 2.0 * (axy * axy + axz * axz + ayz * ayz)) / 6.0
    det = (bxx * (byy * bzz - ayz * ayz) - axy * (axy * bzz - ayz * axz)
           + axz * (axy * ayz - byy * axz)) / 2.0
    sq = torch.sqrt(torch.clamp(q, min=eps))
    r = torch.clamp(det / torch.clamp(sq ** 3, min=eps), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    l1 = m + 2.0 * sq * torch.cos(phi)
    l3 = m + 2.0 * sq * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * m - l1 - l3
    c = a - l3[..., None, None] * torch.eye(3, dtype=a.dtype,
                                             device=a.device)
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    v01 = torch.linalg.cross(r0, r1)
    v02 = torch.linalg.cross(r0, r2)
    v12 = torch.linalg.cross(r1, r2)
    norms = torch.stack([torch.sum(v01 * v01, -1), torch.sum(v02 * v02, -1),
                         torch.sum(v12 * v12, -1)], -1)
    best = torch.argmax(norms, -1)[..., None]
    v = torch.where(best == 0, v01, torch.where(best == 1, v02, v12))
    vn = torch.sqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True), min=eps))
    quality = (l2 - l3) / torch.clamp(l1, min=eps)
    return v / vn, torch.clamp(quality, 0.0, 1.0)


