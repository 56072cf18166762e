"""Motion compensation by a twist (``ptudes_tpu.ops.deskew``): every
point moves by exp(s_i * twist), expanded in closed form per point; the
KISS constant-velocity deskew takes its twist from the last two poses."""
from __future__ import annotations

import torch

from ..geom import se3

_EPS = 1e-8


def deskew_by_twist(pts: torch.Tensor, scales: torch.Tensor,
                    twist: torch.Tensor) -> torch.Tensor:
    """Apply exp(scale_i * twist) to each point; pts [N, 3], scales [N],
    twist [6] = [rot, trans]; with a leading replica axis pts [B, N, 3],
    scales [B, N] and twist [B, 6]."""
    w, v = twist[..., :3], twist[..., 3:]
    theta2 = torch.sum(w * w, -1, keepdim=True)
    theta = torch.sqrt(theta2)
    small = theta < _EPS
    one = torch.ones_like(theta)
    safe_t = torch.where(small, one, theta)
    safe_t2 = torch.where(small, one, theta2)
    st = scales * theta
    sin_st, cos_st = torch.sin(st), torch.cos(st)
    # R(s) = I + A K + B K^2 with K = hat(w)
    a = torch.where(small, scales, sin_st / safe_t)
    b = torch.where(small, 0.5 * scales * scales, (1.0 - cos_st) / safe_t2)
    wb = w[..., None, :].expand_as(pts)
    wxp = torch.linalg.cross(wb, pts)
    wwxp = torch.linalg.cross(wb, wxp)
    rotated = pts + a[..., None] * wxp + b[..., None] * wwxp
    # t(s) = s v + (1 - cos st)/theta^2 K v + (st - sin st)/theta^3 K^2 v
    s2 = scales * scales
    bb = torch.where(small, 0.5 * s2, (1.0 - cos_st) / safe_t2)
    cc = torch.where(small, s2 * scales / 6.0,
                     (st - sin_st) / (safe_t2 * safe_t))
    wxv = torch.linalg.cross(w, v)
    wwxv = torch.linalg.cross(w, wxv)
    t = scales[..., None] * v[..., None, :] + bb[..., None] \
        * wxv[..., None, :] + cc[..., None] * wwxv[..., None, :]
    return rotated + t


def deskew_scan(pts: torch.Tensor, col_ts01: torch.Tensor,
                pose_prev2: torch.Tensor, pose_prev1: torch.Tensor,
                enabled: torch.Tensor) -> torch.Tensor:
    """KISS constant-velocity deskew: the twist log(T_{k-2}^-1 T_{k-1}),
    about the mid-scan anchor; ``enabled`` (a device bool, false before two
    poses exist) zeroes it by ``torch.where``, without a host branch. With
    a leading replica axis: pts [B, N, 3], ``col_ts01`` [B, N], poses
    [B, 4, 4] and ``enabled`` [B]."""
    twist = se3.log_pose(se3.inv(pose_prev2) @ pose_prev1)
    twist = torch.where(enabled[..., None], twist, torch.zeros_like(twist))
    return deskew_by_twist(pts, col_ts01 - 0.5, twist)
