"""Trajectory utilities: interpolating evaluator, pruning, per-scan poses.

A copy of ``ptudes_tpu.utils.trajectory`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

Replaces ``ouster.sdk.pose_util.TrajectoryEvaluator`` and the reference's
``prune_trajectory`` (``src/ptudes/utils.py:122-154``) / per-scan GT pose
attachment (``src/ptudes/utils.py:344-392``).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


class TrajectoryEvaluator:
    """Geodesic pose interpolation over (ts, pose) knots.

    ``pose_at(t)`` errors outside the knot span beyond ``time_bounds``
    fractions of the end segment lengths — same contract the reference
    relies on to skip out-of-range scans (``src/ptudes/utils.py:368-386``).
    """

    def __init__(self, poses: list[tuple[float, np.ndarray]],
                 time_bounds: float = 0.0):
        assert len(poses) >= 2, "need at least two pose knots"
        self._ts = np.asarray([t for t, _ in poses], np.float64)
        assert (np.diff(self._ts) > 0).all(), "timestamps must increase"
        self._poses = np.asarray([p for _, p in poses], np.float64)
        self._bounds = time_bounds
        self._rots = Rotation.from_matrix(self._poses[:, :3, :3])

    @property
    def t_min(self) -> float:
        return float(self._ts[0] - self._bounds * (self._ts[1] - self._ts[0]))

    @property
    def t_max(self) -> float:
        return float(self._ts[-1] + self._bounds * (self._ts[-1] - self._ts[-2]))

    def pose_at(self, t) -> np.ndarray:
        """Interpolated pose(s) at time(s) t (scalar or [K])."""
        t_arr = np.atleast_1d(np.asarray(t, np.float64))
        if (t_arr < self.t_min).any() or (t_arr > self.t_max).any():
            raise ValueError(
                f"query time outside trajectory span "
                f"[{self.t_min}, {self.t_max}]")
        i1 = np.clip(np.searchsorted(self._ts, t_arr), 1, len(self._ts) - 1)
        i0 = i1 - 1
        a = (t_arr - self._ts[i0]) / (self._ts[i1] - self._ts[i0])

        r0 = self._rots[i0]
        r1 = self._rots[i1]
        dr = (r0.inv() * r1).as_rotvec()
        rots = (r0 * Rotation.from_rotvec(a[:, None] * dr)).as_matrix()
        pos = ((1 - a[:, None]) * self._poses[i0, :3, 3]
               + a[:, None] * self._poses[i1, :3, 3])
        out = np.tile(np.eye(4), (len(t_arr), 1, 1))
        out[:, :3, :3] = rots
        out[:, :3, 3] = pos
        return out[0] if np.isscalar(t) or np.ndim(t) == 0 else out


def log_pose_np(p: np.ndarray) -> np.ndarray:
    """[rot(3), trans(3)] twist — layout matching ouster pose_util
    (rotation first, see geom.se3 docstring)."""
    w = Rotation.from_matrix(p[:3, :3]).as_rotvec()
    return np.concatenate([w, p[:3, 3]])


def prune_trajectory(
    traj_poses: list[tuple[float, np.ndarray]],
    min_dist_m: float = 5.0,
    min_dist_angle: float = 5.0,
    start_idx: int | None = None,
    end_idx: int | None = None,
) -> list[tuple[float, np.ndarray]]:
    """Drop knots closer than min distance/angle to the previous kept one
    (reference ``prune_trajectory``, ``src/ptudes/utils.py:122-154``)."""
    start_idx = 0 if start_idx is None else start_idx
    end_idx = len(traj_poses) - 1 if end_idx is None else end_idx
    assert start_idx <= end_idx < len(traj_poses)

    pruned = [traj_poses[start_idx]]
    last_inv = np.linalg.inv(pruned[0][1])
    idx = start_idx + 1
    for tp in traj_poses[idx:end_idx + 1]:
        p = tp[1]
        pd = log_pose_np(last_inv @ p)
        pda = np.linalg.norm(pd[:3])
        pdm = np.linalg.norm(pd[3:])
        if (pda > np.deg2rad(min_dist_angle) or pdm > min_dist_m
                or idx == end_idx):
            pruned.append(tp)
            last_inv = np.linalg.inv(p)
        idx += 1
    if len(pruned) < 2 and end_idx + 1 < len(traj_poses):
        pruned.append(traj_poses[end_idx + 1])
    return pruned


def poses_for_scans(
    scan_ts: np.ndarray,
    gt_poses: list[tuple[float, np.ndarray]],
    time_bounds: float = 1.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Attach a GT pose to each scan timestamp; out-of-span scans are
    masked out instead of raising (reference skip-with-warning behavior,
    ``src/ptudes/utils.py:372-392``).

    Returns (poses [N, 4, 4], valid [N])."""
    ev = TrajectoryEvaluator(gt_poses, time_bounds=time_bounds)
    valid = (scan_ts >= ev.t_min) & (scan_ts <= ev.t_max)
    out = np.tile(np.eye(4), (len(scan_ts), 1, 1))
    if valid.any():
        out[valid] = ev.pose_at(scan_ts[valid])
    return out, valid
