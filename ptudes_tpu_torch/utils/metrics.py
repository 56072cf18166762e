"""Trajectory metrics (copy of ``ptudes_tpu.utils.metrics``; numpy +
scipy): the reference's ATE (mean squared errors, no square root, the
rotation scaled by 180/pi after squaring) and the conventional RMSE."""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def align_first_pose(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Transform gt so its first pose coincides with est's first pose."""
    pose0 = est[0] @ np.linalg.inv(gt[0])
    return np.einsum("ij,njk->nik", pose0, gt)


def _pose_errors(est: np.ndarray, gt: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    assert len(est) == len(gt) and len(est)
    est = np.asarray(est, np.float64)
    gt = align_first_pose(est, np.asarray(gt, np.float64))
    trans_d = np.linalg.norm(gt[:, :3, 3] - est[:, :3, 3], axis=-1)
    rel = np.einsum("nij,nik->njk", est[:, :3, :3], gt[:, :3, :3])
    rot_d = np.linalg.norm(Rotation.from_matrix(rel).as_rotvec(), axis=-1)
    return rot_d, trans_d


def calc_ate(est_poses, gt_poses) -> tuple[float, float]:
    """Reference-compatible ATE: (rot 'deg' = mean-squared-rad * 180/pi,
    trans = mean-squared meters)."""
    rot_d, trans_d = _pose_errors(np.asarray(est_poses),
                                  np.asarray(gt_poses))
    return (float(np.mean(np.square(rot_d)) * 180.0 / np.pi),
            float(np.mean(np.square(trans_d))))


def calc_ate_rmse(est_poses, gt_poses) -> tuple[float, float]:
    """Conventional ATE RMSE after first-pose alignment: (rot deg,
    trans m)."""
    rot_d, trans_d = _pose_errors(np.asarray(est_poses),
                                  np.asarray(gt_poses))
    return (float(np.degrees(np.sqrt(np.mean(np.square(rot_d))))),
            float(np.sqrt(np.mean(np.square(trans_d)))))
