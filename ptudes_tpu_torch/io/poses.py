"""Trajectory file formats: KITTI and Newer College GT, with NC frame
transforms.

A copy of ``ptudes_tpu.io.poses`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

Numerically identical to the reference's writers/readers
(``src/ptudes/utils.py:191-252``), including the NC 2021 base<->IMU frame
conversion constants (``src/ptudes/utils.py:22-26``) and the save/restore
round-trip invariant the reference documents (``:207-211``).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

# NC 2021 transforms (newer_college_2021/os_imu_lidar_transforms.yaml),
# reference src/ptudes/utils.py:22-26
NC_OS_IMU_TO_OS_SENSOR = np.eye(4)
NC_OS_IMU_TO_OS_SENSOR[:3, 3] = [-0.014, 0.012, 0.015]
NC_OS_SENSOR_TO_BASE = np.eye(4)
NC_OS_SENSOR_TO_BASE[:3, 3] = [0.001, 0.000, 0.091]
NC_OS_IMU_TO_BASE = NC_OS_SENSOR_TO_BASE @ NC_OS_IMU_TO_OS_SENSOR


def save_poses_kitti_format(
    filename: str, poses: np.ndarray, header: str = ""
) -> None:
    """[N, 4, 4] -> KITTI rows (first 3 pose rows flattened),
    reference ``src/ptudes/utils.py:191-196``."""
    poses = np.asarray(poses)
    rows = poses[:, :3, :].reshape(len(poses), 12)
    np.savetxt(fname=filename, X=rows, header=header)


def load_poses_kitti_format(filename: str) -> np.ndarray:
    rows = np.loadtxt(filename).reshape(-1, 12)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :] = rows.reshape(-1, 3, 4)
    return poses


def save_poses_nc_gt_format(
    filename: str, t: np.ndarray, poses: np.ndarray, header: str = ""
) -> None:
    """Save in NC GT CSV (sec, nsec, x, y, z, qx, qy, qz, qw), converting
    incoming IMU/nav-frame poses to the base frame
    (reference ``src/ptudes/utils.py:199-228``)."""
    t_arr = np.asarray(t, np.float64)
    poses_arr = np.einsum(
        "nij,jk->nik", np.asarray(poses, np.float64),
        np.linalg.inv(NC_OS_IMU_TO_BASE))
    res = np.zeros((len(t_arr), 9))
    res[:, 0] = np.floor(t_arr)
    res[:, 1] = np.floor((t_arr - res[:, 0]) * 1e9)
    res[:, 2:5] = poses_arr[:, :3, 3]
    res[:, 5:9] = Rotation.from_matrix(poses_arr[:, :3, :3]).as_quat()
    data_spec = "sec,nsec,x,y,z,qx,qy,qz,qw"
    if header:
        header += "\n\n" + data_spec
    np.savetxt(fname=filename, X=res, delimiter=", ", header=header)


def read_newer_college_gt(
    data_path: str, to_os_imu: bool = True
) -> list[tuple[float, np.ndarray]]:
    """Read NC GT poses, converted base -> Ouster IMU nav frame
    (reference ``src/ptudes/utils.py:231-252``)."""
    gt = np.loadtxt(data_path, delimiter=",")
    gt = gt.reshape(-1, gt.shape[-1])
    ts = gt[:, 0] + gt[:, 1] * 1e-9
    poses = np.tile(np.eye(4), (len(gt), 1, 1))
    poses[:, :3, 3] = gt[:, 2:5]
    poses[:, :3, :3] = Rotation.from_quat(gt[:, 5:9]).as_matrix()
    if to_os_imu:
        poses = np.einsum("nij,jk->nik", poses, NC_OS_IMU_TO_BASE)
    return [(t, p) for t, p in zip(ts, poses)]


def filter_nc_gt_by_close_ts(nc_gt, gt_t):
    """Nearest-timestamp matching of two non-decreasing streams —
    behavior-parity implementation of the reference's greedy iterator
    walk (``src/ptudes/utils.py:255-302``), including its edge quirks:
    a fetched-but-farther next sample is *discarded* (not promoted to
    current), and the walk ends on stream exhaustion even if a final
    in-tolerance pair is pending. (A round-1 mutual-nearest-neighbor
    formulation differed from the walk at stream edges in ~20% of fuzz
    trials — see tests/test_utils.py differential test — so the exact
    walk is reproduced instead.) ``min_dt`` is the smaller of the two
    streams' minimum sample spacings."""
    if not len(nc_gt):
        return nc_gt, []
    if not len(gt_t):
        return [], []
    nc_t = np.asarray([g[0] for g in nc_gt], np.float64)
    gt_arr = np.asarray(gt_t, np.float64)
    min_nc_t = np.min(np.diff(nc_t)) if len(nc_t) > 1 else np.inf
    min_gt_t = np.min(np.diff(gt_arr)) if len(gt_arr) > 1 else np.inf
    min_dt = min(min_nc_t, min_gt_t)

    out_idx_nc, out_t = [], []
    i, j = 0, 0                    # current elements
    fi, fj = 1, 1                  # iterator fetch positions
    n1, n2 = len(nc_t), len(gt_arr)
    try:
        while True:
            while abs(nc_t[i] - gt_arr[j]) > min_dt:
                while nc_t[i] < gt_arr[j] - min_dt:
                    if fi >= n1:
                        raise StopIteration
                    i, fi = fi, fi + 1
                while gt_arr[j] < nc_t[i] - min_dt:
                    if fj >= n2:
                        raise StopIteration
                    j, fj = fj, fj + 1
            if nc_t[i] < gt_arr[j]:
                if fi >= n1:
                    raise StopIteration
                nxt, fi = fi, fi + 1
                if abs(nc_t[i] - gt_arr[j]) < abs(nc_t[nxt] - gt_arr[j]):
                    out_idx_nc.append(i)
                    out_t.append(gt_t[j])
                    i = nxt
                    if fj >= n2:
                        raise StopIteration
                    j, fj = fj, fj + 1
                # else: fetched sample discarded, current pair retried
            else:
                if fj >= n2:
                    raise StopIteration
                nxt, fj = fj, fj + 1
                if abs(nc_t[i] - gt_arr[j]) < abs(nc_t[i] - gt_arr[nxt]):
                    out_idx_nc.append(i)
                    out_t.append(gt_t[j])
                    j = nxt
                    if fi >= n1:
                        raise StopIteration
                    i, fi = fi, fi + 1
    except StopIteration:
        pass
    return [nc_gt[k] for k in out_idx_nc], out_t


def filter_nc_gt_by_cmp(nc_gt, nc_gt_cmp):
    """Closest subset matching of two pose lists
    (reference ``src/ptudes/utils.py:305-325``)."""
    gt_cmp_t = [g[0] for g in nc_gt_cmp]
    gt_matched, gt_cmp_t_matched = filter_nc_gt_by_close_ts(nc_gt, gt_cmp_t)
    gt_cmp_poses = []
    idx = 0
    for t_m in gt_cmp_t_matched:
        while gt_cmp_t[idx] != t_m:
            idx += 1
        gt_cmp_poses.append(nc_gt_cmp[idx][1])
        idx += 1
    assert len(gt_cmp_poses) == len(gt_cmp_t_matched)
    return gt_matched, list(zip(gt_cmp_t_matched, gt_cmp_poses))
