"""An error-state EKF in float64 numpy, written from the filter's
equations and independent of the program and of ``plainlio``: the IMU
mechanisation and the 18-dimensional error state [dpos, dvel, datt,
dbias_gyr, dbias_acc, dgrav] (block offsets 0, 3, 6, 9, 12, 15), the
6-DoF pose update in Joseph form, and the batcher's windowing of the IMU
samples by scan.

:func:`follow` runs one recording scan by scan from the filter's initial
state, fed the pose each scan's registration put out (the program's, which
the reference of the registration judges), and returns the filter's state
after each scan. The program's filter outputs are judged against it.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

GRAV = 9.782940329221166
POS, VEL, PHI, BG, BA, G = 0, 3, 6, 9, 12, 15


def hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def exp_so3(v: np.ndarray) -> np.ndarray:
    """Rodrigues' formula."""
    th = float(np.sqrt(v @ v))
    k = hat(v)
    if th < 1e-8:
        return np.eye(3) + k + 0.5 * k @ k
    return (np.eye(3) + np.sin(th) / th * k
            + (1.0 - np.cos(th)) / th ** 2 * k @ k)


def log_so3(r: np.ndarray) -> np.ndarray:
    return Rotation.from_matrix(r).as_rotvec()


class Filter:
    """The filter's state: at rest at the origin, biases zero, gravity
    straight down, the prior covariance of the configuration's ``ekf``."""

    def __init__(self, ekf: dict):
        self.c = ekf
        self.pos, self.vel = np.zeros(3), np.zeros(3)
        self.rot = np.eye(3)
        self.bg, self.ba = np.zeros(3), np.zeros(3)
        self.grav = np.array([0.0, 0.0, -GRAV])
        # the attitude prior is the squared rotation vector of the
        # intrinsic XYZ Euler angles
        att = Rotation.from_euler(
            "XYZ", [ekf["init_att_rpy_deg"]] * 3, degrees=True).as_rotvec()
        self.cov = np.diag(np.concatenate([
            [ekf["init_pos_std"] ** 2] * 3, [ekf["init_vel_std"] ** 2] * 3,
            att ** 2, [ekf["init_bg_std"] ** 2] * 3,
            [ekf["init_ba_std"] ** 2] * 3, [ekf["init_grav_std"] ** 2] * 3]))
        self.ts = 0.0
        self.started = False

    def predict(self, lacc: np.ndarray, avel: np.ndarray, ts: float) -> None:
        """One IMU sample. The first only starts the clock; a sample at or
        before the clock moves nothing."""
        if not self.started:
            self.ts, self.started = ts, True
            return
        dt = max(ts - self.ts, 0.0)
        self.ts = max(ts, self.ts)
        c = self.c
        r = self.rot
        acc_b = lacc - self.ba
        rot_d = exp_so3((avel - self.bg) * dt)
        acc_w = r @ acc_b + self.grav
        self.pos = self.pos + self.vel * dt + 0.5 * acc_w * dt * dt
        self.vel = self.vel + acc_w * dt
        self.rot = r @ rot_d
        f = np.eye(18)
        f[POS:POS + 3, VEL:VEL + 3] = dt * np.eye(3)
        f[VEL:VEL + 3, PHI:PHI + 3] = -dt * r @ hat(acc_b)
        f[VEL:VEL + 3, BA:BA + 3] = -dt * r
        f[PHI:PHI + 3, PHI:PHI + 3] = rot_d.T
        f[PHI:PHI + 3, BG:BG + 3] = -dt * np.eye(3)
        q = np.zeros(18)
        q[VEL:VEL + 3] = (dt * c["acc_bias_std"]) ** 2
        q[PHI:PHI + 3] = (dt * c["gyr_bias_std"]) ** 2
        q[BA:BA + 3] = dt * c["acc_vrw"] ** 2
        q[BG:BG + 3] = dt * c["gyr_arw"] ** 2
        self.cov = f @ self.cov @ f.T + np.diag(q)

    def update(self, pose: np.ndarray) -> None:
        """The pose update from a measured pose [4, 4]."""
        c = self.c
        h = np.zeros((6, 18))
        h[0:3, POS:POS + 3] = np.eye(3)
        h[3:6, PHI:PHI + 3] = np.eye(3)
        m = np.diag([c["meas_pos_std"] ** 2] * 3
                    + [c["meas_att_std"] ** 2] * 3)
        resid = np.concatenate([pose[:3, 3] - self.pos,
                                log_so3(self.rot.T @ pose[:3, :3])])
        p = self.cov
        k = p @ h.T @ np.linalg.inv(h @ p @ h.T + m)
        dx = k @ resid
        ikh = np.eye(18) - k @ h
        if c["joseph_form"]:
            p = ikh @ p @ ikh.T + k @ m @ k.T
        else:
            p = ikh @ p
        p = 0.5 * (p + p.T)
        dphi = dx[PHI:PHI + 3]
        g = np.eye(3) - hat(0.5 * dphi)
        p[PHI:PHI + 3, PHI:PHI + 3] = g @ p[PHI:PHI + 3, PHI:PHI + 3] @ g.T
        self.cov = p
        self.pos = self.pos + dx[POS:POS + 3]
        self.vel = self.vel + dx[VEL:VEL + 3]
        self.rot = self.rot @ exp_so3(dphi)
        self.bg = self.bg + dx[BG:BG + 3]
        self.ba = self.ba + dx[BA:BA + 3]
        self.grav = self.grav + dx[G:G + 3]


def scan_windows(scan_ts: np.ndarray, imu_ts: np.ndarray, max_per_scan: int
                 ) -> list[np.ndarray]:
    """The indices of the IMU samples of each scan: those stamped after the
    scan before it and up to its own stamp (the first scan: every sample
    up to its stamp), the last ``max_per_scan`` where there are more."""
    out, prev = [], -np.inf
    for t in scan_ts:
        idx = np.nonzero((imu_ts > prev) & (imu_ts <= t))[0]
        out.append(idx[-max_per_scan:])
        prev = t
    return out


def follow(ekf: dict, max_imu_per_scan: int, scan_ts, imu_lacc, imu_avel,
           imu_ts, origin: float, poses: np.ndarray) -> dict[str, np.ndarray]:
    """The filter over a recording's first ``len(poses)`` scans from its
    initial state: each scan's IMU samples, then (where it has any) the
    update with ``poses[i]``. Timestamps are taken as the batcher hands
    them on: less ``origin`` in float64, then rounded to float32. Returns
    the position, velocity, rotation and covariance diagonal after each
    scan."""
    n = len(poses)
    scan_ts = np.asarray(scan_ts, np.float64)[:n] - origin
    imu_ts = np.asarray(imu_ts, np.float64) - origin
    t32 = imu_ts.astype(np.float32).astype(np.float64)
    win = scan_windows(scan_ts, imu_ts, max_imu_per_scan)
    lacc = np.asarray(imu_lacc, np.float64)
    avel = np.asarray(imu_avel, np.float64)
    f = Filter(ekf)
    res = {"pos": np.zeros((n, 3)), "vel": np.zeros((n, 3)),
           "rot": np.zeros((n, 3, 3)), "cov_diag": np.zeros((n, 18))}
    for i in range(n):
        for j in win[i]:
            f.predict(lacc[j], avel[j], t32[j])
        if len(win[i]):
            f.update(np.asarray(poses[i], np.float64))
        res["pos"][i], res["vel"][i], res["rot"][i] = f.pos, f.vel, f.rot
        res["cov_diag"][i] = np.diag(f.cov)
    return res
