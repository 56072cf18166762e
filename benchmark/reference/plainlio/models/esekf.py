"""Error-state EKF for IMU odometry (``ptudes_tpu.models.esekf``), the
plain forms the reference runs.

The 18-dim error state [dpos, dvel, datt, dbias_gyr, dbias_acc, dgrav] with
block offsets 0, 3, 6, 9, 12, 15; IMU mechanization predict and the 6-DoF
pose update. The predict block is K1's twin (``"unroll"``), the pose
update K2's (``"xla"``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import GRAV
from ..config import EkfConfig
from ..geom import se3, so3
from ..geom.linalg import solve_spd6

STATE_RANK = 18
POS, VEL, PHI, BG, BA, G = 0, 3, 6, 9, 12, 15


class EkfState(NamedTuple):
    pos: torch.Tensor        # [3]
    vel: torch.Tensor        # [3]
    quat: torch.Tensor       # [4] xyzw attitude (body->world)
    bias_gyr: torch.Tensor   # [3]
    bias_acc: torch.Tensor   # [3]
    grav: torch.Tensor       # [3]
    cov: torch.Tensor        # [18, 18]
    imu_ts: torch.Tensor     # [] last processed IMU timestamp (s)
    initialized: torch.Tensor  # [] bool


class Imu(NamedTuple):
    lacc: torch.Tensor
    avel: torch.Tensor
    ts: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_cov(cfg: EkfConfig, device) -> torch.Tensor:
    """Initial covariance (the reference's squared-rotvec attitude block)."""
    rpy = torch.full((3,), math.radians(cfg.init_att_rpy_deg),
                     dtype=torch.float32, device=device)
    att = so3.quat_to_rotvec(so3.quat_from_euler_xyz(rpy))
    f = lambda v: torch.full((3,), v, dtype=torch.float32, device=device)  # noqa: E731
    d = torch.cat([f(cfg.init_pos_std ** 2), f(cfg.init_vel_std ** 2),
                   att ** 2, f(cfg.init_bg_std ** 2), f(cfg.init_ba_std ** 2),
                   f(cfg.init_grav_std ** 2)])
    return torch.diag(d)


def init_state(cfg: EkfConfig, device, init_grav=None, init_bacc=None,
               init_bgyr=None) -> EkfState:
    """At rest at the origin; biases zero and gravity straight down unless
    a prior is given (a numpy array or a tensor, cast to f32 on
    ``device``)."""
    def prior(x, default):
        return _f32(default if x is None else x, device)

    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return EkfState(
        pos=z3, vel=z3.clone(),
        quat=_f32([0.0, 0.0, 0.0, 1.0], device),
        bias_gyr=prior(init_bgyr, [0.0] * 3),
        bias_acc=prior(init_bacc, [0.0] * 3),
        grav=prior(init_grav, [0.0, 0.0, -GRAV]),
        cov=init_cov(cfg, device),
        imu_ts=torch.zeros((), dtype=torch.float32, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def pose_mat(s: EkfState) -> torch.Tensor:
    return se3.make_pose(so3.quat_to_mat(s.quat), s.pos)


def masked_update(old: EkfState, new: EkfState,
                  apply: torch.Tensor) -> EkfState:
    """``new`` where ``apply`` else ``old``, leaf by leaf (``apply`` [B]
    selects per replica)."""
    def sel(a, b):
        return torch.where(
            apply.reshape(apply.shape + (1,) * (b.dim() - apply.dim())),
            b, a)

    return EkfState(*[sel(a, b) for a, b in zip(old, new)])


def _set_blk(m: torch.Tensor, i: int, j: int, b: torch.Tensor) -> None:
    m[i:i + 3, j:j + 3] = b


def process_imu(s: EkfState, imu: Imu, *, cfg: EkfConfig) -> EkfState:
    """EKF predict by one sample; the first sample only latches the clock,
    stale samples (at or before the carried timestamp) are no-ops."""
    dt = torch.clamp(imu.ts - s.imu_ts, min=0.0)
    ts_next = torch.maximum(imu.ts, s.imu_ts)
    r_prev = so3.quat_to_mat(s.quat)
    acc_body = imu.lacc - s.bias_acc
    avel_body = imu.avel - s.bias_gyr
    rot_dtheta = so3.exp_rotvec(avel_body * dt)

    acc_total = r_prev @ acc_body + s.grav
    pos = s.pos + s.vel * dt + 0.5 * acc_total * dt * dt
    vel = s.vel + acc_total * dt
    quat = so3.quat_mul(s.quat, so3.mat_to_quat(rot_dtheta))

    dev = s.cov.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    fx = torch.eye(STATE_RANK, dtype=torch.float32, device=dev)
    _set_blk(fx, POS, VEL, dt * eye3)
    _set_blk(fx, VEL, PHI, -dt * (r_prev @ so3.hat(acc_body)))
    _set_blk(fx, VEL, BA, -dt * r_prev)
    _set_blk(fx, PHI, PHI, rot_dtheta.T)
    _set_blk(fx, PHI, BG, -dt * eye3)
    w = torch.zeros((STATE_RANK, STATE_RANK), dtype=torch.float32,
                    device=dev)
    _set_blk(w, VEL, VEL, (dt * cfg.acc_bias_std) ** 2 * eye3)
    _set_blk(w, PHI, PHI, (dt * cfg.gyr_bias_std) ** 2 * eye3)
    _set_blk(w, BA, BA, dt * cfg.acc_vrw ** 2 * eye3)
    _set_blk(w, BG, BG, dt * cfg.gyr_arw ** 2 * eye3)
    cov = fx @ s.cov @ fx.T + w
    cov = 0.5 * (cov + cov.T)

    true = torch.ones_like(s.initialized)
    new = EkfState(pos, vel, quat, s.bias_gyr, s.bias_acc, s.grav, cov,
                   ts_next, true)
    latch = s._replace(imu_ts=imu.ts.to(torch.float32), initialized=true)
    return masked_update(latch, new, s.initialized)


def process_imu_batch(s: EkfState, imus: Imu, valid: torch.Tensor, *,
                      cfg: EkfConfig) -> tuple[EkfState, torch.Tensor]:
    """Predict over a padded block of K samples ([K, 3] / [K] / [K] valid),
    step by step (K1's twin). Returns the state and ``log(T_in^-1 T_out)``
    (the deskew twist)."""
    if cfg.predict_batch != "unroll":
        raise ValueError("the reference runs the unrolled predict, not "
                         f"{cfg.predict_batch!r}")
    out = s
    for k in range(valid.shape[0]):
        nxt = process_imu(out, Imu(imus.lacc[k], imus.avel[k], imus.ts[k]),
                          cfg=cfg)
        out = masked_update(out, nxt, valid[k])
    return out, se3.log_pose(se3.inv(pose_mat(s)) @ pose_mat(out))


def default_meas_cov(cfg: EkfConfig, device) -> torch.Tensor:
    """blkdiag(pos 0.02^2, att 0.01^2)."""
    d = torch.cat([
        torch.full((3,), cfg.meas_pos_std ** 2, dtype=torch.float32,
                   device=device),
        torch.full((3,), cfg.meas_att_std ** 2, dtype=torch.float32,
                   device=device)])
    return torch.diag(d)


def process_pose(s: EkfState, pose_meas: torch.Tensor, *, cfg: EkfConfig,
                 meas_cov: torch.Tensor | None = None) -> EkfState:
    """EKF update from a 6-DoF pose measurement, the op chain (K2's
    twin)."""
    dev = s.cov.device
    if meas_cov is None:
        meas_cov = default_meas_cov(cfg, dev)
    if cfg.update_form != "xla":
        raise ValueError("the reference runs the op chain update, not "
                         f"{cfg.update_form!r}")

    r_k = so3.quat_to_mat(s.quat)
    resid = torch.cat([se3.trans(pose_meas) - s.pos,
                       so3.log_rotmat(r_k.T @ se3.rot(pose_meas))])
    jp = torch.zeros((6, STATE_RANK), dtype=torch.float32, device=dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    jp[0:3, POS:POS + 3] = eye3
    jp[3:6, PHI:PHI + 3] = eye3
    p = s.cov
    smat = jp @ p @ jp.T + meas_cov
    k = solve_spd6(smat, (p @ jp.T).T).T
    dx = k @ resid
    ikj = torch.eye(STATE_RANK, dtype=torch.float32, device=dev) - k @ jp
    if cfg.joseph_form:
        cov = ikj @ p @ ikj.T + k @ meas_cov @ k.T
    else:
        cov = ikj @ p
    cov = 0.5 * (cov + cov.T)

    dphi = dx[PHI:PHI + 3]
    quat = so3.quat_mul(s.quat, so3.rotvec_to_quat(dphi))
    g_theta = eye3 - so3.hat(0.5 * dphi)
    cov = cov.clone()
    cov[PHI:PHI + 3, PHI:PHI + 3] = \
        g_theta @ cov[PHI:PHI + 3, PHI:PHI + 3] @ g_theta.T
    return EkfState(
        pos=s.pos + dx[POS:POS + 3], vel=s.vel + dx[VEL:VEL + 3], quat=quat,
        bias_gyr=s.bias_gyr + dx[BG:BG + 3],
        bias_acc=s.bias_acc + dx[BA:BA + 3],
        grav=s.grav + dx[G:G + 3], cov=cov,
        imu_ts=s.imu_ts, initialized=s.initialized)


