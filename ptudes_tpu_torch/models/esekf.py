"""Error-state EKF for IMU odometry (``ptudes_tpu.models.esekf``).

The 18-dim error state [dpos, dvel, datt, dbias_gyr, dbias_acc, dgrav] with
block offsets 0, 3, 6, 9, 12, 15; IMU mechanization predict and the 6-DoF
pose update. The plain forms here are the twins of the CUDA kernels in
``ops.cuda_ekf``: the ``"unroll"`` predict block is K1's, the ``"xla"`` pose
update K2's. ``EkfConfig.predict_batch`` / ``update_form`` = ``"cuda"``
route through the kernel wrappers instead; ``predict_batch="assoc"`` runs
the covariance chain as a log-depth scan of batched products (plain torch
ops: the JAX package's form of it is XLA glue, no kernel). ``FilterLog``
and :func:`run_filter` are the IMU-rate filter history and run.

:func:`process_imu_batch`, :func:`process_pose` and :func:`masked_update`
also take a leading replica axis (every leaf stacked [B, ...], the batched
driver's state): the kernels run all replicas in one launch, the plain
forms replica by replica.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import GRAV
from ..config import EkfConfig
from ..geom import se3, so3
from ..geom.linalg import solve_spd6
from ..utils.replicas import per_replica

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


class FilterLog(NamedTuple):
    """Per-IMU-step filter history, stacked along a leading step axis."""
    ts: torch.Tensor         # [T] the step's own timestamp
    pos: torch.Tensor        # [T, 3]
    vel: torch.Tensor        # [T, 3]
    att_q: torch.Tensor      # [T, 4]
    bias_gyr: torch.Tensor   # [T, 3]
    bias_acc: torch.Tensor   # [T, 3]
    grav: torch.Tensor       # [T, 3]
    cov_diag: torch.Tensor   # [T, 18]
    updated: torch.Tensor    # [T] bool: a pose update applied at this step


def filter_log(states: list[EkfState], ts: torch.Tensor,
               updated: torch.Tensor) -> FilterLog:
    """The history of ``states`` (the state after each step)."""
    def stack(xs, width):
        return torch.stack(xs) if xs else ts.new_zeros((0, width))

    return FilterLog(
        ts=ts, pos=stack([x.pos for x in states], 3),
        vel=stack([x.vel for x in states], 3),
        att_q=stack([x.quat for x in states], 4),
        bias_gyr=stack([x.bias_gyr for x in states], 3),
        bias_acc=stack([x.bias_acc for x in states], 3),
        grav=stack([x.grav for x in states], 3),
        cov_diag=stack([torch.diagonal(x.cov) for x in states], STATE_RANK),
        updated=updated)


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
                      cfg: EkfConfig, want_twist: bool = False,
                      log: bool = False):
    """Predict over a padded block of K samples ([K, 3] / [K] / [K] valid).

    ``predict_batch="unroll"`` is the step-by-step chain (K1's twin);
    ``"cuda"`` runs the block as one kernel (``ops.cuda_ekf``); ``"assoc"``
    is :func:`_process_imu_batch_assoc`. Returns the state, then
    ``log(T_in^-1 T_out)`` (the deskew twist) with ``want_twist``, then the
    block's :class:`FilterLog` (one entry per padded slot) with ``log``.
    Logging does not touch the carried state: it is the one ``log=False``
    returns, bit for bit. Under ``"assoc"`` the history is the unrolled
    chain's (as in the JAX package); under ``"cuda"`` the kernel writes it.
    A leading replica axis ([B, K, ...] samples, [B, ...] state) runs K1
    or the associative form once for all replicas; the unrolled chain and
    the history run replica by replica.
    """
    if cfg.predict_batch == "cuda":
        from ..ops import cuda_ekf
        return cuda_ekf.predict_block(s, imus, valid, cfg=cfg,
                                      want_twist=want_twist, log=log)
    if cfg.predict_batch not in ("unroll", "assoc"):
        raise ValueError(f"unknown predict_batch {cfg.predict_batch!r}")
    if valid.dim() == 2 and (cfg.predict_batch == "unroll" or log):
        return per_replica(process_imu_batch, valid.shape[0], s, imus,
                           valid, cfg=cfg, want_twist=want_twist, log=log)
    if cfg.predict_batch == "unroll" or log:
        out, steps = s, []
        for k in range(valid.shape[0]):
            nxt = process_imu(out, Imu(imus.lacc[k], imus.avel[k],
                                       imus.ts[k]), cfg=cfg)
            out = masked_update(out, nxt, valid[k])
            steps.append(out)
    if cfg.predict_batch == "assoc":
        out = _process_imu_batch_assoc(s, imus, valid, cfg=cfg)
    res = (out,)
    if want_twist:
        res += (se3.log_pose(se3.inv(pose_mat(s)) @ pose_mat(out)),)
    if log:
        res += (filter_log(steps, imus.ts, torch.zeros_like(valid)),)
    return res if len(res) > 1 else out


def suffix_products(f: torch.Tensor) -> torch.Tensor:
    """G_k = F_{K-1} @ ... @ F_k for [..., K, n, n] ``f``: a log-depth
    scan, each level one batched product of the later partial onto the
    earlier."""
    g, d, k = f, 1, f.shape[-3]
    while d < k:
        g = torch.cat([g[..., d:, :, :] @ g[..., :k - d, :, :],
                       g[..., k - d:, :, :]], -3)
        d *= 2
    return g


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., n, n] @ [..., n] -> [..., n]."""
    return (m @ v[..., None])[..., 0]


def _process_imu_batch_assoc(s: EkfState, imus: Imu, valid: torch.Tensor,
                             *, cfg: EkfConfig) -> EkfState:
    """The predict block with a batched covariance: the nav chain runs step
    by step, the covariance as

        P' = G_1 P G_1^T + sum_k G_{k+1} W_k G_{k+1}^T,  G_k = F_K ... F_k,

    symmetrised once (the unrolled chain does so every step; the two differ
    by f32 reassociation). A padded or latching sample has dt = 0, so F = I
    and W = 0. A leading replica axis (state leaves [B, ...], samples
    [B, K, ...], ``valid`` [B, K]) runs every replica's block in the same
    ops."""
    k = valid.shape[-1]
    if k == 0:
        return s
    pos, vel, quat, ts, init = (s.pos, s.vel, s.quat, s.imu_ts,
                                s.initialized)
    zero = torch.zeros_like(ts)
    r_prev, acc_body, rot_d, dts = [], [], [], []
    for i in range(k):
        ok = valid[..., i]
        t = imus.ts[..., i]
        eff = ok & init
        dt = torch.where(eff, torch.clamp(t - ts, min=0.0), zero)
        dtv = dt[..., None]
        r = so3.quat_to_mat(quat)
        ab = imus.lacc[..., i, :] - s.bias_acc
        rd = so3.exp_rotvec((imus.avel[..., i, :] - s.bias_gyr) * dtv)
        acc_total = _mv(r, ab) + s.grav
        pos = pos + vel * dtv + 0.5 * acc_total * dtv * dtv
        vel = vel + acc_total * dtv
        quat = torch.where(eff[..., None],
                           so3.quat_mul(quat, so3.mat_to_quat(rd)), quat)
        # a fresh filter's first valid sample latches ts (no max)
        ts = torch.where(ok, torch.where(init, torch.maximum(t, ts), t), ts)
        init = init | ok
        r_prev.append(r)
        acc_body.append(ab)
        rot_d.append(rd)
        dts.append(dt)
    lead = valid.shape[:-1]
    r_prev, acc_body, rot_d, dt = (torch.stack(x, len(lead)) for x in (
        r_prev, acc_body, rot_d, dts))

    dev = s.cov.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye = torch.eye(STATE_RANK, dtype=torch.float32, device=dev)
    dtm = dt[..., None, None]
    fx = eye.repeat(lead + (k, 1, 1))
    fx[..., POS:POS + 3, VEL:VEL + 3] = dtm * eye3
    fx[..., VEL:VEL + 3, PHI:PHI + 3] = -dtm * (r_prev @ so3.hat(acc_body))
    fx[..., VEL:VEL + 3, BA:BA + 3] = -dtm * r_prev
    fx[..., PHI:PHI + 3, PHI:PHI + 3] = rot_d.transpose(-1, -2)
    fx[..., PHI:PHI + 3, BG:BG + 3] = -dtm * eye3
    wdiag = torch.zeros(lead + (k, STATE_RANK), dtype=torch.float32,
                        device=dev)
    wdiag[..., VEL:VEL + 3] = ((dt * cfg.acc_bias_std) ** 2)[..., None]
    wdiag[..., PHI:PHI + 3] = ((dt * cfg.gyr_bias_std) ** 2)[..., None]
    wdiag[..., BA:BA + 3] = (dt * cfg.acc_vrw ** 2)[..., None]
    wdiag[..., BG:BG + 3] = (dt * cfg.gyr_arw ** 2)[..., None]

    gs = suffix_products(fx)
    g1 = gs[..., 0, :, :]
    gnext = torch.cat([gs[..., 1:, :, :], eye.expand(lead + (1, STATE_RANK,
                                                             STATE_RANK))],
                      -3)
    cov = g1 @ s.cov @ g1.transpose(-1, -2) + torch.einsum(
        "...kij,...kj,...klj->...il", gnext, wdiag, gnext)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    return EkfState(pos, vel, quat, s.bias_gyr, s.bias_acc, s.grav, cov, ts,
                    init)


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
    """EKF update from a 6-DoF pose measurement. ``update_form="xla"`` is
    the op chain (K2's twin), ``"cuda"`` one kernel (``ops.cuda_ekf``)."""
    dev = s.cov.device
    if meas_cov is None:
        meas_cov = default_meas_cov(cfg, dev)
    if cfg.update_form == "cuda":
        from ..ops import cuda_ekf
        return cuda_ekf.update_pose(s, pose_meas, meas_cov,
                                    joseph=cfg.joseph_form)
    if cfg.update_form != "xla":
        raise ValueError(f"unknown update_form {cfg.update_form!r}")
    if pose_meas.dim() == 3:
        return per_replica(process_pose, pose_meas.shape[0], s, pose_meas,
                           cfg=cfg, meas_cov=meas_cov)

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


def run_filter(s: EkfState, imus: Imu, corr_mask: torch.Tensor,
               corr_poses: torch.Tensor, *, cfg: EkfConfig,
               meas_cov: torch.Tensor | None = None
               ) -> tuple[EkfState, FilterLog]:
    """The IMU-rate filter over stacked samples [T]: each step one predict,
    then the pose update with ``corr_poses[t]`` where ``corr_mask[t]``
    (``cfg.update_form`` picks the op chain or K2). Returns the last state
    and the history."""
    steps = []
    for t in range(corr_mask.shape[0]):
        s = process_imu(s, Imu(imus.lacc[t], imus.avel[t], imus.ts[t]),
                        cfg=cfg)
        corrected = process_pose(s, corr_poses[t], cfg=cfg,
                                 meas_cov=meas_cov)
        s = masked_update(s, corrected, corr_mask[t])
        steps.append(s)
    return s, filter_log(steps, imus.ts, corr_mask)
