"""Loosely coupled lidar-inertial odometry, scan by scan
(``ptudes_tpu.models.lio``), as the reference runs it.

Per scan: EKF predict over the scan's IMU block (which also yields the
deskew twist) -> range image to points -> KISS registration at the EKF
prediction -> map insert -> EKF pose update -> one packed output row.
Scans with no IMU samples are skipped as masked updates. The entry points:
:func:`init_state`, :func:`build_batches` (the host-side batcher),
:func:`make_scan_step`, :func:`scan_at` and :func:`unpack_out`.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig, check_supported
from ..ops.projection import XyzLut, scan_to_points
from . import esekf, kiss
from .esekf import EkfState, Imu
from .kiss import KissAux, KissState


class LioState(NamedTuple):
    kiss: KissState
    ekf: EkfState


class ScanBatch(NamedTuple):
    """Per-scan inputs, stacked along a leading scan axis."""
    range_m: torch.Tensor     # [N, H, W] meters, 0 = no return
    scan_ts: torch.Tensor     # [N] f32 seconds
    imu: Imu                  # lacc/avel [N, K, 3], ts [N, K]
    imu_valid: torch.Tensor   # [N, K] bool
    guess_pose: torch.Tensor  # [N, 4, 4]


class LioOut(NamedTuple):
    kiss_pose: torch.Tensor
    ekf_pose: torch.Tensor
    scan_valid: torch.Tensor
    ekf_vel: torch.Tensor
    ekf_bias_gyr: torch.Tensor
    ekf_bias_acc: torch.Tensor
    ekf_grav: torch.Tensor
    ekf_cov_diag: torch.Tensor
    aux: KissAux


# packed per-scan output row (same layout as the JAX package)
_PK_KISS_POSE, _PK_EKF_POSE, _PK_VALID = 0, 16, 32
_PK_VEL, _PK_BG, _PK_BA, _PK_GRAV, _PK_COV, _PK_AUX = 33, 36, 39, 42, 45, 63


def _pack_out(out: LioOut) -> torch.Tensor:
    """The packed row [70] of one scan's outputs, [B, 70] for B replicas."""
    a = out.aux
    lead = out.scan_valid.shape
    f = lambda x: x.to(torch.float32).reshape(lead + (-1,))  # noqa: E731
    return torch.cat([
        f(out.kiss_pose), f(out.ekf_pose), f(out.scan_valid), f(out.ekf_vel),
        f(out.ekf_bias_gyr), f(out.ekf_bias_acc), f(out.ekf_grav),
        f(out.ekf_cov_diag), f(a.sigma), f(a.err_dt), f(a.err_drot),
        f(a.num_corr), f(a.iterations), f(a.source_count), f(a.map_points)],
        -1)


def unpack_out(p: torch.Tensor) -> LioOut:
    """Inverse of the packed scan output: [..., 70] -> LioOut."""
    lead = p.shape[:-1]

    def f(lo, n):
        return p[..., lo:lo + n]

    def i32(k):
        return p[..., _PK_AUX + k].to(torch.int32)

    return LioOut(
        kiss_pose=f(_PK_KISS_POSE, 16).reshape(lead + (4, 4)),
        ekf_pose=f(_PK_EKF_POSE, 16).reshape(lead + (4, 4)),
        scan_valid=p[..., _PK_VALID] > 0,
        ekf_vel=f(_PK_VEL, 3), ekf_bias_gyr=f(_PK_BG, 3),
        ekf_bias_acc=f(_PK_BA, 3), ekf_grav=f(_PK_GRAV, 3),
        ekf_cov_diag=f(_PK_COV, 18),
        aux=KissAux(sigma=p[..., _PK_AUX], err_dt=p[..., _PK_AUX + 1],
                    err_drot=p[..., _PK_AUX + 2], num_corr=i32(3),
                    iterations=i32(4), source_count=i32(5),
                    map_points=i32(6)))


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without
    a card raises instead of leaving the run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA card is available (pass "
            "device='cpu' to run on the CPU)")
    return dev


def init_state(cfg: PipelineConfig, device="cuda", *, init_grav=None,
               init_bacc=None, init_bgyr=None) -> LioState:
    """A fresh state on ``device`` (the card unless the caller asks for
    another), with the EKF's gravity and bias priors when given."""
    dev = _device(device)
    return LioState(kiss=kiss.init_state(cfg.kiss, cfg.cap, dev),
                    ekf=esekf.init_state(cfg.ekf, dev, init_grav=init_grav,
                                         init_bacc=init_bacc,
                                         init_bgyr=init_bgyr))


def make_scan_step(lut: XyzLut, cfg: PipelineConfig,
                   insert_overflow: bool | str = True):
    """The scan step closure over the projection LUT: (state, one scan of
    the batch) -> (state, packed output row). ``insert_overflow=True`` is
    the bootstrap body (whole frame inserted as one chunk); the steady
    body takes ``cfg.steady_insert_mode``: ``"cond"`` inserts every new
    point in chunks of ``cap.max_new_per_scan``, ``False`` decimates them
    to one such chunk. The guess is the EKF prediction and the deskew
    twist the EKF's over the sweep, as both configurations set them."""
    check_supported(cfg)
    if (cfg.guess, cfg.deskew_mode, cfg.col_decimation, cfg.map_frozen) \
            != ("ekf", "ekf", 1, False):
        raise ValueError("the reference runs the EKF guess and deskew, no "
                         "column decimation and a live map")
    h, w = lut.direction.shape[:2]

    def scan_step(state: LioState, batch: ScanBatch):
        ekf1, twist = esekf.process_imu_batch(
            state.ekf, batch.imu, batch.imu_valid, cfg=cfg.ekf)
        pts, mask, ts01 = scan_to_points(lut, batch.range_m)
        has_imu = torch.any(batch.imu_valid)
        kiss1, pose, aux = kiss.register_scan(
            state.kiss, pts, mask, ts01, cfg=cfg.kiss, cap=cfg.cap,
            initial_guess=esekf.pose_mat(ekf1), deskew_twist=twist,
            update_ok=has_imu, grid_hw=(h, w),
            insert_overflow=insert_overflow)
        ekf2 = esekf.process_pose(ekf1, pose, cfg=cfg.ekf)
        ekf_out = esekf.masked_update(ekf1, ekf2, has_imu)
        out = LioOut(
            kiss_pose=torch.where(has_imu, pose, state.kiss.pose),
            ekf_pose=esekf.pose_mat(ekf_out), scan_valid=has_imu,
            ekf_vel=ekf_out.vel, ekf_bias_gyr=ekf_out.bias_gyr,
            ekf_bias_acc=ekf_out.bias_acc, ekf_grav=ekf_out.grav,
            ekf_cov_diag=torch.diagonal(ekf_out.cov), aux=aux)
        return LioState(kiss=kiss1, ekf=ekf_out), _pack_out(out)

    return scan_step


def scan_at(batches: ScanBatch, i) -> ScanBatch:
    """Scan ``i`` (an int or a slice) of stacked batches."""
    return ScanBatch(batches.range_m[i], batches.scan_ts[i],
                     Imu(*(x[i] for x in batches.imu)),
                     batches.imu_valid[i], batches.guess_pose[i])


def time_origin(scan_ts, imu_ts) -> float:
    """The f64 time origin :func:`build_batches` subtracts before the
    f32 cast."""
    t0 = min(float(scan_ts[0]) if len(scan_ts) else np.inf,
             float(imu_ts[0]) if len(imu_ts) else np.inf)
    return t0 if np.isfinite(t0) else 0.0


_time_origin_fn = time_origin  # un-shadowed alias for build_batches


def build_batches(cfg: PipelineConfig, range_m, scan_ts, imu_lacc, imu_avel,
                  imu_ts, guess_poses=None, time_origin=None,
                  prev_scan_ts=None, *, device="cuda") -> ScanBatch:
    """Host-side batcher: scan i gets the IMU samples with ts in
    (scan_ts[i-1], scan_ts[i]] (first scan: everything up to its
    timestamp), padded or truncated to ``cfg.max_imu_per_scan``;
    timestamps rebased in f64 before the f32 cast. The tensors land on
    ``device``: the card unless the caller asks for another."""
    device = _device(device)
    scan_ts = np.asarray(scan_ts, np.float64)
    imu_ts = np.asarray(imu_ts, np.float64)
    t0 = (_time_origin_fn(scan_ts, imu_ts) if time_origin is None
          else float(time_origin))
    scan_ts = scan_ts - t0
    imu_ts = imu_ts - t0
    imu_lacc = np.asarray(imu_lacc)
    imu_avel = np.asarray(imu_avel)
    n = len(scan_ts)
    k = cfg.max_imu_per_scan
    lacc = np.zeros((n, k, 3), np.float32)
    avel = np.zeros((n, k, 3), np.float32)
    ts = np.zeros((n, k), np.float32)
    valid = np.zeros((n, k), bool)
    prev = -np.inf if prev_scan_ts is None else float(prev_scan_ts) - t0
    dropped = 0
    for i, t1 in enumerate(scan_ts):
        sel = np.where((imu_ts > prev) & (imu_ts <= t1))[0]
        if len(sel) > k:
            dropped += len(sel) - k
            sel = sel[-k:]
        m = len(sel)
        lacc[i, :m] = imu_lacc[sel]
        avel[i, :m] = imu_avel[sel]
        ts[i, :m] = imu_ts[sel]
        valid[i, :m] = True
        prev = t1
    if dropped:
        warnings.warn(
            f"{dropped} IMU samples dropped: more than max_imu_per_scan="
            f"{k} in some scan intervals")
    if guess_poses is None:
        guess_poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return ScanBatch(
        range_m=t(np.asarray(range_m, np.float32)), scan_ts=t(scan_ts),
        imu=Imu(lacc=t(lacc), avel=t(avel), ts=t(ts)),
        imu_valid=t(valid, torch.bool), guess_pose=t(guess_poses))
