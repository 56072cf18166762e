"""Loosely coupled lidar-inertial odometry, scan by scan
(``ptudes_tpu.models.lio``).

Per scan: EKF predict over the scan's IMU block (which also yields the
deskew twist) -> range image to points -> KISS registration at the guess
(the EKF prediction, ground truth or KISS's constant velocity) -> map
insert -> EKF pose update -> one packed output row. Scans with no IMU
samples are skipped as masked updates. The same entry points as the JAX
package: :func:`init_state`, :func:`build_batches`, :func:`run_sequence`
(with ``log=True`` also the IMU-rate filter history), and the host-side
:func:`flatten_filter_log`; here ``run_sequence`` is a Python loop over
scans whose steps synchronise with the host only in the ICP's
candidate-refresh loop (``nn_refresh_drift > 0``: one small read per GN
iteration).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig, check_supported
from ..ops.projection import XyzLut, scan_to_points
from . import esekf, kiss
from .esekf import EkfState, FilterLog, Imu
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
    # the IMU-rate filter history ([..., K] per scan, aligned with
    # imu_valid) of a run with log=True, else None; each scan's pose update
    # is folded into its last valid slot (updated=True there)
    flog: FilterLog | None = None


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


def _fold_knot(flog: FilterLog, valid: torch.Tensor, has_imu: torch.Tensor,
               ekf: EkfState) -> FilterLog:
    """The scan's history with the post-update state in its last valid
    slot (the knot, ``updated`` there); on the device, no host read. With
    a leading replica axis (``valid`` [B, K]) each replica's own."""
    k, lead = valid.shape[-1], valid.shape[:-1]
    last = valid.to(torch.int32).sum(-1, keepdim=True) - 1
    knot = (torch.arange(k, device=valid.device) == last) \
        & has_imu[..., None]

    def put(seq, post):
        m = knot.reshape(lead + (k,) + (1,) * (seq.dim() - valid.dim()))
        return torch.where(m, post.unsqueeze(len(lead)), seq)

    return FilterLog(
        ts=flog.ts, pos=put(flog.pos, ekf.pos), vel=put(flog.vel, ekf.vel),
        att_q=put(flog.att_q, ekf.quat),
        bias_gyr=put(flog.bias_gyr, ekf.bias_gyr),
        bias_acc=put(flog.bias_acc, ekf.bias_acc),
        grav=put(flog.grav, ekf.grav),
        cov_diag=put(flog.cov_diag, torch.diagonal(ekf.cov, 0, -2, -1)),
        updated=knot)


def make_scan_step(lut: XyzLut, cfg: PipelineConfig,
                   insert_overflow: bool | str = True, log: bool = False,
                   defer_insert: bool = False,
                   map_logical_capacity: int | None = None, group=None):
    """The scan step closure over the projection LUT: (state, one scan of
    the batch) -> (state, packed output row), and with ``log`` the scan's
    :class:`FilterLog` as a third element. ``insert_overflow=True`` is the
    bootstrap body (whole frame inserted as one chunk); the steady body
    takes ``cfg.steady_insert_mode``: ``"cond"`` inserts every new point in
    chunks of ``cap.max_new_per_scan``, ``False`` decimates them to one
    such chunk. The guess is ``cfg.guess``'s (the EKF prediction, the
    batch's ``guess_pose``, or KISS's constant velocity); the deskew twist
    is the EKF's over the sweep with ``deskew_mode="ekf"``. The range image
    is decimated by ``cfg.col_decimation`` columns before the front end
    (its grid then H x W/d); with ``cfg.map_frozen`` the map is left as it
    is.

    ``defer_insert``: the map is left as it is and the step also returns
    the scan's ``kiss.DeferredInsert`` last. ``map_logical_capacity``
    (with ``defer_insert``): the state's map is a flat B-map table and the
    step takes the replica's slot base as a third argument
    (``ptudes_tpu.models.lio.make_scan_step``'s flat-map mode; the
    batched driver, ``parallel.batched``, runs all replicas in one step of
    its own instead).

    ``group`` (a ``torch.distributed`` process group): the point-sharded
    step of ``parallel.sharded``, the same step with the ICP source split
    over the group's ranks (``kiss.register_scan``'s ``group``)."""
    if map_logical_capacity is not None and not defer_insert:
        raise ValueError("a flat map (map_logical_capacity) needs "
                         "defer_insert")
    check_supported(cfg)
    h, w = lut.direction.shape[:2]
    d = cfg.col_decimation
    need_twist = cfg.deskew_mode == "ekf" and cfg.kiss.deskew

    def scan_step(state: LioState, batch: ScanBatch,
                  map_slot_base: torch.Tensor | None = None):
        res = esekf.process_imu_batch(
            state.ekf, batch.imu, batch.imu_valid, cfg=cfg.ekf,
            want_twist=need_twist, log=log)
        res = res if need_twist or log else (res,)
        ekf1 = res[0]
        twist = res[1] if need_twist else None
        pts, mask, ts01 = scan_to_points(lut, batch.range_m, decimate=d)
        has_imu = torch.any(batch.imu_valid)
        guess = None                          # "kiss": constant velocity
        if cfg.guess == "ekf":
            guess = esekf.pose_mat(ekf1)
        elif cfg.guess == "gt":
            guess = batch.guess_pose
        kiss1, pose, aux, *deferred = kiss.register_scan(
            state.kiss, pts, mask, ts01, cfg=cfg.kiss, cap=cfg.cap,
            initial_guess=guess, use_guess=guess is not None,
            deskew_twist=twist, update_ok=has_imu, grid_hw=(h, w // d),
            insert_overflow=insert_overflow, map_frozen=cfg.map_frozen,
            defer_insert=defer_insert, map_slot_base=map_slot_base,
            map_logical_capacity=map_logical_capacity, group=group)
        ekf2 = esekf.process_pose(ekf1, pose, cfg=cfg.ekf)
        ekf_out = esekf.masked_update(ekf1, ekf2, has_imu)
        out = LioOut(
            kiss_pose=torch.where(has_imu, pose, state.kiss.pose),
            ekf_pose=esekf.pose_mat(ekf_out), scan_valid=has_imu,
            ekf_vel=ekf_out.vel, ekf_bias_gyr=ekf_out.bias_gyr,
            ekf_bias_acc=ekf_out.bias_acc, ekf_grav=ekf_out.grav,
            ekf_cov_diag=torch.diagonal(ekf_out.cov), aux=aux)
        new_state = LioState(kiss=kiss1, ekf=ekf_out)
        if log:
            return (new_state, _pack_out(out), _fold_knot(
                res[-1], batch.imu_valid, has_imu, ekf_out), *deferred)
        return (new_state, _pack_out(out), *deferred)

    return scan_step


def scan_at(batches: ScanBatch, i) -> ScanBatch:
    """Scan ``i`` (an int or a slice) of stacked batches."""
    return ScanBatch(batches.range_m[i], batches.scan_ts[i],
                     Imu(*(x[i] for x in batches.imu)),
                     batches.imu_valid[i], batches.guess_pose[i])


def run_sequence(state: LioState, batches: ScanBatch, lut: XyzLut, *,
                 cfg: PipelineConfig, log: bool = False, group=None
                 ) -> tuple[LioState, LioOut]:
    """Run every scan of ``batches``: the first ``cfg.bootstrap_scans``
    with the whole-frame insert, the rest with the steady insert
    (``bootstrap_scans < 0``: all bootstrap); with ``cfg.map_frozen``
    (localisation on a prior map, which has no insert) every scan with
    the one step the JAX package builds with ``insert_overflow=False``.
    ``log=True`` also returns the
    IMU-rate filter history in ``LioOut.flog``, shaped [N, K] (filter it
    with ``batches.imu_valid``, :func:`flatten_filter_log`); the carried
    states are the same as without. ``group``: every step point-sharded
    over its ranks (:func:`make_scan_step`; ``parallel.sharded``)."""
    n = batches.range_m.shape[0]
    k = n if cfg.bootstrap_scans < 0 else min(cfg.bootstrap_scans, n)
    if cfg.map_frozen:
        k = 0
    steady = make_scan_step(
        lut, cfg, insert_overflow=(False if cfg.map_frozen
                                   else cfg.steady_insert_mode), log=log,
        group=group)
    boot = make_scan_step(lut, cfg, insert_overflow=True, log=log,
                          group=group) if k else steady
    rows, logs = [], []
    for i in range(n):
        state, row, *flog = (boot if i < k else steady)(state,
                                                        scan_at(batches, i))
        rows.append(row)
        logs += flog
    out = unpack_out(torch.stack(rows))
    if log:
        out = out._replace(flog=FilterLog(*map(torch.stack, zip(*logs))))
    return state, out


def flatten_filter_log(flog: FilterLog, imu_valid) -> FilterLog:
    """Host-side: a [N, K] history from ``run_sequence(log=True)`` as
    numpy, flattened to its valid IMU-rate entries [T]."""
    def np_(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def flat(x):
        x = np_(x)
        return x.reshape((-1,) + x.shape[2:])[v]

    v = np_(imu_valid).reshape(-1)
    return FilterLog(*map(flat, flog))


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
