"""Whether a run's outputs are correct: the plain reference
(``reference.step``) recomputes the scans the window's checks name, from
the same inputs and from a fresh state or the program's own state before
them; the independent filter (``reference.filter``) follows every
recording the window replayed, scan by scan from its own initial state;
and each number compared is held to its limit (``limits/<cell>.json``).

The numbers, each the largest over the checked scans (of every replica):
``pose_m`` the gap of the KISS and the EKF poses' positions (m),
``rot_rad`` the angle between their rotations, ``vel_mps`` the gap of the
EKF velocity, ``cov_rel`` of the EKF covariance diagonal relative to the
reference's, ``map_rel`` of the map's point count relative to the
reference's, and ``nonfinite_scans`` the window's scans whose pose is not
finite. The filter's numbers, each the largest over every scan of every
recording the window replayed: ``filter_pos_m`` the gap of the EKF position,
``filter_vel_mps`` of its velocity, ``filter_cov_rel`` of its covariance
diagonal relative to the independent filter's. Only the numbers a cell's
limits file lists are judged (the others are printed beside them); a cell
without a limits file is never correct.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import filter as ref_filter
from ..reference import step as ref_step
from . import window

NUMBERS = ("pose_m", "rot_rad", "vel_mps", "cov_rel", "map_rel")
FILTER_NUMBERS = ("filter_pos_m", "filter_vel_mps", "filter_cov_rel")
RUN_FIELDS = ("kiss_pose", "ekf_pose", "ekf_vel", "ekf_cov_diag")


def program_fields(c: window.Check) -> dict[str, np.ndarray]:
    """The program's outputs of the check's scans, as the reference's."""
    def pick(out):
        res = {f: getattr(out, f) for f in ref_step.FIELDS}
        res.update({f: getattr(out.aux, f) for f in ref_step.AUX})
        return res

    if isinstance(c.out, list):
        per = [pick(o) for o in c.out[c.lo:c.lo + c.n]]
        got = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    else:
        got = pick(c.out)
        if c.replica is not None:
            got = {k: v[c.replica] for k, v in got.items()}
        got = {k: v[:c.n] for k, v in got.items()}
    return {k: v.double().cpu().numpy() for k, v in got.items()}


def reference_fields(ctx, c: window.Check, tf32: bool = False
                     ) -> dict[str, np.ndarray]:
    rec = ctx.recs[c.rec]
    lacc, avel, its = window.imu_window(rec, c.lo, c.lo + c.n)[:3]
    return ref_step.run(
        ctx.pipeline, (ctx.sensor.direction, ctx.sensor.offset),
        rec.scans[c.lo:c.lo + c.n], rec.scan_ts[c.lo:c.lo + c.n], lacc,
        avel, its, prev_scan_ts=c.prev_scan_ts, time_origin=c.time_origin,
        start=c.start, boot=c.boot, device=ctx.device, tf32=tf32)


def _rot_angle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angles between the rotations of poses [..., 4, 4], read from the
    skew part of a^T b (exact for small angles)."""
    m = np.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    v = np.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                  m[..., 1, 0] - m[..., 0, 1]], -1) / 2
    return np.arcsin(np.clip(np.linalg.norm(v, axis=-1), 0.0, 1.0))


def pose_gaps(got: dict, want: dict) -> np.ndarray:
    """The gap of the KISS and the EKF positions at each scan of a check,
    the larger of the two."""
    return np.max([np.linalg.norm(got[k][..., :3, 3] - want[k][..., :3, 3],
                                  axis=-1) for k in ("kiss_pose",
                                                     "ekf_pose")], 0)


def gaps(got: dict, want: dict) -> dict[str, float]:
    """The numbers compared, for one check (``got`` against ``want``)."""
    pose = float(pose_gaps(got, want).max())
    rot = max(float(_rot_angle(got[k], want[k]).max())
              for k in ("kiss_pose", "ekf_pose"))
    vel = float(np.linalg.norm(got["ekf_vel"] - want["ekf_vel"],
                               axis=-1).max())
    cov = float((np.abs(got["ekf_cov_diag"] - want["ekf_cov_diag"])
                 / np.abs(want["ekf_cov_diag"])).max())
    mp = float((np.abs(got["map_points"] - want["map_points"])
                / np.maximum(want["map_points"], 1.0)).max())
    out = dict(pose_m=pose, rot_rad=rot, vel_mps=vel, cov_rel=cov,
               map_rel=mp)
    # a number that is not finite on either side is a gap of infinity
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in
            out.items()}


def worst(readings: list[dict], names=NUMBERS) -> dict[str, float]:
    return {k: max(r[k] for r in readings) for k in names} if readings \
        else {}


def run_fields(run: window.Run) -> dict[str, np.ndarray]:
    """The program's outputs of a replayed recording's scans, on the host
    (taken before the program's state is freed)."""
    def pick(out, f):
        x = getattr(out, f)
        return x if run.replica is None else x[run.replica]

    return {f: torch.cat([pick(o, f) for o in run.outs]).double().cpu()
            .numpy() for f in RUN_FIELDS}


def filter_gaps(ctx, rec: int, origin: float, got: dict) -> dict[str, float]:
    """The program's filter outputs of a recording's first scans against
    the independent filter fed the same scans' registered poses."""
    r = ctx.recs[rec]
    want = ref_filter.follow(
        ctx.pipeline["ekf"], ctx.pipeline["max_imu_per_scan"], r.scan_ts,
        r.imu_lacc, r.imu_avel, r.imu_ts, origin, got["kiss_pose"])
    out = dict(
        filter_pos_m=float(np.linalg.norm(
            got["ekf_pose"][:, :3, 3] - want["pos"], axis=-1).max()),
        filter_vel_mps=float(np.linalg.norm(
            got["ekf_vel"] - want["vel"], axis=-1).max()),
        filter_cov_rel=float((np.abs(got["ekf_cov_diag"] - want["cov_diag"])
                              / np.abs(want["cov_diag"])).max()))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in
            out.items()}


def nonfinite_scans(outs) -> int:
    """The scans of ``outs`` (``LioOut``s of any leading shape) whose KISS
    or EKF pose is not finite."""
    bad = 0
    for out in outs:
        poses = torch.cat([out.kiss_pose.flatten(-2),
                           out.ekf_pose.flatten(-2)], -1)
        bad += int((~torch.isfinite(poses).all(-1)).sum())
    return bad


def judge(readings: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, each number the limits file lists with its reading and
    its limit). Without a limits file nothing is correct."""
    if limits is None:
        return False, {}
    checked = {name: {"value": readings[name], "limit": limit}
               for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checked.values()), checked
