"""Wrappers of the EKF kernels K1 (predict block) and K2 (pose update).

The counterparts of ``ptudes_tpu.ops.pallas_ekf``: ``csrc/ekf_predict.cu``
and ``csrc/ekf_update.cu``. A CUDA state launches the kernel (or raises); a
CPU state runs the plain twin in ``models.esekf`` (the ``"unroll"``
predict block, the ``"xla"`` pose update).

Both take a leading replica axis (a state whose leaves are stacked [B, ...],
the batched driver's): one launch for all B replicas, one CTA each, which
counts once in ``kernels.LAUNCHES``; the twins then run replica by
replica.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..models import esekf

_F32 = torch.float32


# K1's history row: ts, pos[3], vel[3], quat[4], bias_gyr[3], bias_acc[3],
# grav[3], then the covariance diagonal after the step
HIST_W = 38
PREDICT_SCAL_W = 22   # K1's scal row (21 used)


def predict_scal(s: esekf.EkfState) -> torch.Tensor:
    """K1's scal rows [..., 22]: pos, vel, quat, biases, gravity, the
    carried timestamp and the initialised flag, one zero of padding."""
    lead = s.imu_ts.shape
    return torch.cat([
        s.pos, s.vel, s.quat, s.bias_gyr, s.bias_acc, s.grav,
        s.imu_ts[..., None], s.initialized[..., None].to(_F32),
        torch.zeros(lead + (1,), dtype=_F32, device=s.cov.device)],
        -1).to(_F32).contiguous()


def predict_block(s: esekf.EkfState, imus: esekf.Imu, valid: torch.Tensor,
                  *, cfg, want_twist: bool = False, log: bool = False):
    """K1: K predict steps in one launch; same contract as
    ``esekf.process_imu_batch`` (biases and gravity pass through). With
    ``log`` the same launch also writes each step's history row (the
    variant ``ekf_predict_history``). With a leading replica axis (``valid``
    [B, K]) one launch runs all B blocks."""
    if kernels.device_kind(s.cov, "ekf_predict") == "cpu":
        twin = dataclasses.replace(cfg, predict_batch="unroll")
        return esekf.process_imu_batch(s, imus, valid, cfg=twin,
                                       want_twist=want_twist, log=log)
    dev = s.cov.device
    lead, k = valid.shape[:-1], int(valid.shape[-1])
    scal = predict_scal(s)
    imu_rows = torch.cat([imus.lacc, imus.avel, imus.ts[..., None],
                          valid.to(_F32)[..., None]], -1).to(_F32) \
        .contiguous()
    cov = s.cov.to(_F32).contiguous()
    out = torch.empty(lead + (32,), dtype=_F32, device=dev)
    cov_out = torch.empty(lead + (18, 18), dtype=_F32, device=dev)
    hist = torch.empty(lead + (k, HIST_W), dtype=_F32, device=dev) \
        if log else None
    kernels.launch(
        "ekf_predict", kernels.ptr(scal, "scal"), kernels.ptr(imu_rows, "imu"),
        kernels.ptr(cov, "cov"), kernels.ptr(out, "out"),
        kernels.ptr(cov_out, "cov_out"),
        kernels.ptr(hist, "hist") if log else None, k,
        cfg.acc_bias_std, cfg.gyr_bias_std, cfg.acc_vrw, cfg.gyr_arw,
        _replicas(lead), variant="ekf_predict_history" if log else None)
    st = esekf.EkfState(
        pos=out[..., 0:3], vel=out[..., 3:6], quat=out[..., 6:10],
        bias_gyr=s.bias_gyr, bias_acc=s.bias_acc, grav=s.grav, cov=cov_out,
        imu_ts=out[..., 10], initialized=out[..., 11] > 0)
    res = (st,)
    if want_twist:
        res += (out[..., 12:18],)
    if log:
        res += (esekf.FilterLog(
            ts=hist[..., 0], pos=hist[..., 1:4], vel=hist[..., 4:7],
            att_q=hist[..., 7:11], bias_gyr=hist[..., 11:14],
            bias_acc=hist[..., 14:17], grav=hist[..., 17:20],
            cov_diag=hist[..., 20:38],
            updated=torch.zeros(lead + (k,), dtype=torch.bool,
                                device=dev)),)
    return res if len(res) > 1 else st


def _replicas(lead: tuple) -> int:
    """The replica count of a launch: 1, or B for one leading axis."""
    if len(lead) > 1:
        raise ValueError(f"one leading replica axis at most, got {lead}")
    return int(lead[0]) if lead else 1


def update_pose(s: esekf.EkfState, pose_meas: torch.Tensor,
                meas_cov: torch.Tensor, *, joseph: bool = True
                ) -> esekf.EkfState:
    """K2: the EKF pose update in one launch; same contract as
    ``esekf.process_pose``. With a leading replica axis (``pose_meas`` [B,
    4, 4], one ``meas_cov`` [6, 6] for all) one launch updates all B."""
    if kernels.device_kind(s.cov, "ekf_update") == "cpu":
        cfg = esekf.EkfConfig(joseph_form=joseph, update_form="xla")
        return esekf.process_pose(s, pose_meas, cfg=cfg, meas_cov=meas_cov)
    dev = s.cov.device
    lead = pose_meas.shape[:-2]
    scal = torch.cat([
        s.pos, s.vel, s.quat, s.bias_gyr, s.bias_acc, s.grav,
        pose_meas[..., :3, :].reshape(lead + (12,)),
        meas_cov.reshape(36).expand(lead + (36,))], -1).to(_F32) \
        .contiguous()
    cov = s.cov.to(_F32).contiguous()
    out = torch.empty(lead + (32,), dtype=_F32, device=dev)
    cov_out = torch.empty(lead + (18, 18), dtype=_F32, device=dev)
    kernels.launch(
        "ekf_update", kernels.ptr(scal, "scal"), kernels.ptr(cov, "cov"),
        kernels.ptr(out, "out"), kernels.ptr(cov_out, "cov_out"),
        int(joseph), _replicas(lead))
    return esekf.EkfState(
        pos=out[..., 0:3], vel=out[..., 3:6], quat=out[..., 6:10],
        bias_gyr=out[..., 10:13], bias_acc=out[..., 13:16],
        grav=out[..., 16:19], cov=cov_out, imu_ts=s.imu_ts,
        initialized=s.initialized)
