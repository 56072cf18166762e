"""EKF debug scene export (``ptudes_tpu.viz.debug_scene``), the
replacement for the reference's 3D debug viewer ``ekf_viz``
(``src/ptudes/ins/viz_utils.py:317-626``).

The reference renders, per EKF update knot: the scan frame, the
downsampled source, the NN correspondence pairs, the local map, the pose
axes, and a covariance visualization built by sampling 2000 points from
the position marginal and 100 axes from the attitude marginal
(``:506-523``), navigable by keyboard. This module exports the same
per-update scene as PLY clouds and a JSON index keyed by update knot,
with the JAX package's files and JSON.

Scene layout (one set per exported knot k):

    scene.json                     index: knots, files, config
    knot_XXXX.json                 poses (pred/icp/ekf), sigma, iters, corr
    knot_XXXX_source.ply           deskewed source at the registered pose
    knot_XXXX_target.ply           matched NN map points (correspondences)
    knot_XXXX_cov_pos.ply          2000 samples ~ N(pos, P_pos)
    knot_XXXX_cov_att.ply          100 rotated axis triads from P_att
    knot_XXXX_map.ply              local map snapshot

The scan step runs on the device of the state and batches (the card for
the command), through the configuration's kernel forms; the covariance
samples are numpy with the JAX package's seeds.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..geom import se3, so3
from ..models import esekf, lio
from ..ops import deskew as deskew_ops
from ..ops import icp, voxel
from ..ops.projection import scan_to_points
from .cloud import map_to_points, save_ply

POS, PHI = 0, 6  # error-state block offsets (esekf.POS / esekf.PHI)


def _np64(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _pose_list(p) -> list:
    return np.asarray(p, np.float64).reshape(4, 4).tolist()


def sample_covariance(
    pos: np.ndarray, cov: np.ndarray, quat_mat: np.ndarray,
    n_pos: int = 2000, n_att: int = 100, axis_len: float = 0.5,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Covariance visualization clouds, reference ``:506-523`` semantics:
    ``n_pos`` samples from the position marginal and ``n_att`` rotated axis
    triads (3 points each, xyz-colored by the caller) from the attitude
    marginal applied to the current rotation."""
    rng = np.random.default_rng(seed)
    p_pos = cov[POS:POS + 3, POS:POS + 3]
    p_att = cov[PHI:PHI + 3, PHI:PHI + 3]
    # guard f32 asymmetry / tiny negatives
    p_pos = 0.5 * (p_pos + p_pos.T) + 1e-12 * np.eye(3)
    p_att = 0.5 * (p_att + p_att.T) + 1e-12 * np.eye(3)
    pos_cloud = rng.multivariate_normal(pos, p_pos, size=n_pos).astype(
        np.float32)

    rvecs = rng.multivariate_normal(np.zeros(3), p_att, size=n_att)
    from scipy.spatial.transform import Rotation as R
    rots = R.from_rotvec(rvecs).as_matrix() @ quat_mat[None]
    axes = (rots * axis_len).transpose(0, 2, 1) + pos[None, None, :]
    return pos_cloud, axes.reshape(-1, 3).astype(np.float32)


def export_debug_scenes(
    out_dir: str,
    cfg,
    lut,
    batches: lio.ScanBatch,
    *,
    stride: int = 1,
    map_stride: int = 10,
    n_pos_samples: int = 2000,
    n_att_samples: int = 100,
    init_state: lio.LioState | None = None,
) -> dict:
    """Run the pipeline scan by scan and export per-update scenes.

    A debugging tool (the reference's viewer is interactive): the host
    drives the scan step (``lio.make_scan_step``'s whole-frame insert body,
    as the JAX package's export does) one scan at a time, so the
    intermediate state (full covariance, local map, correspondences at the
    refined pose) is read between steps. A fresh state is made on the
    device of ``batches`` unless ``init_state`` is given."""
    os.makedirs(out_dir, exist_ok=True)
    step = lio.make_scan_step(lut, cfg)
    state = lio.init_state(cfg, batches.range_m.device) \
        if init_state is None else init_state
    kcfg, cap = cfg.kiss, cfg.cap
    vs = kcfg.resolved_voxel_size

    n = batches.range_m.shape[0]
    knots = []
    for i in range(n):
        batch = lio.scan_at(batches, i)
        pred_pose = esekf.pose_mat(
            esekf.process_imu_batch(state.ekf, batch.imu, batch.imu_valid,
                                    cfg=cfg.ekf))
        prev_state = state
        state, row = step(state, batch)
        out = lio.unpack_out(row)

        if i % stride:
            continue

        icp_pose = _np64(out.kiss_pose)
        ekf_pose = _np64(out.ekf_pose)

        # recompute the final correspondences at the refined pose against
        # the pre-update map (what the last GN iteration saw)
        pts, mask, ts01 = scan_to_points(lut, batch.range_m)
        if kcfg.deskew:
            twist = se3.log_pose(
                se3.inv(esekf.pose_mat(prev_state.ekf)) @ pred_pose)
            pts = deskew_ops.deskew_by_twist(pts, ts01 - 0.5, twist)
        mask = voxel.range_clip_mask(pts, mask, kcfg.min_range,
                                     kcfg.max_range)
        keep_f = voxel.first_in_voxel_mask(pts, mask, vs * 0.5,
                                           cap.dedup_table)
        frame_ds, frame_mask = voxel.compact(pts, keep_f, cap.max_frame)
        keep_s = voxel.first_in_voxel_mask(frame_ds, frame_mask, vs * 1.5,
                                           cap.dedup_table)
        source, source_mask = voxel.compact(frame_ds, keep_s, cap.max_source)
        src_w = se3.transform(out.kiss_pose, source)
        cand = icp.gather_candidates(
            prev_state.kiss.local_map, src_w, voxel_size=vs,
            max_probes=cap.max_probes, neighborhood=kcfg.nn_neighborhood,
            n_voxels=kcfg.nn_voxels, fit_planes=False)
        d2 = torch.sum((cand.pts - src_w[:, None, :]) ** 2, -1)
        d2 = d2 + torch.where(cand.valid, 0.0, torch.inf)
        kbest = torch.argmin(d2, -1)
        nn = torch.take_along_dim(cand.pts, kbest[:, None, None], 1)[:, 0]
        d2min = torch.take_along_dim(d2, kbest[:, None], 1)[:, 0]
        sigma = float(out.aux.sigma)
        corr = (source_mask & torch.isfinite(d2min)
                & (d2min <= (3.0 * sigma) ** 2)).cpu().numpy()

        src_np = src_w.cpu().numpy()[corr]
        nn_np = nn.cpu().numpy()[corr]
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_source.ply"), src_np)
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_target.ply"), nn_np)

        cov = _np64(state.ekf.cov)
        rmat = _np64(so3.quat_to_mat(state.ekf.quat))
        pos_cloud, att_axes = sample_covariance(
            ekf_pose[:3, 3], cov, rmat, n_pos=n_pos_samples,
            n_att=n_att_samples, seed=i)
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_cov_pos.ply"),
                 pos_cloud)
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_cov_att.ply"),
                 att_axes)

        if i % map_stride == 0:
            save_ply(os.path.join(out_dir, f"knot_{i:04d}_map.ply"),
                     map_to_points(state.kiss.local_map, vs))

        meta = {
            "knot": i,
            "pred_pose": _pose_list(_np64(pred_pose)),
            "icp_pose": _pose_list(icp_pose),
            "ekf_pose": _pose_list(ekf_pose),
            "sigma": sigma,
            "iterations": int(out.aux.iterations),
            "num_corr": int(np.sum(corr)),
            "cov_diag": _np64(out.ekf_cov_diag).tolist(),
            "scan_valid": bool(out.scan_valid),
        }
        with open(os.path.join(out_dir, f"knot_{i:04d}.json"), "w") as f:
            json.dump(meta, f, indent=1)
        knots.append(i)

    index = {
        "knots": knots,
        "stride": stride,
        "map_stride": map_stride,
        "n_pos_samples": n_pos_samples,
        "n_att_samples": n_att_samples,
        "files": {
            "poses": "knot_XXXX.json",
            "source": "knot_XXXX_source.ply",
            "target": "knot_XXXX_target.ply",
            "cov_pos": "knot_XXXX_cov_pos.ply",
            "cov_att": "knot_XXXX_cov_att.ply",
            "map": f"knot_XXXX_map.ply (every {map_stride})",
        },
    }
    with open(os.path.join(out_dir, "scene.json"), "w") as f:
        json.dump(index, f, indent=1)
    return index
