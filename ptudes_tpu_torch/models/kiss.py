"""KISS-ICP-style odometry (``ptudes_tpu.models.kiss``).

Per scan: deskew (by the EKF twist, or KISS's constant velocity) -> range
clip -> the front end: on the range-image grid, a window pre-dedup,
compaction and two sort-based first-in-voxel passes (0.5 and 1.5 voxel);
without a grid, two scatter-table first-in-voxel passes with compaction ->
evenly decimated ICP source -> adaptive threshold -> robust ICP
(cached candidates, or a map query every iteration) -> model-deviation
statistics -> map insert with fused eviction (none on a frozen map). Every
stage has a static shape; the step synchronises with the host only in the
ICP's candidate-refresh loop and in the every-iteration query loop (one
read per GN iteration, ``icp.read_flags``), never with frozen candidates.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import Capacity, KissConfig
from ..geom import se3
from ..ops import deskew as deskew_ops
from ..ops import hashmap, icp, voxel


class KissState(NamedTuple):
    local_map: hashmap.VoxelHashMap
    pose: torch.Tensor         # [4, 4] T_{k-1}
    pose_prev: torch.Tensor    # [4, 4] T_{k-2}
    model_sse: torch.Tensor    # [] f32
    num_samples: torch.Tensor  # [] int32
    num_scans: torch.Tensor    # [] int32


class KissAux(NamedTuple):
    sigma: torch.Tensor
    err_dt: torch.Tensor
    err_drot: torch.Tensor
    num_corr: torch.Tensor
    iterations: torch.Tensor
    source_count: torch.Tensor
    map_points: torch.Tensor


def init_state(cfg: KissConfig, cap: Capacity, device) -> KissState:
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return KissState(
        local_map=hashmap.create(cap.map_capacity, cfg.max_points_per_voxel,
                                 device),
        pose=eye, pose_prev=eye.clone(),
        model_sse=torch.zeros((), dtype=torch.float32, device=device),
        num_samples=torch.zeros((), dtype=torch.int32, device=device),
        num_scans=torch.zeros((), dtype=torch.int32, device=device))


def prediction_model(state: KissState) -> torch.Tensor:
    """Constant-velocity prediction: inv(T_{k-2}) @ T_{k-1}."""
    return se3.inv(state.pose_prev) @ state.pose


def get_adaptive_threshold(state: KissState, cfg: KissConfig
                           ) -> torch.Tensor:
    """sigma: the initial value until motion statistics exist, then
    sqrt(sse / num)."""
    return torch.where(
        state.num_samples < 1,
        torch.full_like(state.model_sse, cfg.initial_threshold),
        torch.sqrt(state.model_sse / torch.clamp(state.num_samples, min=1)))


def model_error(dev_t: torch.Tensor, dev_r: torch.Tensor,
                max_range: float) -> torch.Tensor:
    """kiss AdaptiveThreshold::ComputeModelError from the deviation norms."""
    return dev_t + 2.0 * max_range * torch.sin(0.5 * dev_r)


def register_scan(state: KissState, pts: torch.Tensor, mask: torch.Tensor,
                  ts01: torch.Tensor, *, cfg: KissConfig, cap: Capacity,
                  update_ok: torch.Tensor | None = None,
                  grid_hw: tuple[int, int] | None = None,
                  initial_guess: torch.Tensor | None = None,
                  use_guess: bool = False,
                  deskew_twist: torch.Tensor | None = None,
                  insert_overflow: bool | str = True,
                  map_frozen: bool = False
                  ) -> tuple[KissState, torch.Tensor, KissAux]:
    """Register one scan; returns (new state, pose, diagnostics). The
    guess is ``initial_guess`` with ``use_guess``, else the constant-
    velocity prediction from the last two poses. With ``cfg.deskew`` the
    scan is deskewed by ``deskew_twist`` when given, else by the constant-
    velocity twist (``deskew_scan``, off before two poses exist).
    ``grid_hw``: the range image's shape, for the grid front end; None
    runs the scatter-table one (``cap.dedup_table`` slots). ``update_ok``
    (scalar bool, default true) gates all state mutation through the map
    insert's inputs (empty mask, infinite eviction radius) and selects on
    the small leaves. ``map_frozen``: localisation on a prior map, which
    is left as it is; the pose, the threshold statistics and the
    diagnostics update as usual."""
    vs = cfg.resolved_voxel_size
    if cfg.deskew:
        if deskew_twist is not None:
            pts = deskew_ops.deskew_by_twist(pts, ts01 - 0.5, deskew_twist)
        else:
            pts = deskew_ops.deskew_scan(pts, ts01, state.pose_prev,
                                         state.pose, state.num_scans >= 2)
    mask = voxel.range_clip_mask(pts, mask, cfg.min_range, cfg.max_range)
    if grid_hw is not None:
        pre = voxel.window_prededup_mask(pts, mask, vs * 0.5, grid_hw)
        pre_pts, pre_mask = voxel.compact(pts, pre, cap.max_frame)
        frame_ds, frame_mask = voxel.first_in_voxel_sorted(
            pre_pts, pre_mask, vs * 0.5, cap.max_frame)
        src_pts, src_keep = voxel.first_in_voxel_sorted(
            frame_ds, frame_mask, vs * 1.5, cap.max_frame)
    else:
        frame_ds, frame_mask = voxel.voxel_downsample(
            pts, mask, vs * 0.5, cap.max_frame, cap.dedup_table)
        src_pts = frame_ds
        src_keep = voxel.first_in_voxel_mask(frame_ds, frame_mask, vs * 1.5,
                                             cap.dedup_table)
    source, source_mask = voxel.compact(src_pts, src_keep, cap.max_source,
                                        decimate_overflow=True)

    sigma = get_adaptive_threshold(state, cfg)
    if use_guess:
        guess = initial_guess.to(torch.float32)
    else:
        guess = state.pose @ prediction_model(state)
    common = dict(voxel_size=vs, max_probes=cap.max_probes,
                  max_iterations=cfg.max_iterations,
                  convergence=cfg.convergence_criterion, loss=cfg.loss,
                  plane_min_quality=cfg.plane_min_quality,
                  prior_rot_weight=cfg.prior_rot_weight,
                  prior_trans_weight=cfg.prior_trans_weight,
                  neighborhood=cfg.nn_neighborhood)
    if cfg.nn_mode == "cached":
        res = icp.register_frame_cached(
            source, source_mask, state.local_map, guess, 3.0 * sigma,
            sigma / 3.0, n_voxels=cfg.nn_voxels,
            plane_radius=cfg.plane_fit_radius,
            refresh_drift=cfg.nn_refresh_drift,
            fused_gather=cfg.fused_gather, form=cfg.icp_form, **common)
    else:
        res = icp.register_frame(
            source, source_mask, state.local_map, guess, 3.0 * sigma,
            sigma / 3.0, approx=cfg.approx_nn, **common)
    new_pose = res.pose

    err = model_error(res.dev_t, res.dev_r, cfg.max_range)
    accum = err > cfg.min_motion_th
    model_sse = state.model_sse + torch.where(accum, err * err, 0.0)
    num_samples = state.num_samples + accum.to(torch.int32)

    ok = (torch.ones((), dtype=torch.bool, device=pts.device)
          if update_ok is None else update_ok.to(torch.bool))
    if map_frozen:
        local_map = state.local_map
    else:
        evict_r2 = torch.where(
            ok, torch.full_like(sigma, cfg.max_range ** 2), math.inf)
        local_map = hashmap.insert_deduped(
            state.local_map, se3.transform(new_pose, frame_ds),
            frame_mask & ok, voxel_size=vs, max_probes=cap.max_probes,
            new_capacity=(cap.max_frame if insert_overflow is True
                          else cap.max_new_per_scan),
            overflow=insert_overflow,
            evict_origin=se3.trans(new_pose), evict_r2=evict_r2)

    def gate(new, old):
        return torch.where(ok, new, old)

    new_state = KissState(
        local_map=local_map,
        pose=gate(new_pose, state.pose),
        pose_prev=gate(state.pose, state.pose_prev),
        model_sse=gate(model_sse, state.model_sse),
        num_samples=gate(num_samples, state.num_samples),
        num_scans=gate(state.num_scans + 1, state.num_scans))
    aux = KissAux(
        sigma=sigma, err_dt=res.dev_t, err_drot=res.dev_r,
        num_corr=res.num_corr, iterations=res.iterations,
        source_count=source_mask.to(torch.int32).sum(),
        map_points=hashmap.num_points(local_map))
    return new_state, new_pose, aux


def velocity(state: KissState, dt: torch.Tensor) -> torch.Tensor:
    """Linear velocity from the last two poses (the reference's
    ``src/ptudes/kiss.py:133-140``)."""
    return se3.trans(prediction_model(state)) / torch.clamp(dt, min=1e-9)
