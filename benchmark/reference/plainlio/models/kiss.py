"""KISS-ICP-style odometry (``ptudes_tpu.models.kiss``), the path both
configurations run.

Per scan: deskew by the EKF twist -> range clip -> the front end on the
range-image grid (a window pre-dedup, compaction and two sort-based
first-in-voxel passes at 0.5 and 1.5 voxel) -> evenly decimated ICP
source -> adaptive threshold -> robust ICP with cached candidates ->
model-deviation statistics -> map insert with fused eviction.
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
                  update_ok: torch.Tensor, grid_hw: tuple[int, int],
                  initial_guess: torch.Tensor, deskew_twist: torch.Tensor,
                  insert_overflow: bool | str = True
                  ) -> tuple[KissState, torch.Tensor, KissAux]:
    """Register one scan; returns (new state, pose, diagnostics). The
    guess is ``initial_guess``; with ``cfg.deskew`` the scan is deskewed
    by ``deskew_twist``. ``grid_hw``: the range image's shape, for the
    grid front end. ``update_ok`` (scalar bool) gates all state mutation
    through the map insert's inputs (empty mask, infinite eviction radius)
    and selects on the small leaves."""
    if cfg.nn_mode != "cached":
        raise ValueError("the reference runs cached candidates, not "
                         f"nn_mode={cfg.nn_mode!r}")
    vs = cfg.resolved_voxel_size
    if cfg.deskew:
        pts = deskew_ops.deskew_by_twist(pts, ts01 - 0.5, deskew_twist)
    mask = voxel.range_clip_mask(pts, mask, cfg.min_range, cfg.max_range)
    pre = voxel.window_prededup_mask(pts, mask, vs * 0.5, grid_hw)
    pre_pts, pre_mask = voxel.compact(pts, pre, cap.max_frame)
    frame_ds, frame_mask = voxel.first_in_voxel_sorted(
        pre_pts, pre_mask, vs * 0.5, cap.max_frame)
    src_pts, src_keep = voxel.first_in_voxel_sorted(
        frame_ds, frame_mask, vs * 1.5, cap.max_frame)
    source, source_mask = voxel.compact(src_pts, src_keep, cap.max_source,
                                        decimate_overflow=True)

    sigma = get_adaptive_threshold(state, cfg)
    guess = initial_guess.to(torch.float32)
    res = icp.register_frame_cached(
        source, source_mask, state.local_map, guess, 3.0 * sigma,
        sigma / 3.0, voxel_size=vs, max_probes=cap.max_probes,
        max_iterations=cfg.max_iterations,
        convergence=cfg.convergence_criterion, loss=cfg.loss,
        plane_min_quality=cfg.plane_min_quality,
        prior_rot_weight=cfg.prior_rot_weight,
        prior_trans_weight=cfg.prior_trans_weight,
        neighborhood=cfg.nn_neighborhood, n_voxels=cfg.nn_voxels,
        plane_radius=cfg.plane_fit_radius,
        refresh_drift=cfg.nn_refresh_drift)
    new_pose = res.pose

    err = model_error(res.dev_t, res.dev_r, cfg.max_range)
    accum = err > cfg.min_motion_th
    model_sse = state.model_sse + torch.where(accum, err * err, 0.0)
    num_samples = state.num_samples + accum.to(torch.int32)

    ok = update_ok.to(torch.bool)
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
