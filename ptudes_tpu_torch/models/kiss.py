"""KISS-ICP-style odometry (``ptudes_tpu.models.kiss``).

Per scan: deskew (by the EKF twist, or KISS's constant velocity) -> range
clip -> the front end: on the range-image grid, a window pre-dedup,
compaction and two sort-based first-in-voxel passes (0.5 and 1.5 voxel;
with ``icp_form="cuda"`` the pre-dedup is K8 and the sort keys K9);
without a grid, two scatter-table first-in-voxel passes with compaction ->
evenly decimated ICP source -> adaptive threshold -> robust ICP
(cached candidates, or a map query every iteration) -> model-deviation
statistics -> map insert with fused eviction (none on a frozen map). Every
stage has a static shape; run op by op, the step synchronises with the
host only in the ICP's candidate-refresh loop and in the every-iteration
query loop (one read per GN iteration, ``icp.read_flags``), never with
frozen candidates; inside a graph runner those loops are conditional
nodes and it never does (``models.graph``).

:func:`register_scan_batched` registers B replicas' scans in the launches
of one: the front end with a leading replica axis, one candidate gather of
all replicas' points from the flat B-map table, K3 and K4 (frozen
candidates) or K5 (the refresh loop) with a replica axis; the map insert
is left to the caller (:class:`DeferredInsert`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import Capacity, KissConfig
from ..geom import se3
from ..ops import deskew as deskew_ops
from ..ops import hashmap, icp, voxel
from . import graph as graph_mod


class KissState(NamedTuple):
    local_map: hashmap.VoxelHashMap
    pose: torch.Tensor         # [4, 4] T_{k-1}
    pose_prev: torch.Tensor    # [4, 4] T_{k-2}
    model_sse: torch.Tensor    # [] f32
    num_samples: torch.Tensor  # [] int32
    num_scans: torch.Tensor    # [] int32


class DeferredInsert(NamedTuple):
    """The map update ``register_scan(defer_insert=True)`` leaves to its
    caller (the batched driver runs it once for all replicas)."""
    frame_w: torch.Tensor   # [F, 3] world-frame insert candidates
    mask: torch.Tensor      # [F] bool, already gated by update_ok
    origin: torch.Tensor    # [3] eviction centre: the new pose's origin
    evict_r2: torch.Tensor  # [] squared eviction radius (inf when gated)


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


def check_point_sharding(cfg: KissConfig, cap: Capacity, n_pt: int) -> None:
    """Raise ``ValueError`` unless a registration can be point-sharded over
    ``n_pt`` ranks: cached candidates and ``cap.max_source`` a multiple of
    ``n_pt`` (``ptudes_tpu/parallel/sharded.py:51-52``,
    ``ptudes_tpu/models/kiss.py:157-159``)."""
    if cfg.nn_mode != "cached":
        raise ValueError("point-sharded registration needs nn_mode='cached', "
                         f"not {cfg.nn_mode!r}")
    if n_pt < 1 or cap.max_source % n_pt:
        raise ValueError(f"max_source={cap.max_source} not divisible by "
                         f"pt={n_pt}")


def register_scan(state: KissState, pts: torch.Tensor, mask: torch.Tensor,
                  ts01: torch.Tensor, *, cfg: KissConfig, cap: Capacity,
                  update_ok: torch.Tensor | None = None,
                  grid_hw: tuple[int, int] | None = None,
                  initial_guess: torch.Tensor | None = None,
                  use_guess: bool = False,
                  deskew_twist: torch.Tensor | None = None,
                  insert_overflow: bool | str = True,
                  map_frozen: bool = False,
                  defer_insert: bool = False,
                  map_slot_base: torch.Tensor | None = None,
                  map_logical_capacity: int | None = None,
                  group=None
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
    diagnostics update as usual.

    ``defer_insert``: the map is left as it is and the insert comes back as
    a fourth result, a :class:`DeferredInsert`. ``map_slot_base`` /
    ``map_logical_capacity`` (with ``defer_insert`` and cached candidates):
    ``state.local_map`` is a flat B-map table and this scan's candidates
    come from its replica's slots (``icp.gather_candidates``).

    ``group`` (a ``torch.distributed`` process group): the point-sharded
    registration. Every stage runs on every rank on the same inputs; after
    the compaction each rank takes its slice of ``cap.max_source / world``
    source points by its rank, and the ICP sums the GN system over the
    ranks (``icp.register_frame_cached``), so every rank returns the same
    pose. :func:`check_point_sharding` holds for ``group``'s size."""
    vs = cfg.resolved_voxel_size
    if group is not None:
        check_point_sharding(cfg, cap, dist.get_world_size(group))
    if map_frozen and defer_insert:
        raise ValueError(
            "map_frozen with defer_insert: a frozen map has no insert to "
            "defer (run frozen-map sequences through lio.run_sequence)")
    if map_slot_base is not None and not (
            defer_insert and cfg.nn_mode == "cached"
            and map_logical_capacity is not None):
        raise ValueError("a flat-map slot base needs defer_insert, cached "
                         "candidates and map_logical_capacity")
    if cfg.deskew:
        if deskew_twist is not None:
            pts = deskew_ops.deskew_by_twist(pts, ts01 - 0.5, deskew_twist)
        else:
            pts = deskew_ops.deskew_scan(pts, ts01, state.pose_prev,
                                         state.pose, state.num_scans >= 2)
    mask = voxel.range_clip_mask(pts, mask, cfg.min_range, cfg.max_range)
    if grid_hw is not None:
        pre = voxel.window_prededup_mask(pts, mask, vs * 0.5, grid_hw,
                                         form=cfg.icp_form)
        pre_pts, pre_mask = voxel.compact(pts, pre, cap.max_frame)
        frame_ds, frame_mask = voxel.first_in_voxel_sorted(
            pre_pts, pre_mask, vs * 0.5, cap.max_frame, form=cfg.icp_form)
        src_pts, src_keep = voxel.first_in_voxel_sorted(
            frame_ds, frame_mask, vs * 1.5, cap.max_frame, form=cfg.icp_form)
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
    graph_mod.stage("icp")
    if cfg.nn_mode == "cached":
        src_icp, mask_icp = source, source_mask
        if group is not None:
            # this rank's slice of the replicated, identically compacted
            # source (ptudes_tpu/models/kiss.py:238-243)
            shard = cap.max_source // dist.get_world_size(group)
            lo = dist.get_rank(group) * shard
            src_icp = source[lo:lo + shard]
            mask_icp = source_mask[lo:lo + shard]
        res = icp.register_frame_cached(
            src_icp, mask_icp, state.local_map, guess, 3.0 * sigma,
            sigma / 3.0, n_voxels=cfg.nn_voxels,
            plane_radius=cfg.plane_fit_radius,
            refresh_drift=cfg.nn_refresh_drift,
            fused_gather=cfg.fused_gather, form=cfg.icp_form,
            slot_base=map_slot_base, logical_capacity=map_logical_capacity,
            group=group, **common)
    else:
        res = icp.register_frame(
            source, source_mask, state.local_map, guess, 3.0 * sigma,
            sigma / 3.0, approx=cfg.approx_nn, **common)
    new_pose = res.pose
    graph_mod.stage("map.insert")

    err = model_error(res.dev_t, res.dev_r, cfg.max_range)
    accum = err > cfg.min_motion_th
    model_sse = state.model_sse + torch.where(accum, err * err, 0.0)
    num_samples = state.num_samples + accum.to(torch.int32)

    ok = (torch.ones((), dtype=torch.bool, device=pts.device)
          if update_ok is None else update_ok.to(torch.bool))
    if not map_frozen:
        evict_r2 = torch.where(
            ok, torch.full_like(sigma, cfg.max_range ** 2), math.inf)
    if map_frozen or defer_insert:
        local_map = state.local_map
    else:
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
    if defer_insert:
        return new_state, new_pose, aux, DeferredInsert(
            se3.transform(new_pose, frame_ds), frame_mask & ok,
            se3.trans(new_pose), evict_r2)
    return new_state, new_pose, aux


def register_scan_batched(state: KissState, pts: torch.Tensor,
                          mask: torch.Tensor, ts01: torch.Tensor, *,
                          cfg: KissConfig, cap: Capacity,
                          grid_hw: tuple[int, int],
                          update_ok: torch.Tensor,
                          slot_base: torch.Tensor, logical_capacity: int,
                          initial_guess: torch.Tensor | None = None,
                          use_guess: bool = False,
                          deskew_twist: torch.Tensor | None = None
                          ) -> tuple[KissState, torch.Tensor, KissAux,
                                     DeferredInsert]:
    """:func:`register_scan` of B replicas at once, with the grid front
    end, cached candidates and ``defer_insert``: ``state``'s leaves [B,
    ...] (its ``local_map`` the flat B-map table, replica b at
    ``slot_base[b]``), ``pts`` [B, N, 3], ``mask`` and ``ts01`` [B, N],
    ``update_ok`` [B]. The guess and the deskew follow
    :func:`register_scan`'s rules: guesses [B, 4, 4] with ``use_guess``,
    else each replica's constant-velocity prediction; with ``cfg.deskew``
    the twists [B, 6] when given, else KISS's constant-velocity deskew,
    on for a replica from its third scan. Frozen candidates run K3 and K4
    with a replica axis (:func:`icp.register_frames_cached_batched`); the
    candidate-refresh loop (``cfg.nn_refresh_drift > 0``) runs K5 with a
    replica axis (:func:`icp.register_frames_refresh_batched`). Every stage
    runs once for all replicas; the results carry the leading [B]. The
    deferred insert's ``frame_w`` is [B, F, 3], ready for
    ``hashmap.insert_deduped_batched``."""
    if cfg.nn_mode != "cached":
        raise ValueError("register_scan_batched runs cached candidates "
                         f"only, not nn_mode={cfg.nn_mode!r}")
    vs = cfg.resolved_voxel_size
    b = mask.shape[0]
    if cfg.deskew:
        if deskew_twist is not None:
            pts = deskew_ops.deskew_by_twist(pts, ts01 - 0.5, deskew_twist)
        else:
            pts = deskew_ops.deskew_scan(pts, ts01, state.pose_prev,
                                         state.pose, state.num_scans >= 2)
    mask = voxel.range_clip_mask(pts, mask, cfg.min_range, cfg.max_range)
    pre = voxel.window_prededup_mask(pts, mask, vs * 0.5, grid_hw,
                                     form=cfg.icp_form)
    pre_pts, pre_mask = voxel.compact(pts, pre, cap.max_frame)
    frame_ds, frame_mask = voxel.first_in_voxel_sorted(
        pre_pts, pre_mask, vs * 0.5, cap.max_frame, form=cfg.icp_form)
    src_pts, src_keep = voxel.first_in_voxel_sorted(
        frame_ds, frame_mask, vs * 1.5, cap.max_frame, form=cfg.icp_form)
    source, source_mask = voxel.compact(src_pts, src_keep, cap.max_source,
                                        decimate_overflow=True)

    sigma = get_adaptive_threshold(state, cfg)
    if use_guess:
        guess = initial_guess.to(torch.float32)
    else:
        guess = state.pose @ prediction_model(state)
    common = dict(
        slot_base=slot_base, logical_capacity=logical_capacity,
        voxel_size=vs, max_probes=cap.max_probes,
        max_iterations=cfg.max_iterations,
        convergence=cfg.convergence_criterion, loss=cfg.loss,
        plane_min_quality=cfg.plane_min_quality,
        prior_rot_weight=cfg.prior_rot_weight,
        prior_trans_weight=cfg.prior_trans_weight,
        neighborhood=cfg.nn_neighborhood, n_voxels=cfg.nn_voxels,
        plane_radius=cfg.plane_fit_radius, form=cfg.icp_form)
    graph_mod.stage("icp")
    if cfg.nn_refresh_drift > 0.0:
        res = icp.register_frames_refresh_batched(
            source, source_mask, state.local_map, guess, 3.0 * sigma,
            sigma / 3.0, refresh_drift=cfg.nn_refresh_drift, **common)
    else:
        res = icp.register_frames_cached_batched(
            source, source_mask, state.local_map, guess, 3.0 * sigma,
            sigma / 3.0, **common)
    new_pose = res.pose
    graph_mod.stage("map.insert")

    err = model_error(res.dev_t, res.dev_r, cfg.max_range)
    accum = err > cfg.min_motion_th
    model_sse = state.model_sse + torch.where(accum, err * err, 0.0)
    num_samples = state.num_samples + accum.to(torch.int32)
    ok = update_ok.to(torch.bool)
    evict_r2 = torch.where(
        ok, torch.full_like(sigma, cfg.max_range ** 2), math.inf)

    def gate(new, old):
        return torch.where(ok.reshape((b,) + (1,) * (new.dim() - 1)), new,
                           old)

    new_state = KissState(
        local_map=state.local_map,
        pose=gate(new_pose, state.pose),
        pose_prev=gate(state.pose, state.pose_prev),
        model_sse=gate(model_sse, state.model_sse),
        num_samples=gate(num_samples, state.num_samples),
        num_scans=gate(state.num_scans + 1, state.num_scans))
    aux = KissAux(
        sigma=sigma, err_dt=res.dev_t, err_drot=res.dev_r,
        num_corr=res.num_corr, iterations=res.iterations,
        source_count=source_mask.to(torch.int32).sum(-1),
        map_points=hashmap.replica_points(state.local_map, b))
    return new_state, new_pose, aux, DeferredInsert(
        se3.transform(new_pose, frame_ds), frame_mask & ok[:, None],
        se3.trans(new_pose), evict_r2)


def velocity(state: KissState, dt: torch.Tensor) -> torch.Tensor:
    """Linear velocity from the last two poses (the reference's
    ``src/ptudes/kiss.py:133-140``)."""
    return se3.trans(prediction_model(state)) / torch.clamp(dt, min=1e-9)
