"""Replica-fused multi-sequence replay on one card
(``ptudes_tpu.parallel.batched``).

B independent LIO sequences run as one: their maps live in one flat hash
table (``hashmap.create_batched``, replica b in slots [b * C, (b + 1) *
C)), and each scan is one batched step over all replicas followed by one
map insert and eviction over the whole table. The step gives every stage
an explicit leading replica axis (the JAX package vmaps the single step;
``torch.func.vmap`` stops at the step's in-place ops): the front end sorts
and compacts each replica's row in the same launches, one candidate gather
covers all replicas' points, and each kernel on the path launches once for
all replicas, as a ``pallas_call`` under ``jax.vmap`` gains a grid axis:
K1 predict and K2 pose update once a scan, K3 candidate prep and K4 GN
loop once a scan with frozen candidates, K5 once a GN iteration in the
candidate-refresh loop (whose replicas that have converged take no work in
it). So a scan costs about the same number of launches at any B. The
frozen-candidate step never reads the card from the host; the refresh loop
reads all replicas' flags once a GN iteration (``icp.read_flags``).

It runs every configuration the JAX package's batched driver runs
(:func:`check_config`): either candidate form, every predict form (K1, its
unrolled twin, the associative form), the EKF, ground-truth and
constant-velocity guesses, either deskew. Like JAX's it refuses a frozen
map and a map query every GN iteration.
"""
from __future__ import annotations

import torch

from ..config import PipelineConfig, check_supported
from ..models import esekf, kiss, lio
from ..ops import hashmap
from ..ops.projection import XyzLut, scan_to_points


def check_config(cfg: PipelineConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is one the batched driver runs:
    every configuration but the two the JAX package's batched driver
    refuses, ``nn_mode="every"`` (its flat-map step asserts cached
    candidates, ``ptudes_tpu/models/kiss.py:160-167``) and ``map_frozen``
    (``ptudes_tpu/parallel/batched.py:69-74``). With a slot base the fused
    gather flag takes the gather and K3 in place of K6, as in the JAX
    package."""
    check_supported(cfg)
    if cfg.kiss.nn_mode != "cached":
        raise ValueError(
            "run_sequence_batched does not run nn_mode='every' (a map query "
            "every GN iteration): the JAX package's flat-map step asserts "
            "cached candidates (ptudes_tpu/models/kiss.py:160-167); run such "
            "sequences through lio.run_sequence or "
            "parallel.replay.replay_bags")
    if cfg.map_frozen:
        raise ValueError(
            "run_sequence_batched does not run map_frozen: its flat table "
            "always defers the map insert, and the JAX package's batched "
            "driver refuses it too (ptudes_tpu/parallel/batched.py:69-74); "
            "run frozen-map sequences through lio.run_sequence or "
            "parallel.replay.replay_bags")


def scan_of(batches: lio.ScanBatch, i: int) -> lio.ScanBatch:
    """Scan ``i`` of every replica of stacked [B, N, ...] batches."""
    return lio.ScanBatch(
        batches.range_m[:, i], batches.scan_ts[:, i],
        esekf.Imu(*(x[:, i] for x in batches.imu)),
        batches.imu_valid[:, i], batches.guess_pose[:, i])


def make_batched_step(lut: XyzLut, cfg: PipelineConfig, replicas: int,
                      logical_capacity: int,
                      insert_overflow: bool | str = True, log: bool = False):
    """The scan step of ``replicas`` sequences: (state, one scan of every
    replica) -> (state, packed rows [B, 70]) and with ``log`` the scans'
    histories [B, K]. The state's leaves are stacked [B, ...] and its map
    is the flat table of ``replicas`` x ``logical_capacity`` slots; the
    step inserts and evicts all replicas' frames in it (``insert_overflow``
    as in ``lio.make_scan_step``). The guess and the deskew twist are
    picked as ``lio.make_scan_step`` picks them."""
    check_config(cfg)
    h, w = lut.direction.shape[:2]
    d = cfg.col_decimation
    need_twist = cfg.deskew_mode == "ekf" and cfg.kiss.deskew
    vs = cfg.kiss.resolved_voxel_size
    slot_base = torch.arange(replicas, dtype=torch.int32,
                             device=lut.direction.device) * logical_capacity
    new_capacity = (cfg.cap.max_frame if insert_overflow is True
                    else cfg.cap.max_new_per_scan)

    def step(state: lio.LioState, batch: lio.ScanBatch):
        res = esekf.process_imu_batch(
            state.ekf, batch.imu, batch.imu_valid, cfg=cfg.ekf,
            want_twist=need_twist, log=log)
        res = res if need_twist or log else (res,)
        ekf1 = res[0]
        pts, mask, ts01 = scan_to_points(lut, batch.range_m, decimate=d)
        has_imu = torch.any(batch.imu_valid, -1)
        guess = None                          # "kiss": constant velocity
        if cfg.guess == "ekf":
            guess = esekf.pose_mat(ekf1)
        elif cfg.guess == "gt":
            guess = batch.guess_pose
        kiss1, pose, aux, dfr = kiss.register_scan_batched(
            state.kiss, pts, mask, ts01, cfg=cfg.kiss, cap=cfg.cap,
            grid_hw=(h, w // d), initial_guess=guess,
            use_guess=guess is not None, update_ok=has_imu,
            slot_base=slot_base, logical_capacity=logical_capacity,
            deskew_twist=res[1] if need_twist else None)
        flat = hashmap.insert_deduped_batched(
            state.kiss.local_map, dfr.frame_w, dfr.mask, voxel_size=vs,
            max_probes=cfg.cap.max_probes, new_capacity=new_capacity,
            overflow=insert_overflow, logical_capacity=logical_capacity)
        flat = hashmap.remove_far_batched(
            flat, dfr.origin, dfr.evict_r2,
            logical_capacity=logical_capacity)
        aux = aux._replace(map_points=hashmap.replica_points(flat, replicas))
        ekf2 = esekf.process_pose(ekf1, pose, cfg=cfg.ekf)
        ekf_out = esekf.masked_update(ekf1, ekf2, has_imu)
        out = lio.LioOut(
            kiss_pose=torch.where(has_imu[:, None, None], pose,
                                  state.kiss.pose),
            ekf_pose=esekf.pose_mat(ekf_out), scan_valid=has_imu,
            ekf_vel=ekf_out.vel, ekf_bias_gyr=ekf_out.bias_gyr,
            ekf_bias_acc=ekf_out.bias_acc, ekf_grav=ekf_out.grav,
            ekf_cov_diag=torch.diagonal(ekf_out.cov, 0, -2, -1), aux=aux)
        new_state = lio.LioState(kiss=kiss1._replace(local_map=flat),
                                 ekf=ekf_out)
        if log:
            return new_state, lio._pack_out(out), lio._fold_knot(
                res[-1], batch.imu_valid, has_imu, ekf_out)
        return new_state, lio._pack_out(out)

    return step


def run_sequence_batched(states: lio.LioState, batches: lio.ScanBatch,
                         lut: XyzLut, *, cfg: PipelineConfig,
                         log: bool = False
                         ) -> tuple[lio.LioState, lio.LioOut]:
    """B replicas through the batched step with one flat map table: the
    contract of ``ptudes_tpu.parallel.batched.run_sequence_batched``.

    ``states``: stacked [B, ...] (``replay.stack_bags`` of ``lio.init_state``
    results; each map [B, C, ...]); ``batches``: stacked [B, N, ...]. The
    first ``cfg.bootstrap_scans`` scans insert the whole frame, the rest
    take ``cfg.steady_insert_mode`` (budget and decimation per replica).
    Returns the final states, each map a [B, C, ...] view of the flat
    table, and the outputs [B, N, ...] (``map_points`` counted after each
    scan's insert); ``log=True`` adds the histories [B, N, K]."""
    check_config(cfg)
    b, c = states.kiss.local_map.meta.shape[:2]
    ppv = states.kiss.local_map.points.shape[-1]
    n = batches.range_m.shape[1]
    flat = hashmap.VoxelHashMap(
        meta=states.kiss.local_map.meta.reshape(b * c, hashmap.META_W),
        points=states.kiss.local_map.points.reshape(b * c, ppv))
    state = states._replace(kiss=states.kiss._replace(local_map=flat))
    k = n if cfg.bootstrap_scans < 0 else min(cfg.bootstrap_scans, n)
    steady = make_batched_step(lut, cfg, b, c,
                               insert_overflow=cfg.steady_insert_mode,
                               log=log)
    boot = make_batched_step(lut, cfg, b, c, insert_overflow=True,
                             log=log) if k else steady
    rows, logs = [], []
    for i in range(n):
        state, row, *flog = (boot if i < k else steady)(state,
                                                        scan_of(batches, i))
        rows.append(row)
        logs += flog
    out = lio.unpack_out(torch.stack(rows, 1))
    if log:
        out = out._replace(flog=esekf.FilterLog(
            *(torch.stack(x, 1) for x in zip(*logs))))
    m = state.kiss.local_map
    fin = state._replace(kiss=state.kiss._replace(
        local_map=hashmap.VoxelHashMap(
            meta=m.meta.reshape(b, c, hashmap.META_W),
            points=m.points.reshape(b, c, ppv))))
    return fin, out
