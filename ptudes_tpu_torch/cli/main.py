"""``ptudes-tpu-torch``: the PyTorch port's command line, the commands
of ``ptudes_tpu.cli.main`` on one CUDA card.

    python -m ptudes_tpu_torch.cli.main stat REC.pcap -m META.json
    python -m ptudes_tpu_torch.cli.main ekf-bench ouster REC.pcap \\
        -m META.json --use-imu-prediction -g gt.csv \\
        [--save-map-ply MAP.ply] [--save-debug-scene DIR] [-p graphs]
    python -m ptudes_tpu_torch.cli.main ekf-bench sweep REC.pcap \\
        -m META.json -g gt.csv --bacc-z -0.1,0,0.1
    python -m ptudes_tpu_torch.cli.main ekf-bench {sim,nc,cmp} ...
    python -m ptudes_tpu_torch.cli.main flyby REC.pcap -m META.json \\
        --kitti-poses POSES.txt -o MAP.ply --camera-json CAM.json
    python -m ptudes_tpu_torch.cli.main viz REC.pcap -m META.json \\
        {--out-png F.png | --out-dir DIR | --stream-dir DIR | --serve}

The commands, flags, defaults and printed lines are the JAX command's,
written with ``argparse`` (the card's machine has no ``click``). A
recording is a pcap, a ROS1 bag, a ROS2 bag directory or a directory of
bags with its Ouster metadata JSON. Every command that computes runs on
the card unless ``--device cpu`` is given; without a card the default
raises instead of running on the CPU. On the card the LIO configuration
takes the card's kernel forms where the JAX command takes the TPU's (the
predict block as K1, the ICP kernels); on the CPU their plain PyTorch
twins (``config.twin_config``). The plots (``-p``, ``viz``'s images) need
matplotlib: without it a plot flag is refused before anything runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import GRAV
from ..config import (Capacity, EkfConfig, KissConfig, PipelineConfig,
                      twin_config)

DOWN = np.array([0.0, 0.0, -1.0])
UP = np.array([0.0, 0.0, 1.0])


class CliError(Exception):
    """A usage error the command reports (``Error: ...``, exit code 2)."""


# ---------------------------------------------------------------- sources

def _load_source(file, meta, keep_fields=False):
    from ..io.metadata import read_metadata_json, resolve_metadata
    from ..io.sources import read_packet_source

    meta_path = resolve_metadata(file, meta)
    if not meta_path:
        raise CliError("Metadata not found; specify with -m/--meta")
    info = read_metadata_json(meta_path)
    scans, imu = read_packet_source(file, info, keep_fields=keep_fields)
    return info, scans, imu, meta_path


def _need_plots(what) -> None:
    """Refuse the plot ``what`` (a flag's description; nothing when empty)
    up front where matplotlib is missing."""
    if what:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise CliError(f"{what}: plotting needs matplotlib, which is "
                           "not installed") from None


def nav_frame_lut(info, device):
    """The LUT projecting into the IMU/nav frame on ``device`` (the
    reference's extrinsics trick, ``ptudes_tpu/cli/main.py:44-58``)."""
    from ..ops.projection import make_xyz_lut

    imu_to_sensor = info.imu_to_sensor_transform.copy()
    imu_to_sensor[:3, 3] /= 1000.0
    sensor_to_imu = np.linalg.inv(imu_to_sensor)
    return make_xyz_lut(
        info.w, info.h,
        info.beam_altitude_angles, info.beam_azimuth_angles,
        info.lidar_origin_to_beam_origin_mm,
        info.lidar_to_sensor_transform,
        extrinsic=sensor_to_imu, device=device)


def _device(args) -> torch.device:
    from ..models import lio
    return lio._device(args.device)


def _kernel_forms(cfg: PipelineConfig, dev: torch.device) -> PipelineConfig:
    """``cfg`` (written with the card's forms) as it runs on ``dev``."""
    return cfg if dev.type == "cuda" else twin_config(cfg)


def _sync(out) -> None:
    """Wait for the device by reading one scalar of the last scan."""
    float(out.kiss_pose[-1, 0, 0])


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _np_log(log):
    """A ``FilterLog`` with numpy leaves (for the graphs)."""
    return type(log)(*(_np(x) for x in log))


# ------------------------------------------------------------------- stat

def cmd_stat(args):
    """Stream statistics: range/IMU mean/std + gravity estimate
    (reference ``ptudes stat``)."""
    from ..utils.stats import sequence_stats

    info, scans, imu, _ = _load_source(args.file, args.meta)
    start_scan, end_scan = args.start_scan, args.end_scan
    sel_s = np.ones(len(scans.ts), bool)
    sel_i = np.ones(len(imu.ts), bool)
    if (start_scan > 0 or end_scan is not None) and len(scans.ts):
        # scan-index windowing: IMU samples restrict to the selected scans'
        # time span, the samples interleaved with them
        idx = np.arange(len(scans.ts))
        last = len(scans.ts) - 1 if end_scan is None else end_scan
        sel_s &= (idx >= start_scan) & (idx <= last)
        if not sel_s.any():
            raise CliError(
                f"scan window [{start_scan}, {end_scan}] selects no "
                f"scans (recording has {len(scans.ts)})")
        lo = (scans.ts[start_scan - 1] if start_scan > 0 else -np.inf)
        hi = scans.ts[min(last, len(scans.ts) - 1)]
        sel_i &= (imu.ts > lo) & (imu.ts <= hi)
    if args.duration > 0 and len(scans.ts):
        t0 = min(scans.ts[0] if len(scans.ts) else np.inf,
                 imu.ts[0] if len(imu.ts) else np.inf)
        sel_s &= scans.ts <= t0 + args.duration
        sel_i &= imu.ts <= t0 + args.duration
    tracker = sequence_stats(
        scans.range_mm[sel_s], scans.ts[sel_s],
        imu.lacc[sel_i], imu.avel[sel_i], imu.ts[sel_i],
        use_beams_num=args.beams, range_unit_m=info.range_unit_m())
    print(tracker)
    print("Grav vector est: ", tracker.gravity_estimate)
    result = dict(tracker=tracker)

    if args.kiss_run and len(scans):
        from ..models import lio
        dev = _device(args)
        cfg = _kernel_forms(PipelineConfig(
            kiss=KissConfig(max_range=70.0, min_range=1.0, deskew=True,
                            icp_form="cuda"),
            cap=Capacity(max_points=info.h * info.w),
            guess="kiss"), dev)
        lut = nav_frame_lut(info, dev)
        range_m = scans.range_mm[sel_s].astype(np.float32) \
            * info.range_unit_m()
        batches = lio.build_batches(
            cfg, range_m, scans.ts[sel_s], imu.lacc[sel_i],
            imu.avel[sel_i], imu.ts[sel_i], device=dev)
        state = lio.init_state(cfg, dev)

        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg)
        _sync(out)
        t_compile_run = time.monotonic() - t0
        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg)
        _sync(out)
        dt = time.monotonic() - t0
        n = int(np.sum(sel_s))
        print(f"\nKISS run: {n} scans, {dt:.3f} s steady-state "
              f"({n / max(dt, 1e-9):.1f} scans/s; "
              f"compile {t_compile_run - dt:.1f} s)")
        result.update(kiss_poses=_np(out.kiss_pose).astype(np.float64),
                      steady_s=dt, first_s=t_compile_run)
    return result


# --------------------------------------------------------------- ekf-bench

def _run_online(cfg, lut, state, range_m, scans, imu, origin, prev_scan_ts,
                rate):
    """Scan-by-scan replay through ``LioOnline`` with per-scan latency
    percentiles; ``rate`` paces the replay against sensor time (1.0 = real
    time, 0 = as fast as possible). Each scan's latency ends with a read
    of one pose entry from the device, so it is the scan's true latency.
    Returns (final state, stacked outputs, latencies s)."""
    from ..models.online import LioOnline
    from ..utils import replicas

    odo = LioOnline(cfg, lut, state=state, time_origin=origin,
                    prev_scan_ts=prev_scan_ts)
    events = sorted(
        [(float(t), "imu", i) for i, t in enumerate(imu.ts)]
        + [(float(t), "scan", i) for i, t in enumerate(scans.ts)])
    lats = []
    outs = []
    wall0 = time.monotonic()
    ts0 = events[0][0] if events else 0.0
    for t, kind, i in events:
        if rate > 0:
            lag = (t - ts0) / rate - (time.monotonic() - wall0)
            if lag > 0:
                time.sleep(lag)
        if kind == "imu":
            odo.push_imu(imu.lacc[i], imu.avel[i], t)
        else:
            t0 = time.monotonic()
            out = odo.push_scan(range_m[i], t)
            float(out.ekf_pose[0, 0])  # block: true latency
            lats.append(time.monotonic() - t0)
            outs.append(out)
    lat = np.asarray(lats[1:]) * 1e3  # scan 0 pays the warm-up; apart
    print(f"\nOnline replay: {len(outs)} scans"
          + (f" paced at {rate:g}x sensor time" if rate > 0 else
             " (unpaced)"))
    if len(lat):
        print(f"  per-scan latency: p50 {np.percentile(lat, 50):.2f} ms, "
              f"p95 {np.percentile(lat, 95):.2f} ms, "
              f"p99 {np.percentile(lat, 99):.2f} ms, "
              f"max {lat.max():.2f} ms "
              f"(first scan incl. compile: {lats[0]:.2f} s)")
    print(f"  dropped IMU samples: {odo.n_dropped_imu}")
    return odo.state, replicas.stack(outs), lats


def build_config(args, info) -> PipelineConfig:
    """``ekf-bench ouster``'s configuration for the sensor ``info``
    (``ptudes_tpu/cli/main.py:428-452``): the guess the flags choose, the
    capacity flags with the dedup table sized to the raw point count when
    the map is sized, ``max_new_per_scan`` clamped to ``--max-frame``, and
    the kernel forms of ``args.device``."""
    guess = ("ekf" if args.use_imu_prediction
             else "gt" if args.use_gt_guess else "kiss")
    cap_kw = {k: v for k, v in (("map_capacity", args.map_capacity),
                                ("max_source", args.max_source),
                                ("max_frame", args.max_frame)) if v}
    # the scratch dedup tables scale with the raw point count, not the
    # default 128-beam assumption — a custom map size implies the user is
    # right-sizing for a smaller sensor
    if args.map_capacity:
        cap_kw["dedup_table"] = max(1 << 14, 1 << (
            int(info.h * info.w - 1).bit_length() + 1))
    if args.max_frame and args.max_frame < Capacity.max_new_per_scan:
        cap_kw["max_new_per_scan"] = args.max_frame
    cfg = PipelineConfig(
        kiss=KissConfig(max_range=args.kiss_max_range,
                        min_range=args.kiss_min_range, deskew=True,
                        loss=args.loss, voxel_size=args.voxel_size,
                        icp_form="cuda"),
        cap=Capacity(max_points=info.h * info.w, **cap_kw),
        # the JAX command runs the predict block as one TPU kernel there;
        # here as K1 on the card
        ekf=EkfConfig(predict_batch="cuda"),
        guess=guess,
        map_frozen=args.frozen_map,
    )
    return _kernel_forms(cfg, torch.device(args.device))


def cmd_ekf_ouster(args):
    """The flagship LIO loop on an Ouster recording: KISS-style ICP
    odometry + ES-EKF smoothing (reference ``ekf-bench ouster``), on the
    device."""
    from ..io.poses import (filter_nc_gt_by_close_ts, read_newer_college_gt,
                            save_poses_kitti_format, save_poses_nc_gt_format)
    from ..models import lio
    from ..ops.projection import reduce_active_beams_mask
    from ..utils.metrics import calc_ate, calc_ate_rmse
    from ..utils.trajectory import poses_for_scans

    if args.use_gt_guess and not args.gt_file:
        raise CliError("--use-gt-guess requires --gt-file")
    if args.frozen_map and not args.resume_state:
        raise CliError(
            "--frozen-map requires --resume-state (localization needs a "
            "prior map)")
    _need_plots(args.plot and f"-p {args.plot}")
    dev = _device(args)

    file, loss = args.file, args.loss
    info, scans, imu, meta_path = _load_source(file, args.meta)
    scans = scans.window(args.start_scan, args.end_scan)
    print(f"data path: {file}")
    print(f"metadata path: {meta_path}\n")
    print(f"scans: {len(scans)}, imus: {len(imu)}")
    print(f"kiss min/max: {args.kiss_min_range} - {args.kiss_max_range}")
    print(f"use-imu-prediction: {args.use_imu_prediction}, "
          f"use-gt-guess: {args.use_gt_guess}")
    print(f"sensor: {info.prod_line}, {info.mode}, loss: {loss}")

    cfg = build_config(args, info)
    guess = cfg.guess
    lut = nav_frame_lut(info, dev)

    range_m = scans.range_mm.astype(np.float32) * info.range_unit_m()
    if args.beams:
        keep = reduce_active_beams_mask(info.h, args.beams)
        range_m = range_m * keep[None, :, None]

    guess_poses = None
    gts = read_newer_college_gt(args.gt_file) if args.gt_file else []
    if args.use_gt_guess:
        gp, gvalid = poses_for_scans(scans.ts, gts, time_bounds=1.0)
        gp0 = np.linalg.inv(gp[gvalid][0]) if gvalid.any() else np.eye(4)
        guess_poses = np.einsum("ij,njk->nik", gp0, gp)

    origin = lio.time_origin(scans.ts, imu.ts)
    state = lio.init_state(cfg, dev)
    prev_scan_ts = None
    if args.resume_state:
        from ..utils.checkpoint import checkpoint_extra, load_state
        state = load_state(args.resume_state, state)
        # continue on the checkpoint's clock so the carried EKF timestamp
        # lines up with the new window's rebased times, and window IMU to
        # strictly after the checkpoint's last scan so already-integrated
        # samples are not re-fed
        extra = checkpoint_extra(args.resume_state)
        origin = extra.get("time_origin", origin)
        prev_scan_ts = extra.get("end_scan_ts")
        print(f"resumed pipeline state from {args.resume_state} "
              f"(time origin {origin:.3f})")

    n = len(scans)
    result = dict(cfg=cfg, n_scans=n)
    want_log = args.plot == "graphs"
    batches = None
    if not args.online or args.save_debug_scene:
        batches = lio.build_batches(
            cfg, range_m, scans.ts, imu.lacc, imu.avel, imu.ts,
            guess_poses=guess_poses, time_origin=origin,
            prev_scan_ts=prev_scan_ts, device=dev)
    if args.online:
        fin, out, lats = _run_online(cfg, lut, state, range_m, scans, imu,
                                     origin, prev_scan_ts, args.rate)
        result["latencies_s"] = lats
    else:
        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg,
                                    log=want_log)
        _sync(out)
        t_first = time.monotonic() - t0
        result["iterations_first"] = _np(out.aux.iterations)
        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg,
                                    log=want_log)
        _sync(out)
        t_steady = time.monotonic() - t0
        # the first run pays the kernels' build and load and the
        # allocator's warm-up; the second is the steady state
        print(f"\nTimings: {t_first:.3f} s first run "
              f"(compile {t_first - t_steady:.1f} s), "
              f"{t_steady:.3f} s steady-state")
        print(f"  per scan: {t_steady / max(n, 1) * 1e3:.2f} ms "
              f"({n / max(t_steady, 1e-9):.1f} scans/s)", end="")
        result.update(first_s=t_first, steady_s=t_steady)
    iters = _np(out.aux.iterations)
    print(f"; ICP iterations mean {iters.mean():.1f} max {iters.max()}")

    res_poses = _np(out.ekf_pose).astype(np.float64)
    kiss_poses = _np(out.kiss_pose).astype(np.float64)
    res_t = scans.ts
    result.update(ekf_poses=res_poses, kiss_poses=kiss_poses,
                  iterations=iters, state=fin)

    header = (f"ptudes-tpu-torch ekf-bench ouster {file}\n"
              f"scans: {n}, loss: {loss}, guess: {guess}")
    if args.save_kitti_poses:
        save_poses_kitti_format(args.save_kitti_poses, res_poses,
                                header=header)
        print(f"Kitti poses saved to: {args.save_kitti_poses}")
    if args.save_nc_gt_poses:
        save_poses_nc_gt_format(args.save_nc_gt_poses, res_t, res_poses,
                                header=header)
        print(f"NC GT poses saved to: {args.save_nc_gt_poses}")
    if args.save_map_ply:
        from ..viz.cloud import map_to_points, save_ply
        save_ply(args.save_map_ply, map_to_points(
            fin.kiss.local_map, cfg.kiss.resolved_voxel_size))
        print(f"Local map saved to: {args.save_map_ply}")
    if args.save_state:
        from ..utils.checkpoint import save_state
        save_state(args.save_state, fin,
                   extra={"file": str(file), "scans": int(n),
                          "end_scan_ts": float(res_t[-1]),
                          "time_origin": float(origin)})
        print(f"Pipeline state checkpoint saved to: {args.save_state}")
    if args.save_debug_scene:
        from ..viz.debug_scene import export_debug_scenes
        idx = export_debug_scenes(args.save_debug_scene, cfg, lut, batches,
                                  stride=args.debug_scene_stride)
        print(f"Debug scenes ({len(idx['knots'])} knots) saved to: "
              f"{args.save_debug_scene}")
        result["debug_scene"] = idx

    if gts:
        gts_m, res_t_m = filter_nc_gt_by_close_ts(gts, list(res_t))
        if gts_m:
            idx = np.searchsorted(res_t, res_t_m)
            gt2 = np.asarray([g[1] for g in gts_m])
            for key, name, poses_arr in [
                    ("ate_ekf", "ES EKF smoothing", res_poses[idx]),
                    ("ate_kiss", "no-EKF, only KissICP", kiss_poses[idx])]:
                ate_rot, ate_trans = calc_ate(poses_arr, gt2)
                rr, rt = calc_ate_rmse(poses_arr, gt2)
                print(f"\nGround truth comparison ({name}, "
                      f"{len(gt2)} poses):")
                print(f"ATE_rot:   {ate_rot:.04f} deg")
                print(f"ATE trans: {ate_trans:.04f} m")
                print(f"ATE RMSE:  {rr:.04f} deg / {rt:.04f} m")
                result[key] = dict(ate_rot=ate_rot, ate_trans=ate_trans,
                                   rmse_rot=rr, rmse_trans=rt)

    if args.plot == "graphs":
        from ..viz.graphs import ekf_graphs, kiss_innovation_graph
        if out.flog is not None:
            # the full figure set of the flagship mode: the IMU-rate EKF
            # grid with the KISS-only and GT trajectory overlays, then the
            # innovation / adaptive-sigma traces (online mode has no
            # IMU-rate log: the traces only)
            flog = lio.flatten_filter_log(out.flog, batches.imu_valid)
            iv = _np(batches.imu_valid).reshape(-1)
            lacc = _np(batches.imu.lacc).reshape(-1, 3)[iv]
            avel = _np(batches.imu.avel).reshape(-1, 3)[iv]
            rel_scan_t = _np(batches.scan_ts)
            gt2 = None
            if gts:
                gts_m, res_t_m = filter_nc_gt_by_close_ts(gts, list(res_t))
                if gts_m:
                    gt2 = (np.asarray(res_t_m) - res_t[0] + rel_scan_t[0],
                           np.asarray([g[1] for g in gts_m]))
            result["figures"] = [ekf_graphs(
                flog, imu_lacc=lacc, imu_avel=avel,
                gt=(rel_scan_t, kiss_poses), gt2=gt2, xy_plot=True,
                labels=["ES EKF KissICP smoothed poses",
                        "KissICP only poses", "GT poses"])]
        result.setdefault("figures", []).append(kiss_innovation_graph(
            res_t, _np(out.aux.err_dt), _np(out.aux.err_drot),
            _np(out.aux.sigma)))
    return result


def sweep_config(args, info) -> PipelineConfig:
    """``ekf-bench sweep``'s configuration (``ptudes_tpu/cli/main.py:
    642-648``): the library defaults with the range flags, the EKF guess
    and the loss; the ICP kernels on the card (K5 once a GN iteration on
    its candidate-refresh loop), the associative predict and the op-chain
    update as the JAX command runs them off the TPU."""
    cfg = PipelineConfig(
        kiss=KissConfig(max_range=args.kiss_max_range,
                        min_range=args.kiss_min_range, deskew=True,
                        loss=args.loss, icp_form="cuda"),
        cap=Capacity(max_points=info.h * info.w),
        ekf=EkfConfig(),
        guess="ekf")
    return _kernel_forms(cfg, torch.device(args.device))


def cmd_ekf_sweep(args):
    """Multi-variant LIO replay of one recording (reference ``ekf-bench
    sweep``): one variant per ``--beams`` count (a low-resolution sensor)
    or ``--bacc-z`` prior (the EKF's initial accelerometer bias z), or
    ``--replicas`` identical runs. On one card (or the CPU) the variants
    run as one program through ``parallel.batched.run_sequence_batched``,
    the counterpart of the JAX command's vmapped ``replay_bags``; with as
    many cards as variants each runs through ``lio.run_sequence`` on its
    own card (``parallel.replay.replay_bags``). Prints aggregate scans/s
    and each variant's drift and ATE."""
    from ..io.poses import filter_nc_gt_by_close_ts, read_newer_college_gt
    from ..models import lio
    from ..ops.projection import reduce_active_beams_mask
    from ..parallel import batched, replay
    from ..parallel import mesh as mesh_lib
    from ..utils.metrics import calc_ate_rmse

    chosen = [o for o in (args.beams, args.bacc_z, args.replicas) if o]
    if len(chosen) != 1:
        raise CliError("pick exactly one of --beams / --bacc-z / --replicas")
    dev = _device(args)
    info, scans, imu, _ = _load_source(args.file, args.meta)
    scans = scans.window(args.start_scan, args.end_scan)
    cfg = sweep_config(args, info)
    lut = nav_frame_lut(info, dev)
    range_m = scans.range_mm.astype(np.float32) * info.range_unit_m()

    def batches_of(rm):
        return lio.build_batches(cfg, rm, scans.ts, imu.lacc, imu.avel,
                                 imu.ts, device=dev)

    variants, batch_list, state_list = [], [], []
    if args.beams:
        for b in [int(x) for x in args.beams.split(",")]:
            keep = reduce_active_beams_mask(info.h, b)
            batch_list.append(batches_of(range_m * keep[None, :, None]))
            state_list.append(lio.init_state(cfg, dev))
            variants.append(f"beams={b}")
    elif args.bacc_z:
        base = batches_of(range_m)
        for v in [float(x) for x in args.bacc_z.split(",")]:
            batch_list.append(base)
            state_list.append(lio.init_state(
                cfg, dev, init_bacc=np.asarray([0.0, 0.0, v], np.float32)))
            variants.append(f"bacc_z={v:+.3f}")
    else:
        base = batches_of(range_m)
        for r in range(int(args.replicas)):
            batch_list.append(base)
            state_list.append(lio.init_state(cfg, dev))
            variants.append(f"replica {r}")

    nb = len(variants)
    states = replay.stack_bags(state_list)
    batches = replay.stack_bags(batch_list)
    cards = mesh_lib.default_devices() if dev.type == "cuda" else []
    ndev = max(len(cards), 1)
    grid = (mesh_lib.make_mesh(n_bags=nb, devices=cards[:nb])
            if len(cards) >= nb > 1 else None)
    shape = {"bag": nb, "pt": 1} if grid is not None else "single device"
    print(f"variants: {nb}, devices: {ndev}, mesh: {shape}")

    def replay_all():
        if grid is not None:
            return replay.replay_bags(states, batches, lut, cfg,
                                      devices=list(grid[:, 0]))
        return batched.run_sequence_batched(states, batches, lut, cfg=cfg)

    t0 = time.monotonic()
    fin, out = replay_all()
    float(out.kiss_pose[0, -1, 0, 0])
    t_first = time.monotonic() - t0
    iterations_first = _np(out.aux.iterations)
    t0 = time.monotonic()
    fin, out = replay_all()
    float(out.kiss_pose[0, -1, 0, 0])
    t_steady = time.monotonic() - t0
    n = len(scans)
    print(f"{nb} x {n} scans in {t_steady:.3f} s steady-state "
          f"({nb * n / max(t_steady, 1e-9):.1f} scans/s aggregate; "
          f"compile {t_first - t_steady:.1f} s)\n")

    gts = read_newer_college_gt(args.gt_file) if args.gt_file else []
    ekf_poses = _np(out.ekf_pose).astype(np.float64)
    kiss_poses = _np(out.kiss_pose).astype(np.float64)
    print(f"{'variant':>16s}  {'drift[m]':>9s}"
          + ("  ate_rmse[m]  kiss_rmse[m]" if gts else ""))
    gt2 = idx = None
    if gts:
        gts_m, res_t_m = filter_nc_gt_by_close_ts(gts, list(scans.ts))
        if gts_m:
            idx = np.searchsorted(scans.ts, res_t_m)
            gt2 = np.asarray([g[1] for g in gts_m])
    rows = []
    for b in range(nb):
        drift = float(np.linalg.norm(
            ekf_poses[b, -1, :3, 3] - ekf_poses[b, 0, :3, 3]))
        line = f"{variants[b]:>16s}  {drift:9.3f}"
        row = dict(variant=variants[b], drift=drift)
        if gt2 is not None:
            _, rt = calc_ate_rmse(ekf_poses[b, idx], gt2)
            _, rtk = calc_ate_rmse(kiss_poses[b, idx], gt2)
            line += f"  {rt:11.4f}  {rtk:12.4f}"
            row.update(ate_rmse=rt, kiss_rmse=rtk)
        print(line)
        rows.append(row)
    return dict(cfg=cfg, variants=variants, n_scans=n, rows=rows,
                ekf_poses=ekf_poses, kiss_poses=kiss_poses,
                iterations=_np(out.aux.iterations),
                iterations_first=iterations_first, first_s=t_first,
                steady_s=t_steady, state=fin)


def _filter_poses(log, rows=None) -> np.ndarray:
    """The history's poses [T, 4, 4] f64 (``rows``: a mask of them)."""
    from ..geom import so3

    rot = _np(so3.quat_to_mat(log.att_q))
    pos = _np(log.pos)
    if rows is not None:
        rot, pos = rot[rows], pos[rows]
    poses = np.tile(np.eye(4), (len(pos), 1, 1))
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = pos
    return poses


def cmd_ekf_sim(args):
    """EKF with simulated IMU: the noise-free twin's integration is ground
    truth for corrections (reference ``ekf-bench sim``)."""
    from ..models import esekf, sim
    from ..utils.metrics import calc_ate, calc_ate_rmse

    _need_plots(args.plot and f"-p {args.plot}")
    dev = _device(args)
    duration, freq = args.duration, args.freq
    n = int(duration * freq)
    ideal, noisy = sim.sim_imu_arrays(
        args.seed, n, freq=freq, acc_noise_std=args.acc_noise_std,
        gyr_noise_std=args.gyr_noise_std, device=dev)
    cfg = EkfConfig()
    corr_every = max(int(round(args.corr_t * freq)), 1)
    idx = torch.arange(n, device=dev)
    corr = (idx % corr_every == 0) & (idx > 0)

    _, log_gt = esekf.run_filter(
        esekf.init_state(cfg, dev), ideal,
        torch.zeros(n, dtype=torch.bool, device=dev),
        torch.eye(4, device=dev).repeat(n, 1, 1), cfg=cfg)
    gt_poses = _filter_poses(log_gt)
    _, log = esekf.run_filter(
        esekf.init_state(cfg, dev), noisy, corr,
        torch.tensor(gt_poses, dtype=torch.float32, device=dev), cfg=cfg)

    upd = _np(log.updated)
    est_poses = _filter_poses(log, upd)
    ate_rot, ate_trans = calc_ate(est_poses, gt_poses[upd])
    rmse_rot, rmse_trans = calc_ate_rmse(est_poses, gt_poses[upd])
    print(f"processed duration: {duration:0.04} s")
    print(f"updates num: {int(upd.sum())}\n")
    print(f"ATE_rot:   {ate_rot:.04f} deg")
    print(f"ATE trans: {ate_trans:.04f} m")
    print(f"ATE RMSE:  {rmse_rot:.04f} deg / {rmse_trans:.04f} m")
    result = dict(ate_rot=ate_rot, ate_trans=ate_trans, rmse_rot=rmse_rot,
                  rmse_trans=rmse_trans, updates=int(upd.sum()))
    if args.plot == "graphs":
        from ..viz.graphs import ekf_error_graphs, ekf_graphs
        result["figures"] = [
            ekf_graphs(_np_log(log), imu_lacc=_np(noisy.lacc),
                       imu_avel=_np(noisy.avel)),
            ekf_error_graphs(_np_log(log_gt), _np_log(log))]
    return result


def cmd_ekf_nc(args):
    """IMU-only EKF on Newer College bags, GT poses as corrections
    (reference ``ekf-bench nc``)."""
    from ..io.poses import read_newer_college_gt
    from ..io.sources import read_imu_bag
    from ..models import esekf
    from ..models.esekf import Imu
    from ..utils.metrics import calc_ate

    _need_plots(args.plot and f"-p {args.plot}")
    dev = _device(args)
    imu_topic = args.imu_topic
    init_grav = GRAV * UP
    if imu_topic in ["/os_cloud_node/imu", "/os_node/imu_packets"]:
        init_grav = GRAV * DOWN
    print("init_grav = ", init_grav)

    imu = read_imu_bag(args.file, imu_topic=imu_topic)
    gts = read_newer_college_gt(args.gt_file)

    t0 = imu.ts[0] + args.start_ts
    sel = imu.ts >= t0
    if args.duration > 0:
        sel &= imu.ts <= t0 + args.duration
    lacc, avel, ts = imu.lacc[sel], imu.avel[sel], imu.ts[sel]
    n = len(ts)

    # correction schedule: fire at first IMU tick past each GT knot
    gt_t = np.asarray([g[0] for g in gts])
    gt_p = np.asarray([g[1] for g in gts])
    start_knot = int(np.searchsorted(gt_t, ts[0]))
    gt_pose0 = np.linalg.inv(gt_p[min(start_knot, len(gt_p) - 1)])
    corr = np.zeros(n, bool)
    corr_poses = np.tile(np.eye(4), (n, 1, 1))
    ki = start_knot
    for i in range(n):
        if ki < len(gt_t) and ts[i] >= gt_t[ki]:
            corr[i] = True
            corr_poses[i] = gt_pose0 @ gt_p[ki]
            ki += 1

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    cfg = EkfConfig()
    imus = Imu(lacc=f32(lacc), avel=f32(avel), ts=f32(ts - ts[0]))
    _, log = esekf.run_filter(
        esekf.init_state(cfg, dev, init_grav=np.asarray(init_grav,
                                                        np.float32)),
        imus, torch.tensor(corr, device=dev), f32(corr_poses), cfg=cfg)

    upd = _np(log.updated)
    print(f"scanned duration: {ts[-1] - ts[0]:0.04} s")
    print(f"updates num: {int(upd.sum())}\n")
    result = dict(updates=int(upd.sum()))
    if upd.any():
        est = _filter_poses(log, upd)
        ate_rot, ate_trans = calc_ate(est, corr_poses[upd])
        print(f"ATE_rot:   {ate_rot:.04f} deg")
        print(f"ATE trans: {ate_trans:.04f} m")
        result.update(ate_rot=ate_rot, ate_trans=ate_trans)
    if args.plot == "graphs":
        from ..viz.graphs import ekf_graphs
        result["figures"] = [ekf_graphs(
            _np_log(log), imu_lacc=lacc, imu_avel=avel,
            xy_plot=args.xy_plot, gt=(ts[upd], corr_poses[upd]),
            labels=["ES EKF IMU + GT pose correction", "GT poses"])]
    return result


def cmd_ekf_cmp(args):
    """Compare trajectories in Newer College format (reference
    ``ekf-bench cmp``); host-side numpy, no device. ``-p graphs`` plots
    the ground truth's matched poses and each compared trajectory
    (``graphs_full``: the whole ground truth), with ``--use-gt-frame``
    each moved into the ground truth's frame at its first matched pose."""
    from ..io.poses import filter_nc_gt_by_cmp, read_newer_college_gt
    from ..utils.metrics import calc_ate

    _need_plots(args.plot and f"-p {args.plot}")
    gts_all = read_newer_college_gt(args.gt_file)
    gts, gts_cmp = [], []
    for cmp_file in args.gt_file_cmp:
        a, b = filter_nc_gt_by_cmp(gts_all, read_newer_college_gt(cmp_file))
        gts.append(a)
        gts_cmp.append(b)

    fname = lambda f: os.path.splitext(os.path.basename(f))[0]  # noqa: E731
    result = []
    for idx, cmp_file in enumerate(args.gt_file_cmp):
        a = np.asarray([p for _, p in gts[idx]])
        b = np.asarray([p for _, p in gts_cmp[idx]])
        ate_rot, ate_trans = calc_ate(a, b)
        print(f"\nTraj poses comparisons GT v. {fname(cmp_file)} "
              f"({len(a)} poses):")
        print(f"ATE_rot:   {ate_rot:.04f} deg")
        print(f"ATE trans: {ate_trans:.04f} m")
        result.append(dict(ate_rot=ate_rot, ate_trans=ate_trans))

    if args.plot in ("graphs", "graphs_full"):
        from ..viz.graphs import gt_poses_graphs
        sets = [gts_all if args.plot == "graphs_full" else
                (gts[0] if gts else gts_all)]
        for idx in range(len(gts_cmp)):
            aligned = gts_cmp[idx]
            if args.use_gt_frame and gts[idx]:
                p0 = gts[idx][0][1] @ np.linalg.inv(gts_cmp[idx][0][1])
                aligned = [(t, p0 @ p) for t, p in gts_cmp[idx]]
            sets.append(aligned)
        result.append(dict(pose_sets=sets, figure=gt_poses_graphs(
            sets, xy_plot=args.xy_plot,
            labels=[f"GT Poses: {fname(args.gt_file)}"]
            + [f"Cmp poses {i+1}: {fname(f)}"
               for i, f in enumerate(args.gt_file_cmp)])))
    return result


# ------------------------------------------------------------------ flyby

def cmd_flyby(args):
    """Build the registered map and the flyby camera program (reference
    ``ptudes flyby``; rendering is left to external viewers through the
    PLY and the camera JSON). The scans project on the device."""
    from ..io.poses import load_poses_kitti_format, read_newer_college_gt
    from ..ops.projection import scan_to_points
    from ..utils.trajectory import poses_for_scans
    from ..viz.cloud import AccumCloud, save_ply
    from ..viz.fly import Flyby

    dev = _device(args)
    info, scans, imu, _ = _load_source(args.file, args.meta)
    scans = scans.window(args.start_scan, args.end_scan)
    lut = nav_frame_lut(info, dev)
    range_unit = info.range_unit_m()

    if args.kitti_poses:
        poses = load_poses_kitti_format(args.kitti_poses)[:len(scans)]
        valid = np.ones(len(poses), bool)
    elif args.nc_gt_poses:
        gts = read_newer_college_gt(args.nc_gt_poses)
        gp0 = np.linalg.inv(gts[0][1])
        gts = [(t, gp0 @ p) for t, p in gts]  # origin shift (flyby.py:96-100)
        poses, valid = poses_for_scans(scans.ts, gts, time_bounds=1.5)
    else:
        raise CliError(
            "Provide --kitti-poses or --nc-gt-poses (or run ekf-bench "
            "ouster --save-kitti-poses first)")

    cloud = AccumCloud(max_points=args.map_points)
    for i in range(len(scans)):
        if not valid[i]:
            continue
        pts, mask, _ = scan_to_points(lut, torch.as_tensor(
            scans.range_mm[i].astype(np.float32) * range_unit, device=dev))
        p = _np(pts)[_np(mask)]
        pw = p @ poses[i][:3, :3].T + poses[i][:3, 3]
        cloud.add(pw[::4])
    save_ply(args.out_ply, cloud.points)
    print(f"map: {len(cloud)} points -> {args.out_ply}")

    traj = [(scans.ts[i], poses[i]) for i in range(len(scans)) if valid[i]]
    bbox = np.stack([cloud.points.min(0), cloud.points.max(0)], axis=1)
    fly = Flyby(traj=traj, bbox=bbox)
    print(f"flyby duration: {fly.total_duration:.1f} s")
    if args.camera_json:
        import json
        prog = []
        for t in np.arange(0, fly.total_duration, 1 / 30):
            cam = fly.camera_at(float(t))
            prog.append({"t": float(t), "target": cam.target.tolist(),
                         "pitch": cam.pitch, "yaw": cam.yaw,
                         "dolly": cam.dolly})
        with open(args.camera_json, "w") as f:
            json.dump(prog, f)
        print(f"camera program ({len(prog)} keyframes) -> "
              f"{args.camera_json}")
    return dict(points=len(cloud), duration_s=fly.total_duration)


# -------------------------------------------------------------------- viz

def cmd_viz(args):
    """Raw scan viewer (reference ``ptudes viz``): the WebGL player of the
    stream (``--serve`` / ``--stream-dir``, host-side numpy), or
    destaggered channel images as matplotlib figures, one scan
    (``--out-png`` or on screen) or the whole stream (``--out-dir``); the
    destagger runs on the device."""
    if args.serve or args.stream_dir:
        from ..viz.stream_player import export_stream, serve_dir

        info, scans, imu, _ = _load_source(args.file, args.meta,
                                           keep_fields=True)
        if not len(scans):
            raise CliError("no scans decoded")
        if args.max_scans is not None and len(scans) > args.max_scans:
            print(f"exporting first {args.max_scans} of {len(scans)} scans "
                  "(--max-scans)")
            scans = scans.window(0, args.max_scans - 1)  # end inclusive
        d = args.stream_dir or (os.path.splitext(str(args.file))[0]
                                + "_stream")
        out = export_stream(d, info, scans, rate=args.rate)
        print(f"player -> {out}")
        if args.serve:
            serve_dir(d, args.port)
        return dict(player=out)

    _need_plots("viz's images (--out-png, --out-dir or on screen; "
                "--stream-dir and --serve need no plotting)")
    import matplotlib
    if args.out_png or args.out_dir:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..ops.projection import destagger

    dev = _device(args)
    field_name = args.field_name
    info, scans, imu, _ = _load_source(args.file, args.meta,
                                       keep_fields=field_name != "range")
    print(f"scans: {len(scans)}, imus: {len(imu)}, "
          f"sensor: {info.prod_line} {info.mode}")
    if not len(scans):
        return {}
    if field_name == "range":
        channel, unit, cmap = scans.range_mm, "range (mm)", "viridis"
    else:
        if field_name not in (scans.fields or {}):
            raise CliError(
                f"field '{field_name}' not in this recording's profile "
                f"(has: range, {', '.join(sorted(scans.fields or {}))})")
        channel, unit, cmap = scans.fields[field_name], field_name, "gray"
        if field_name == "range2":
            unit, cmap = "range2 (mm)", "viridis"
    shifts = np.asarray(info.pixel_shift_by_row)

    def render(i, path=None):
        img = destagger(torch.as_tensor(channel[i].astype(np.float32),
                                        device=dev), shifts)
        plt.figure(figsize=(16, 4))
        plt.imshow(_np(img), cmap=cmap, aspect="auto")
        plt.colorbar(label=unit)
        plt.title(f"scan {i} [{field_name}]  t={scans.ts[i]:.3f}s")
        if path:
            plt.savefig(path, dpi=120, bbox_inches="tight")
            plt.close()
        else:
            plt.show()

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        idxs = range(0, len(scans), max(args.stride, 1))
        for i in idxs:
            render(i, os.path.join(args.out_dir, f"scan_{i:05d}.png"))
        print(f"exported {len(list(idxs))} frames to {args.out_dir}")
    elif args.out_png:
        render(args.scan_idx, args.out_png)
        print(f"saved {args.out_png}")
    else:
        render(args.scan_idx)
    return {}


# ------------------------------------------------------------------ parser

def _plot_flag(p, help=None) -> None:
    p.add_argument("-p", "--plot", default=None, help=help)


def _device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda: the card; "
                   "cpu runs the kernels' plain PyTorch twins)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ptudes-tpu-torch",
        description="P(oint)(e)tudes on one CUDA card: lidar-inertial "
        "odometry on Ouster recordings.")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("stat", help="stream statistics: range/IMU "
                       "mean/std + gravity estimate")
    p.add_argument("file")
    p.add_argument("-m", "--meta", default=None)
    p.add_argument("-t", "--duration", type=float, default=0.0,
                   help="Only stat the first DURATION seconds")
    p.add_argument("--beams", type=int, default=32,
                   help="Beam subsample for range stats (default 32)")
    p.add_argument("--kiss-run", action="store_true",
                   help="Also run vanilla KISS odometry for time profiling")
    p.add_argument("--start-scan", type=int, default=0,
                   help="Start scan index")
    p.add_argument("--end-scan", type=int, default=None,
                   help="End scan index, inclusive")
    _device_flag(p)
    p.set_defaults(fn=cmd_stat)

    eb = sub.add_parser("ekf-bench", help="ES EKF benchmarks and "
                        "experiments").add_subparsers(dest="bench",
                                                      required=True)
    p = eb.add_parser("sim", help="EKF with simulated IMU")
    p.add_argument("-t", "--duration", type=float, default=2.0)
    p.add_argument("-f", "--freq", type=float, default=100.0)
    p.add_argument("--corr-t", type=float, default=0.1,
                   help="Pose correction interval (s)")
    p.add_argument("--acc-noise-std", type=float, default=0.4)
    p.add_argument("--gyr-noise-std", type=float, default=0.4)
    p.add_argument("--seed", type=int, default=42)
    _plot_flag(p, "[graphs]")
    _device_flag(p)
    p.set_defaults(fn=cmd_ekf_sim)

    p = eb.add_parser("nc", help="IMU-only EKF on Newer College bags, GT "
                      "poses as corrections")
    p.add_argument("file")
    p.add_argument("-g", "--gt-file", required=True)
    p.add_argument("-t", "--duration", type=float, default=0.0)
    p.add_argument("--start-ts", type=float, default=0.0)
    p.add_argument("-i", "--imu-topic", default="/os_node/imu_packets")
    _plot_flag(p)
    p.add_argument("--xy-plot", action="store_true")
    _device_flag(p)
    p.set_defaults(fn=cmd_ekf_nc)

    p = eb.add_parser("ouster", help="the flagship LIO loop on an Ouster "
                      "recording")
    p.add_argument("file")
    p.add_argument("-m", "--meta", default=None)
    p.add_argument("--start-scan", type=int, default=0)
    p.add_argument("--end-scan", type=int, default=None)
    p.add_argument("--use-imu-prediction", action="store_true",
                   help="EKF pose prediction as the ICP guess (loosely "
                   "coupled LIO)")
    p.add_argument("--use-gt-guess", action="store_true",
                   help="GT pose as ICP guess (sanity testing)")
    p.add_argument("-g", "--gt-file", default=None)
    p.add_argument("--kiss-min-range", type=float, default=1.0)
    p.add_argument("--kiss-max-range", type=float, default=70.0)
    p.add_argument("--beams", type=int, default=0)
    p.add_argument("--loss", choices=["plane", "point"], default="plane")
    p.add_argument("--save-kitti-poses", default=None)
    p.add_argument("--save-nc-gt-poses", default=None)
    p.add_argument("--save-map-ply", default=None,
                   help="Export the final local map as PLY")
    p.add_argument("--save-debug-scene", default=None,
                   help="Export per-update EKF debug scenes (PLY+JSON) to "
                   "DIR (replaces the reference's 3D ekf_viz debug viewer)")
    p.add_argument("--debug-scene-stride", type=int, default=5)
    p.add_argument("--save-state", default=None,
                   help="Checkpoint the final pipeline state (voxel map + "
                   "EKF + covariance) to FILE.npz; resume with "
                   "--resume-state")
    p.add_argument("--resume-state", default=None,
                   help="Start from a state checkpoint instead of a fresh "
                   "state (continue a windowed run)")
    p.add_argument("--frozen-map", action="store_true",
                   help="Localization-only mode: register against the "
                   "resumed checkpoint's map WITHOUT modifying it. "
                   "Requires --resume-state")
    p.add_argument("--online", action="store_true",
                   help="Drive the streaming LioOnline scan by scan, "
                   "per-scan latency p50/p95/p99 printed")
    p.add_argument("--rate", type=float, default=0.0,
                   help="With --online: replay pacing, 1.0 = sensor real "
                   "time; 0 = as fast as possible")
    p.add_argument("--voxel-size", type=float, default=None,
                   help="Map voxel size in meters (default max_range/100)")
    p.add_argument("--map-capacity", type=int, default=None,
                   help="Voxel hash slots (power of two; default 2^19)")
    p.add_argument("--max-source", type=int, default=None,
                   help="ICP source point capacity (default 8192)")
    p.add_argument("--max-frame", type=int, default=None,
                   help="Downsampled frame (map insert) capacity "
                   "(default 32768)")
    _plot_flag(p)
    _device_flag(p)
    p.set_defaults(fn=cmd_ekf_ouster)

    p = eb.add_parser("sweep", help="multi-variant LIO replay of one "
                      "recording: beam counts, accel-bias priors or "
                      "identical replicas")
    p.add_argument("file")
    p.add_argument("-m", "--meta", default=None)
    p.add_argument("--start-scan", type=int, default=0)
    p.add_argument("--end-scan", type=int, default=None)
    p.add_argument("-g", "--gt-file", default=None)
    p.add_argument("--kiss-min-range", type=float, default=1.0)
    p.add_argument("--kiss-max-range", type=float, default=70.0)
    p.add_argument("--loss", choices=["plane", "point"], default="plane")
    p.add_argument("--beams", default=None,
                   help="Comma list of active-beam counts, one LIO variant "
                   "per entry (low-res sensor simulation), e.g. "
                   "128,64,32,16")
    p.add_argument("--bacc-z", default=None,
                   help="Comma list of initial accel-bias-z hypotheses "
                   "(m/s^2), one EKF variant per entry, e.g. "
                   "-0.2,-0.1,0,0.1,0.2")
    p.add_argument("--replicas", type=int, default=None,
                   help="No parameter sweep: run N identical replicas "
                   "(data-parallel throughput check)")
    _device_flag(p)
    p.set_defaults(fn=cmd_ekf_sweep)

    p = eb.add_parser("cmp", help="compare trajectories in Newer College "
                      "format")
    p.add_argument("gt_file")
    p.add_argument("gt_file_cmp", nargs="*")
    _plot_flag(p)
    p.add_argument("--use-gt-frame", action="store_true")
    p.add_argument("--xy-plot", action="store_true")
    p.set_defaults(fn=cmd_ekf_cmp)

    p = sub.add_parser("flyby", help="the registered map and a flyby "
                       "camera program")
    p.add_argument("file")
    p.add_argument("-m", "--meta", default=None)
    p.add_argument("--kitti-poses", default=None)
    p.add_argument("--nc-gt-poses", default=None)
    p.add_argument("--start-scan", type=int, default=0)
    p.add_argument("--end-scan", type=int, default=None)
    p.add_argument("-o", "--out-ply", default="flyby_map.ply")
    p.add_argument("--camera-json", default=None,
                   help="Export the flyby camera program as JSON")
    p.add_argument("--map-points", type=int, default=1_500_000)
    _device_flag(p)
    p.set_defaults(fn=cmd_flyby)

    p = sub.add_parser("viz", help="raw scan viewer: the WebGL stream "
                       "player, or destaggered channel images")
    p.add_argument("file")
    p.add_argument("-m", "--meta", default=None)
    p.add_argument("--scan", dest="scan_idx", type=int, default=0)
    p.add_argument("-o", "--out-png", default=None)
    p.add_argument("--out-dir", default=None,
                   help="Export the WHOLE stream as PNG frames")
    p.add_argument("--stride", type=int, default=1,
                   help="Export every Nth scan with --out-dir")
    p.add_argument("--field", dest="field_name", default="range",
                   choices=["range", "reflectivity", "signal", "nearir",
                            "range2", "reflectivity2", "signal2"],
                   help="Channel to render (dual-return *2 channels need a "
                   "DUAL/FUSA profile recording)")
    p.add_argument("--serve", action="store_true",
                   help="LIVE playback: export the stream and serve the "
                   "inline-WebGL player")
    p.add_argument("--stream-dir", default=None,
                   help="Export the WebGL player + stream blobs here "
                   "without serving")
    p.add_argument("--port", type=int, default=8126, help="--serve port")
    p.add_argument("-r", "--rate", type=float, default=1.0,
                   help="Initial playback rate for --serve/--stream-dir; 0 "
                   "starts paused")
    p.add_argument("--max-scans", type=int, default=None,
                   help="--serve/--stream-dir: export at most N scans")
    _device_flag(p)
    p.set_defaults(fn=cmd_viz)
    return ap


def _check_files(args) -> None:
    """The JAX command's ``click.Path(exists=True)`` checks."""
    for name in ("file", "meta", "gt_file", "resume_state", "kitti_poses",
                 "nc_gt_poses"):
        path = getattr(args, name, None)
        if path is not None and not os.path.exists(path):
            raise CliError(f"Path '{path}' does not exist.")
    for path in getattr(args, "gt_file_cmp", None) or ():
        if not os.path.exists(path):
            raise CliError(f"Path '{path}' does not exist.")


def run(argv=None):
    """Parse ``argv`` and run its command; returns the command's results
    (the numbers it printed, its poses) for callers in Python."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for i in range(len(argv) - 1):
        # a value list that starts with a minus ("--bacc-z -0.1,0,0.1",
        # as the JAX command takes it) is the option's value
        if argv[i] == "--bacc-z" and argv[i + 1].startswith("-"):
            argv[i:i + 2] = [f"--bacc-z={argv[i + 1]}", ""]
    args = build_parser().parse_args([a for a in argv if a != ""])
    _check_files(args)
    return args.fn(args)


def main(argv=None) -> int:
    try:
        run(argv)
    except CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
