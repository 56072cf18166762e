"""Where the time of the PyTorch port's steady scan step goes, on one CUDA
card: ``torch.profiler`` over steady scans of the bench scene at
``bench_config()`` (``--config bench``), at the same with
``fused_gather=True`` (``--config bench_fused``: K6, the one kernel
``gather_fused``, in place of the gather and K3), at the flagship
command's ``cli_config(128, 1024)`` (``--config cli``), at the command
with no guess flag, ``cli_config(128, 1024, guess="kiss")`` (``cli_kiss``;
``cli_kiss_assoc`` with the associative predict, ``stat --kiss-run``'s EKF)
or at ``bench_config()`` with the filter log (``bench_log``: K1 writing
the history). Several configurations profile one after another in one
process, so their numbers compare on one card and host. The ``cli_kiss``
windows end with the scans ``tests/data/cli_kiss_jax_poses.txt`` holds (15:
the JAX run with that guess leaves the track after them), so they hold at
most 8 scans.

    python3 tools/profile_torch_path.py [--config bench|bench_fused|cli|
        cli_kiss|cli_kiss_assoc|bench_log [...]] [--scans 20] [--json PATH]

Prints per configuration (and with ``--json`` also writes as JSON, a list
with one summary per configuration): wall time per scan
(host clock around scans ending in a synchronize), device busy time per
scan (the union of kernel intervals in the trace) and the idle share, the
kernel launches per scan, the refresh loop's host reads and re-gathers
per scan, each hand kernel's device time and launches per scan, the mean
GN iterations per scan (``LioOut.aux``) and the GN kernels' (K4, K5)
device time per iteration, and the top operators and kernels by device
time; for ``bench`` also K3's and K2's wrappers alone at the bench
path's shapes, their kernels and glue launches apart, with their twins'
call times (``wrappers``). Runs the bootstrap scans and a warm-up before
the profiled window.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import busy_us  # noqa: E402


def make_config(name: str, h: int, w: int):
    from ptudes_tpu_torch import config

    if name == "cli":
        return config.cli_config(h, w)
    if name.startswith("cli_kiss"):
        cfg = config.cli_config(h, w, guess="kiss")
        if name == "cli_kiss_assoc":
            cfg = dataclasses.replace(cfg, ekf=dataclasses.replace(
                cfg.ekf, predict_batch="assoc"))
        return cfg
    cfg = config.bench_config()
    if name == "bench_fused":
        cfg = dataclasses.replace(cfg, kiss=dataclasses.replace(
            cfg.kiss, fused_gather=True))
    return cfg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("bench", "bench_fused", "cli",
                                          "cli_kiss", "cli_kiss_assoc",
                                          "bench_log"),
                    nargs="+", default=["bench"],
                    help="bench_config(), the same with fused_gather=True, "
                         "cli_config(128, 1024), the same with guess='kiss' "
                         "(and the assoc predict), or bench_config() with "
                         "log=True; several run in turn")
    ap.add_argument("--scans", type=int, default=20,
                    help="steady scans in the profiled window")
    ap.add_argument("--json", help="also write the summaries to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_path: no CUDA device")
    from ptudes_tpu_torch.models import sim

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    scene = sim.bench_scene()
    summaries = [profile_config(name, scene, args.scans, card)
                 for name in args.config]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summaries, f, indent=1)


def wrapper_calls(dev, reps: int = 20) -> dict:
    """K3's and K2's wrappers alone at the bench path's shapes
    (``chip_smoke.icp_scene``: N = 2048, C = 32 and the bench gather; the
    EKF state of ``chip_smoke.generic_ekf_state`` and a rotated pose), per
    kernel: the call ms of the wrapper and of its plain twin (CUDA events,
    ``chip_smoke.cuda_ms``), the host clock around ``reps`` wrapper calls
    ending in a synchronize, the kernel's records a call and their mean
    device us, and the records of every other kernel the wrapper launches
    (its glue) a call with their device us a call. The profiler can drop
    records, so fewer than one kernel record a call means records were
    lost."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from ptudes_tpu_torch import config
    from ptudes_tpu_torch.geom import se3, so3
    from ptudes_tpu_torch.models import esekf
    from ptudes_tpu_torch.ops import cuda_ekf, cuda_gn, icp

    m, src, mask, guess = cs.icp_scene(dev)
    q_w = se3.transform(guess, src)
    cand = icp.gather_candidates(m, q_w, voxel_size=0.3, max_probes=2,
                                 neighborhood=7, n_voxels=4,
                                 fit_planes=False)
    ekf = config.bench_config().ekf
    s = cs.generic_ekf_state(ekf, dev, np.random.default_rng(0))
    pose = torch.eye(4, device=dev)
    pose[:3, :3] = so3.exp_rotvec(torch.tensor([0.02, -0.01, 0.03],
                                               device=dev))
    pose[:3, 3] = torch.tensor([0.1, -0.2, 0.05], device=dev)
    mc = esekf.default_meas_cov(ekf, dev)
    twin_ekf = dataclasses.replace(ekf, update_form="xla")
    cases = {
        "gn_prep": (lambda: cuda_gn.prep_with_plane(cand, mask, q_w, 0.6),
                    lambda: cuda_gn.prep_with_plane_torch(cand, mask, q_w,
                                                          0.6)),
        "ekf_update": (lambda: cuda_ekf.update_pose(s, pose, mc),
                       lambda: esekf.process_pose(s, pose, cfg=twin_ekf,
                                                  meas_cov=mc))}
    out = {}
    for name, (call, twin) in cases.items():
        def calls():
            for _ in range(reps):
                call()
            torch.cuda.synchronize()

        calls()
        t0 = time.monotonic()
        calls()
        wall = (time.monotonic() - t0) / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        own = [e for e in kern if f"{name}_kernel" in e.name]
        glue = [e for e in kern if f"{name}_kernel" not in e.name]

        def us(es):
            return sum(e.time_range.end - e.time_range.start for e in es)

        out[name] = {"call_ms": cs.cuda_ms(call, 200),
                     "plain_ms": cs.cuda_ms(twin, 20),
                     "wall_us_per_call": wall * 1e6,
                     "kernel_launches": len(own) / reps,
                     "kernel_device_us": us(own) / max(len(own), 1),
                     "glue_launches": len(glue) / reps,
                     "glue_device_us": us(glue) / reps}
    return out


def profile_config(which: str, scene, n_scans: int, card: str) -> dict:
    """Profile ``n_scans`` steady scans at configuration ``which``; print
    and return the summary."""
    from torch.profiler import ProfilerActivity, profile

    from ptudes_tpu_torch import kernels
    from ptudes_tpu_torch.models import lio
    from ptudes_tpu_torch.ops import hashmap, icp
    from ptudes_tpu_torch.utils import convert

    dev = torch.device("cuda", 0)
    sensor, scans, scan_ts, _, imu = scene
    cfg = make_config(which, *scans.shape[1:])
    lut = convert.lut_from_numpy(sensor.lut, dev)
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu.ts, device=dev)
    log = which == "bench_log"
    boot = lio.make_scan_step(lut, cfg, insert_overflow=True, log=log)
    steady = lio.make_scan_step(lut, cfg,
                                insert_overflow=cfg.steady_insert_mode,
                                log=log)
    n0 = cfg.bootstrap_scans
    end = len(scans)
    if which.startswith("cli_kiss"):
        end = len(np.loadtxt(os.path.join(ROOT, "tests", "data",
                                          "cli_kiss_jax_poses.txt")))
    n_scans = min(n_scans, end - (n0 + 5))
    window = range(n0 + 5, n0 + 5 + n_scans)
    assert n_scans > 0, "not enough scans for the window"

    state = lio.init_state(cfg, dev)
    for i in range(n0):
        state, *_ = boot(state, lio.scan_at(batches, i))
    for i in range(n0, window[0]):             # warm-up steady scans
        state, *_ = steady(state, lio.scan_at(batches, i))
    torch.cuda.synchronize()

    icp.reset_refresh_counts()
    t0 = time.monotonic()
    s_unprof = state
    for i in window:
        s_unprof, *_ = steady(s_unprof, lio.scan_at(batches, i))
    torch.cuda.synchronize()
    wall_plain = (time.monotonic() - t0) / n_scans
    refresh = {k: v / n_scans for k, v in icp.REFRESH_COUNTS.items()}

    rows = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for i in window:
            state, row, *_ = steady(state, lio.scan_at(batches, i))
            rows.append(row)
        torch.cuda.synchronize()
        wall_prof = (time.monotonic() - t0) / n_scans
    gn_iters = float(
        lio.unpack_out(torch.stack(rows)).aux.iterations.float().mean())

    # one overflow chunk with no points (what the exact steady insert runs
    # ceil(max_frame / max_new_per_scan) - 1 times per scan when the new
    # points fit the first chunk), timed alone with CUDA events
    m = state.kiss.local_map
    nf = cfg.cap.max_frame
    cols = tuple(hashmap._spare(x) for x in (
        m.meta[:, 0], m.meta[:, 1], m.meta[:, 5], m.meta[:, 2:5], m.points))
    empty = (torch.zeros((nf, 3), device=dev),
             torch.zeros((nf, 2), dtype=torch.int32, device=dev),
             torch.zeros(nf, dtype=torch.bool, device=dev))

    def chunk():
        hashmap._insert_chunk(
            cols, *empty, voxel_size=cfg.kiss.resolved_voxel_size,
            max_probes=cfg.cap.max_probes,
            new_capacity=cfg.cap.max_new_per_scan)

    chunk()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(20):
        chunk()
    ev1.record()
    torch.cuda.synchronize()
    empty_chunk_ms = ev0.elapsed_time(ev1) / 20

    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(kern) / n_scans
    by_kernel: dict[str, list[float]] = {}
    for e in kern:
        d = by_kernel.setdefault(e.name[:90], [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:25]
    hand_us = {name: sum(v[1] for k, v in by_kernel.items()
                         if f"{name}_kernel" in k) / n_scans
               for name in kernels.KERNELS}
    ops = [e for e in prof.key_averages() if e.device_type
           == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")]
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:20]
    summary = {
        "card": card, "config": which, "scans": n_scans,
        "wall_ms_per_scan": wall_plain * 1e3,
        "wall_ms_per_scan_profiled": wall_prof * 1e3,
        "device_busy_ms_per_scan": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / (wall_plain * 1e3),
        "device_idle_share_profiled": 1.0 - busy / 1e3 / (wall_prof * 1e3),
        "kernel_launches_per_scan": len(kern) / n_scans,
        "empty_insert_chunk_ms": empty_chunk_ms,
        "extra_insert_chunks_per_scan": (
            -(-nf // cfg.cap.max_new_per_scan) - 1
            if cfg.steady_insert_mode is not False else 0),
        "host_reads_per_scan": refresh["host_reads"],
        "regathers_per_scan": refresh["regathers"],
        # each hand kernel is one __global__ function, <name>_kernel
        "hand_kernels_device_us_per_scan": hand_us,
        "hand_kernels_launches_per_scan": {
            name: sum(v[0] for k, v in by_kernel.items()
                      if f"{name}_kernel" in k) / n_scans
            for name in kernels.KERNELS},
        "gn_iterations_per_scan": gn_iters,
        # the bench path's K3 and K2 calls alone: kernel, glue and twin
        "wrappers": wrapper_calls(dev) if which == "bench" else None,
        # K4 runs all of a scan's iterations in one launch, K5 one a build
        "gn_device_us_per_iteration": {
            name: hand_us[name] / gn_iters
            for name in ("icp_loop", "gn_iter") if hand_us[name] > 0},
        "top_kernels": [
            dict(name=k, calls_per_scan=v[0] / n_scans,
                 device_us_per_scan=v[1] / n_scans)
            for k, v in top_kernels],
        "top_ops": [
            dict(op=e.key, calls_per_scan=e.count / n_scans,
                 self_device_us_per_scan=e.self_device_time_total
                 / n_scans,
                 cpu_us_per_scan=e.cpu_time_total / n_scans)
            for e in top_ops],
    }
    print(json.dumps({k: v for k, v in summary.items()
                      if not k.startswith("top")}))
    for k in summary["top_kernels"]:
        print(f"  {k['device_us_per_scan']:9.1f} us {k['calls_per_scan']:6.1f}"
              f" x  {k['name']}")
    for o in summary["top_ops"]:
        print(f"  {o['self_device_us_per_scan']:9.1f} us dev "
              f"{o['cpu_us_per_scan']:9.1f} us cpu "
              f"{o['calls_per_scan']:6.1f} x  {o['op']}")
    return summary


if __name__ == "__main__":
    main()
