#!/usr/bin/env python3
"""Drive the PyTorch port's LIO paths once on one CUDA card.

    python3 chip_smoke.py            # 50 scans of 128 x 1024 per path

Phases, each reported on its own line:
  1. device: fail without CUDA; print the card's name and power limit;
  2. build the CUDA kernels from ``ptudes_tpu_torch/csrc`` (one nvcc per
     source, in parallel);
  3. each kernel against its plain PyTorch twin on the card, with the
     stated tolerances, and both times; K1 at K = 0, 12, 16 and 64, with
     holes, a late sample, a fresh filter and an all-invalid block, its
     device time at K = 0, 12 and 16, and in each case K1 writing the
     filter history against the twin chain's history (its carried state
     bit-equal to the launch without, its last row the carried state, its
     device time beside K1's without); K2 in both Joseph forms, with a
     rotated and with an identity measurement, repeating bit for bit, its
     device time; K3 at the bench shapes and at a ragged N = 2046, its
     lane-major rows bit for bit against ``lane_major(cand)``, repeating
     bit for bit, its device time; K4 in both its variants (staged
     in shared memory at the bench shapes, streamed at the CLI shapes),
     its other launch shapes bit for bit against the default, K4 and K5
     repeating bit for bit and on a scene of exact nearest-row ties
     (lowest row wins); the candidate-refresh ICP loop
     with the kernel against the loop with the twin; the fused gather
     (K6, one launch) at the bench and CLI shapes with its selection
     written out, and K6 -> K4 against the gather -> K3 -> K4 chain; the
     plane moments (K7), which no path launches;
  4. the bench path: ``lio.run_sequence`` at ``bench_config()`` on the
     bench scene (rendered by the port's numpy sim, cached in the temp
     dir), once to warm up and once timed with host syncs made errors;
     K1-K4 must each launch once per scan, ATE RMSE <= 0.02 m, and every
     pose within 0.02 m of the JAX reference poses
     (``tests/data/bench_jax_poses.txt``); then the same run with every
     kernel replaced by its twin;
  5. the flagship command's path: ``lio.run_sequence`` at
     ``cli_config(128, 1024)`` on the same scene, warmed up and timed with
     host syncs made errors except the refresh loop's counted reads
     (``icp.read_flags``); K1 once per scan, K5 once per GN iteration,
     K2-K4 never; ATE RMSE within 0.005 m of the JAX run's, every pose
     within 0.02 m of ``tests/data/cli_jax_poses.txt``; then the twins;
  6. the fused bench path: ``bench_config()`` with ``fused_gather=True``
     on the same scene, warmed up and timed with host syncs made errors;
     K6, K4, K1 and K2 once per scan, K3 and K5 never; ATE
     RMSE <= 0.02 m and every pose within 0.02 m of
     ``tests/data/bench_fused_jax_poses.txt``; then the twins; scans/s
     printed beside phase 4's from the same call;
  7. the CLI's EKF-facing paths: (a) ``cli_config(128, 1024,
     guess="kiss")``, the command with no guess flag (K1 once a scan, K5
     once a GN iteration, no other kernel), and (b) the same with
     ``predict_batch="assoc"`` (``stat --kiss-run``'s EKF; K1 never), each
     warmed up and timed like phase 5 on the first 15 scans of the scene,
     the ones ``tests/data/cli_kiss_jax_poses.txt`` holds (the JAX run
     with this guess leaves the track from scan 15 on), ATE RMSE within
     0.005 m of the JAX run's and every pose within 0.02 m of it, (a) also
     with the twins; (c) ``bench_config()`` with ``log=True``: K1 writes
     the history (once a scan, no twin step), the poses are phase 4's bit
     for bit, the log [50, 12] with one knot a scan at its last valid slot
     holding the scan's EKF position, its flattened entries rising in time;
     (d) ``esekf.run_filter`` at ``ekf-bench sim``'s defaults with the op
     chain update and with K2 (once a step), against the CPU run (phases 5,
     6, 7a, 7b and 8 also profile the last scans of their warm-up runs:
     device busy and device operations a scan);
  8. the pipeline's remaining options, each warmed up (its last scans
     profiled: device busy and device operations a scan) and timed with
     host syncs made errors (but the counted reads of ``icp.read_flags``),
     its kernels' launches checked, every pose within 0.02 m of the JAX
     run in ``tests/data/<name>_jax_poses.txt``: (a) ``cli_config(128,
     1024)`` with ``loss="point"`` (K1, K5 with point rows; ATE within
     0.005 m of JAX's), (b) ``bench_config()`` with ``loss="point"``
     through the gather, K3's point mode and K4, and with
     ``fused_gather=True`` through K6 and K4 (their pose difference
     printed), (c) ``bench_config()`` mapping scans 0-24, a checkpoint
     saved and loaded (``utils.checkpoint``), scans 25-49 with
     ``map_frozen=True`` (the map after them bit-equal to the loaded one;
     the mapping scans and an unfrozen resume bit-equal to phase 4's run),
     (d) ``col_decimation=2``, (e) ``nn_neighborhood=4`` with
     ``fused_gather=True`` (the gather and K3, K6 never), (f)
     ``kiss.register_scan`` alone at ``KissConfig()``'s defaults with
     ``nn_mode="every"``, ``loss="point"`` and no grid (no kernel; the
     first 13 scans, which the JAX run tracks); one JSON line of the runs'
     summaries with the card's name and power limit;
  9. the recording path through the port's command line: the bench scene
     written as an Ouster recording (``tools/make_torch_fixture.py``'s
     ``bench`` writer: a LEGACY pcap in 1024x10 mode, IP-fragmented, epoch
     timestamps, ranges in mm, its metadata and ground truth) in a temp
     dir, its LUT the scene sensor's, decoded by the native and by the
     numpy decoder (the same arrays; both times printed); ``ekf-bench
     ouster --use-imu-prediction -g gt.csv --save-kitti-poses`` on the
     card, in batch (the native decoder; K1 once a scan and K5 once a GN
     iteration over the command's two runs, no other kernel) and with
     ``--online`` (its poses bit-equal to the batch run's, or the largest
     difference printed; latency p50/p95/p99), every saved pose within
     0.02 m of ``tests/data/cli_pcap_jax_poses.txt`` (the JAX command's on
     the same file) and the printed ATE RMSE within the JAX run's + 0.005
     m; ``stat`` on the file; one JSON line of the decode times, scans/s
     and latencies with the card's name and power limit;
 10. several sequences at once: (a) K1 (both instances), K2, K3 (both
     modes), K4 and K5 launched once with a replica axis at B = 4 on four
     distinct inputs, each replica bit-equal to its own single launch, and
     their device times at B = 1, 2, 4; K5 also with one replica inactive
     (its output row untouched, the others bit-equal, every ticket back at
     0); (b) ``parallel.batched.run_sequence_batched`` at
     ``bench_config()`` on B = 1, 2, 4 replicas of the scene and on B = 2
     of {the scene, the scene at 64 beams}, each warmed up (its last 10
     scans profiled: device operations, busy ms and idle share a scan)
     and timed with host syncs made errors: K1-K4 once a scan whatever B
     is, K5 and K6 never, identical replicas bit-equal, every replica
     within 0.02 m of ``tests/data/bench_jax_poses.txt`` or
     ``bench_beams64_jax_poses.txt``, B = 1 within 1e-4 m of phase 4,
     device operations a scan at B = 4 at most 1.25x those at B = 1,
     aggregate scans/s from alternating runs; (d) the same driver at
     ``cli_config(128, 1024)`` (the candidate-refresh loop; K1 and K5) on
     B = 1, 2, 4 replicas over the 50 scans, profiled and timed the same
     way but for the refresh loop's counted reads: K1 once a scan, K5 once
     a GN iteration for all replicas (each scan's largest iteration count,
     summed), no other kernel, host reads at most that many, every replica
     within 0.02 m of ``cli_jax_poses.txt``, identical replicas bit-equal,
     B = 1 within 1e-4 m of phase 5, aggregate scans/s from alternating
     runs; (e) B = 2 at phase 7b's cell (the constant-velocity guess, the
     associative predict, 15 scans): K5 alone, within 0.02 m of
     ``cli_kiss_jax_poses.txt`` and 1e-4 m of phase 7b; (c) ``ekf-bench
     sweep`` on the scene written as phase 9's pcap, its variants as one
     batched program: ``--replicas 2`` over the 50 scans (replicas
     bit-equal, within 0.02 m of ``tests/data/sweep_pcap_jax_poses.txt``,
     the printed ATE within the JAX run's + 0.005 m), ``--bacc-z
     -0.1,0,0.1`` and ``--beams 128,64`` on scans 0-20, every variant
     within 0.02 m of its JAX poses (``sweep_bacc_z_jax_poses.txt``,
     ``sweep_beams_jax_poses.txt``); K5 once a GN iteration for all
     variants, no other kernel; then one JSON line of phase 10's figures
     with the card's name and power limit. ``--phases 10`` runs phases 1,
     2, 4, 5, 7a-b and 10 alone.
 11. point-sharded LIO (``parallel.sharded``) and the viz paths: (a) K3
     and K5 at the shard shapes (N = 1024, C = 32 and N = 4096, C = 80)
     against their twins at phase 3's bars, repeating bit for bit, with
     device us and bounds; (b) ``run_sharded`` at ``bench_config()`` over
     the 50 scans at world size 1 with NCCL on the card (host syncs made
     errors but the counted reads) and (c) at world size 2 with gloo, both
     ranks on the one card, for ``bench_config()``, the same with
     ``fused_gather=True`` (K6 on each shard) and ``cli_config(128,
     1024)`` on the first 25 scans (NCCL across two
     cards too where there are two): every rank bit-equal, within 0.02 m
     of ``bench_jax_poses.txt`` / ``cli_jax_poses.txt``, K4 never, K5 once
     a GN iteration with one all-reduce after it, K3 (bench) and K1 once a
     scan; scans/s, all-reduces a scan and us an all-reduce; (d) on the
     scene written as phase 9's pcap, ``ekf-bench ouster --save-map-ply
     --save-debug-scene`` on scans 0-10 (the knots within 0.02 m of
     ``tests/data/debug_scene_jax_poses.txt``), ``flyby --kitti-poses``,
     ``viz --stream-dir`` and a plot flag refused without matplotlib; one
     JSON line of phase 11's figures. ``--phases 11`` runs phases 1, 2, 4
     and 11 alone.
Phase 3 also holds K3's point mode (``loss="point"``: the instance without
the fit) bit for bit against its twin, K4 on its point rows and K5 on
point rows at the CLI shapes; phase 2 prints the SASS instruction count of
both K3 instances (``cuobjdump``).
Every kernel's line in the JSON summary carries its bound: the larger of
the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100 SXM data
sheet), for the inputs it was timed on. The last two lines before the
final one are the kernel JSON summary and the card's name and power
limit; the last line is the result JSON. Any failure raises, so the exit
code is nonzero and no result line prints.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.geom import se3, so3
from ptudes_tpu_torch.models import esekf, kiss, lio, sim
from ptudes_tpu_torch.ops import (cuda_ekf, cuda_gather, cuda_gn, cuda_icp,
                                  hashmap, icp)
from ptudes_tpu_torch.ops import voxel
from ptudes_tpu_torch.ops.projection import scan_to_points
from ptudes_tpu_torch.parallel import batched, replay
from ptudes_tpu_torch.utils import checkpoint, convert, metrics, replicas

HERE = os.path.dirname(os.path.abspath(__file__))
REF_POSES = os.path.join(HERE, "tests", "data", "bench_jax_poses.txt")
ATE_GATE_M = 0.02    # bench.py's absolute ATE gate
CLI_ATE_SLACK_M = 0.005  # the CLI path's ATE may exceed the JAX run's by
POSE_GATE_M = 0.02   # per-pose parity with the JAX reference poses
REPLACES = {
    "ekf_predict": ("ekf_predict.cu", "ptudes_tpu/ops/pallas_ekf.py:438"),
    "ekf_update": ("ekf_update.cu", "ptudes_tpu/ops/pallas_ekf.py:381"),
    "gn_prep": ("gn_prep.cu", "ptudes_tpu/ops/pallas_gn.py:260"),
    "icp_loop": ("icp_loop.cu", "ptudes_tpu/ops/pallas_icp.py:432"),
    "gn_iter": ("gn_iter.cu", "ptudes_tpu/ops/pallas_gn.py:351"),
    "gather_fused": ("gather_fused.cu",
                     "ptudes_tpu/ops/pallas_gather.py:291"),
    "plane_moments": ("plane_moments.cu", "ptudes_tpu/ops/pallas_gn.py:200"),
    # K1 writing the filter history (the JAX log path's unrolled chain,
    # ptudes_tpu/models/esekf.py:457-484, beside the same TPU kernel)
    "ekf_predict_history": ("ekf_predict.cu",
                            "ptudes_tpu/ops/pallas_ekf.py:438"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


def say(msg: str) -> None:
    print(msg, flush=True)


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last reset, and its variants'."""
    return {**kernels.LAUNCHES, **kernels.VARIANT_LAUNCHES}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_us(fn, name: str, reps: int = 20) -> float:
    """Mean device time (us) of the kernel ``<name>_kernel`` over ``reps``
    calls of ``fn``, from ``torch.profiler``'s device timestamps (the
    wrapper's glue ops excluded). The profiler can drop kernel records (it
    kept 34 of 50 once, with every launch checked, and none of 20 once), so
    a short count is profiled again up to twice, then the mean of what it
    kept is used and the count printed; more than one record a call fails,
    and with no record at all the time comes from :func:`event_us` (the
    wrapper's glue launches included), which is printed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ds = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and f"{name}_kernel" in e.name]
        if len(ds) == reps:
            break
    check(len(ds) <= reps, f"{name}: {len(ds)} kernels in {reps} calls")
    if not ds:
        us = event_us(fn, reps)
        say(f"  {name}: the profiler kept no kernel record in 3 x {reps} "
            f"calls; CUDA events instead: {us:.2f} us a call with its glue")
        return us
    if len(ds) < reps:
        say(f"  {name}: the profiler kept {len(ds)} of {reps} kernel records")
    return float(np.mean(ds))


def event_us(fn, reps: int) -> float:
    """Device us a call of ``fn`` from CUDA events around ``reps`` calls
    queued behind a sleep kernel, so the card runs them back to back and
    the host's launch time is not counted (any glue ``fn`` launches is)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)      # ~10 ms of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps


def sass_sizes(lib_path: str, kernel: str) -> dict[str, int] | None:
    """SASS instructions of each instance of ``kernel`` in the built
    library (``cuobjdump -sass``), by mangled name; None without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    sizes, cur = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = head.group(1) if kernel in head.group(1) else None
            if cur:
                sizes[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            sizes[cur] += 1
    return sizes


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nbytes(*xs) -> int:
    """Bytes of the tensors in ``xs`` (nested tuples and lists too)."""
    return sum(nbytes(*x) if isinstance(x, (tuple, list))
               else x.numel() * x.element_size() for x in xs)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_flops=int(flops))


# --------------------------------------------------------------- phase 3

def generic_ekf_state(cfg, dev, rng):
    """An EKF state advanced by 20 random IMU samples (test_esekf's
    recipe), on ``dev``."""
    s = esekf.init_state(cfg, dev)
    twin = dataclasses.replace(cfg, predict_batch="unroll")
    ts = 0.0
    for _ in range(20):
        ts += 0.01
        imu = esekf.Imu(
            lacc=torch.tensor(rng.normal(0, 1, 3) + [0, 0, 9.78],
                              dtype=torch.float32, device=dev),
            avel=torch.tensor(rng.normal(0, 0.2, 3), dtype=torch.float32,
                              device=dev),
            ts=torch.tensor(ts, dtype=torch.float32, device=dev))
        s = esekf.process_imu(s, imu, cfg=twin)
    return s


# F's nonzeros by row: POS 2, VEL 7, PHI 4, BG and BA 1 (csrc/ekf_predict.cu)
F_ROW_TERMS = [2] * 3 + [7] * 3 + [4] * 3 + [1] * 9


def predict_block_ops(n_steps: int) -> int:
    """Operations of K1's block-sparse covariance steps (a multiply-add is
    two): T = F P over rows POS, VEL and PHI, then all of T F^T."""
    t_rows = 2 * 18 * sum(F_ROW_TERMS[:9])
    return n_steps * (t_rows + 2 * 18 * sum(F_ROW_TERMS))


def check_predict(cfg, s, dev, rng, k, valid, ts=None):
    """K1 against its twin over a block of ``k`` IMU samples (``valid`` a
    bool list, ``ts`` the timestamps, by default 10 ms apart after 0.2 s)
    and a second launch bit for bit, then its history (:func:`check_history`)
    on the same inputs; returns (max |kernel - twin|, kernel call, twin
    call, bound) and the same four of the history."""
    twin = dataclasses.replace(cfg, predict_batch="unroll")
    if ts is None:
        ts = 0.2 + np.arange(1, k + 1) * 0.01
    imus = esekf.Imu(
        lacc=torch.tensor(rng.normal(0, 1, (k, 3)) + [0, 0, 9.78],
                          dtype=torch.float32, device=dev),
        avel=torch.tensor(rng.normal(0, 0.3, (k, 3)), dtype=torch.float32,
                          device=dev),
        ts=torch.tensor(ts, dtype=torch.float32, device=dev))
    valid = torch.tensor(valid, dtype=torch.bool, device=dev).reshape(k)

    def kern():
        return cuda_ekf.predict_block(s, imus, valid, cfg=cfg,
                                      want_twist=True)

    def plain():
        return esekf.process_imu_batch(s, imus, valid, cfg=twin,
                                       want_twist=True)

    (sk, tk), (sp, tp), (sa, ta) = kern(), plain(), kern()
    check(all(torch.equal(a, b) for a, b in zip((*sk, tk), (*sa, ta))),
          f"ekf_predict K={k} does not repeat bit for bit")
    # bars of tests/test_esekf.py (kernel vs unrolled chain; twist)
    errs = {"pos": (sk.pos - sp.pos).abs().max(),
            "vel": (sk.vel - sp.vel).abs().max(),
            "quat": torch.minimum((sk.quat - sp.quat).abs().max(),
                                  (sk.quat + sp.quat).abs().max()),
            "twist": (tk - tp).abs().max()}
    errs = {n: float(v) for n, v in errs.items()}
    check(errs["pos"] <= 1e-6 and errs["vel"] <= 1e-6
          and errs["quat"] <= 1e-6, f"ekf_predict K={k} state vs twin: "
          f"{errs}")
    check(errs["twist"] <= 2e-5, f"ekf_predict K={k} twist vs twin: {errs}")
    check(float(sk.imu_ts) == float(sp.imu_ts)
          and bool(sk.initialized) == bool(sp.initialized),
          f"ekf_predict K={k} clock/latch vs twin")
    check(torch.allclose(sk.cov, sp.cov, rtol=1e-5, atol=1e-5),
          f"ekf_predict K={k} cov vs twin: "
          f"{float((sk.cov - sp.cov).abs().max())}")
    err = max(max(errs.values()), float((sk.cov - sp.cov).abs().max()))
    # the covariance steps run for every sample, a masked one with F = I
    b = bound(nbytes(s, imus, valid, sk, tk), predict_block_ops(k))
    return (err, kern, plain, b), check_history(cfg, s, imus, valid, k,
                                                (sk, tk))


def check_history(cfg, s, imus, valid, k, unlogged):
    """K1 writing the filter history against the twin chain's history
    (pos, vel and quat 1e-6, cov_diag rtol/atol 1e-5: the kernel-vs-unroll
    bars; ts, biases and gravity exact, no updates), its carried state and
    twist bit-equal to the launch without history, its last row bit-equal
    to the carried state, a second launch bit for bit. Returns (max
    difference, kernel call, twin call, bound)."""
    twin = dataclasses.replace(cfg, predict_batch="unroll")

    def kern():
        return cuda_ekf.predict_block(s, imus, valid, cfg=cfg,
                                      want_twist=True, log=True)

    def plain():
        return esekf.process_imu_batch(s, imus, valid, cfg=twin,
                                       want_twist=True, log=True)

    (sk, tk, hk), (_, _, hp), again = kern(), plain(), kern()
    name = f"ekf_predict history K={k}"
    check(all(torch.equal(a, b) for a, b in zip((*sk, tk), (*unlogged[0],
                                                            unlogged[1]))),
          f"{name}: carried state differs from the launch without history")
    check(all(torch.equal(a, b) for a, b in zip((*sk, tk, *hk),
                                                (*again[0], again[1],
                                                 *again[2]))),
          f"{name} does not repeat bit for bit")
    check(hk.pos.shape == (k, 3) and hk.cov_diag.shape == (k, 18),
          f"{name}: shapes {hk.pos.shape} {hk.cov_diag.shape}")
    exact = all(torch.equal(getattr(hk, f), getattr(hp, f))
                for f in ("ts", "bias_gyr", "bias_acc", "grav", "updated"))
    check(exact, f"{name}: ts, biases, gravity or updated differ")
    quat = torch.minimum((hk.att_q - hp.att_q).abs().amax(1),
                         (hk.att_q + hp.att_q).abs().amax(1))
    errs = {f: float((getattr(hk, f) - getattr(hp, f)).abs().max())
            if k else 0.0 for f in ("pos", "vel", "cov_diag")}
    errs["quat"] = float(quat.max()) if k else 0.0
    check(max(errs["pos"], errs["vel"], errs["quat"]) <= 1e-6,
          f"{name} vs twin: {errs}")
    check(torch.allclose(hk.cov_diag, hp.cov_diag, rtol=1e-5, atol=1e-5),
          f"{name} cov_diag vs twin: {errs}")
    if k:
        check(torch.equal(hk.pos[-1], sk.pos) and torch.equal(hk.vel[-1],
                                                              sk.vel)
              and torch.equal(hk.att_q[-1], sk.quat)
              and torch.equal(hk.cov_diag[-1], torch.diagonal(sk.cov)),
              f"{name}: last row differs from the carried state")
    b = bound(nbytes(s, imus, valid, sk, tk, hk), predict_block_ops(k))
    return max(errs.values()), kern, plain, b


def check_ekf(dev, rng, results):
    cfg = config.bench_config().ekf
    s = generic_ekf_state(cfg, dev, rng)
    fresh = esekf.init_state(cfg, dev)
    # K = 12: the bench path's max_imu_per_scan; K = 16: the CLI's; K = 0
    # gives the fixed cost; then holes in the block with a timestamp out of
    # order (dt clamped to 0), a fresh filter whose first valid sample only
    # latches the clock, an all-invalid block and the kernel's largest K
    # (16 samples valid: 64 in the matrix chain drift 1.6e-6 from the
    # twin's quaternion chain)
    holes = [True] * 16
    holes[3] = holes[7] = holes[8] = False
    late = 0.2 + np.arange(1, 17) * 0.01
    late[10] = late[9] - 0.005
    cases = {"K=12": (s, 12, [i < 10 for i in range(12)], None),
             "K=16": (s, 16, [i < 14 for i in range(16)], None),
             "K=0": (s, 0, [], None),
             "K=16 holes, late sample": (s, 16, holes, late),
             "K=12 fresh filter": (fresh, 12, [False, True] + [True] * 8
                                   + [False] * 2, None),
             "K=12 all invalid": (s, 12, [False] * 12, None),
             "K=64, 16 valid": (s, 64, [k % 4 == 1 for k in range(64)],
                                None)}
    worst, calls, hist = 0.0, {}, {}
    for name, (s0, k, valid, ts) in cases.items():
        (err, kern, plain, b), hc = check_predict(cfg, s0, dev, rng, k, valid,
                                                  ts)
        worst = max(worst, err)
        calls[name], hist[name] = (kern, plain, b), hc
        say(f"  ekf_predict {name}: max |kernel - twin| {err:.3e} (state "
            f"1e-6, twist 2e-5, cov rtol/atol 1e-5; clock and latch exact); "
            f"repeats bit for bit; with history: max |history - twin's| "
            f"{hc[0]:.3e} (pos, vel, quat 1e-6, cov_diag rtol/atol 1e-5; ts, "
            f"biases, gravity exact), state as without, last row the "
            f"carried state, repeats bit for bit")
    for key, by_case in (("ekf_predict", calls), ("ekf_predict_history",
                                                  {n: h[1:] for n, h in
                                                   hist.items()})):
        r = {}
        for name in ("K=0", "K=12", "K=16"):
            kern, plain, b = by_case[name]
            tag = name[2:]
            r[f"device_us_k{tag}"] = kernel_us(kern, "ekf_predict")
            if name != "K=0":
                r[f"ms_k{tag}"] = cuda_ms(kern, 200)
                r[f"plain_ms_k{tag}"] = cuda_ms(plain, 20)
        say(f"  {key} on the device: {r['device_us_k0']:.2f} / "
            f"{r['device_us_k12']:.2f} / {r['device_us_k16']:.2f} us at K = "
            f"0 / 12 / 16 ({(r['device_us_k16'] - r['device_us_k12']) / 4:.3f}"
            f" us a step from K = 12 to 16)")
        # the row reports the CLI shape, K = 16 (14 valid)
        results[key] = dict(
            max_abs_err=worst if key == "ekf_predict" else max(
                h[0] for h in hist.values()),
            ms=r["ms_k16"], plain_ms=r["plain_ms_k16"],
            device_us=r["device_us_k16"], **by_case["K=16"][2], **r)

    pose = torch.eye(4, dtype=torch.float32, device=dev)
    pose[:3, 3] = torch.tensor([0.1, -0.2, 0.05], device=dev)
    rotated = pose.clone()
    rotated[:3, :3] = so3.exp_rotvec(torch.tensor([0.02, -0.01, 0.03],
                                                  device=dev))
    # the identity measurement: the state's attitude exactly (the identity
    # quaternion), so the residual's log takes its small-angle branch
    s_id = s._replace(quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev))
    worst = 0.0
    for name, (s0, pm, joseph) in {
            "Joseph": (s, rotated, True), "simple": (s, rotated, False),
            "Joseph, identity measurement": (s_id, pose, True),
            "simple, identity measurement": (s_id, pose, False)}.items():
        worst = max(worst, check_update(cfg, s0, pm, joseph, name, dev))
    mc = esekf.default_meas_cov(cfg, dev)

    def kern():
        return cuda_ekf.update_pose(s, rotated, mc)

    # the byte bound of a one-CTA latency kernel (the dense Joseph products'
    # operations are below it); K1's fixed cost at K = 0 is the practical
    # floor of one launch of one CTA on this card
    b = bound(nbytes(s, rotated, mc, kern()), 4 * 18 ** 3 + 8 * 18 * 18 * 6)
    results["ekf_update"] = dict(
        max_abs_err=worst, **b, ms=cuda_ms(kern, 200),
        plain_ms=cuda_ms(lambda: esekf.process_pose(
            s, rotated, cfg=dataclasses.replace(cfg, update_form="xla"),
            meas_cov=mc), 20),
        device_us=kernel_us(kern, "ekf_update"),
        device_us_simple=kernel_us(
            lambda: cuda_ekf.update_pose(s, rotated, mc, joseph=False),
            "ekf_update"))
    say(f"  ekf_update on the device: {results['ekf_update']['device_us']:.2f}"
        f" us Joseph, {results['ekf_update']['device_us_simple']:.2f} us "
        f"simple")


def check_update(cfg, s, pose, joseph, name, dev) -> float:
    """K2 against its twin (tests/test_esekf.py's bars: state 1e-5, cov
    rtol 1e-4 atol 1e-5) and a second launch bit for bit; returns the
    largest difference."""
    c = dataclasses.replace(cfg, joseph_form=joseph)
    mc = esekf.default_meas_cov(c, dev)
    uk = cuda_ekf.update_pose(s, pose, mc, joseph=joseph)
    again = cuda_ekf.update_pose(s, pose, mc, joseph=joseph)
    up = esekf.process_pose(s, pose, cfg=dataclasses.replace(
        c, update_form="xla"), meas_cov=mc)
    check(all(torch.equal(a, b) for a, b in zip(uk, again)),
          f"ekf_update ({name}) does not repeat bit for bit")
    errs = {f: float((getattr(uk, f) - getattr(up, f)).abs().max())
            for f in ("pos", "vel", "bias_gyr", "bias_acc", "grav")}
    errs["quat"] = float(torch.minimum((uk.quat - up.quat).abs().max(),
                                       (uk.quat + up.quat).abs().max()))
    check(max(errs.values()) <= 1e-5,
          f"ekf_update ({name}) state vs twin: {errs}")
    cov_err = float((uk.cov - up.cov).abs().max())
    check(torch.allclose(uk.cov, up.cov, rtol=1e-4, atol=1e-5),
          f"ekf_update ({name}) cov vs twin: {cov_err}")
    say(f"  ekf_update {name}: max |kernel - twin| state "
        f"{max(errs.values()):.3e} (1e-5), cov {cov_err:.3e} (rtol 1e-4, "
        f"atol 1e-5); repeats bit for bit")
    return max(*errs.values(), cov_err)


def icp_scene(dev, seed=5, n=2048):
    """tests/test_pallas_icp.py's scene: a floor and a wall in a 2^14-slot
    map, 2048 noisy source points drawn from it, a perturbed guess."""
    rng = np.random.default_rng(seed)
    half = 20000
    floor = np.stack([rng.uniform(-15, 15, half), rng.uniform(-15, 15, half),
                      rng.uniform(-0.02, 0.02, half)], -1)
    wall = np.stack([rng.uniform(-15, 15, half),
                     np.full(half, 8.0) + rng.uniform(-0.02, 0.02, half),
                     rng.uniform(0, 4, half)], -1)
    pts = torch.tensor(np.vstack([floor, wall]), dtype=torch.float32,
                       device=dev)
    frame, keep = voxel.first_in_voxel_sorted(
        pts, torch.ones(len(pts), dtype=torch.bool, device=dev), 0.15,
        len(pts))
    m = hashmap.insert_deduped(
        hashmap.create(1 << 14, 8, dev), frame, keep, voxel_size=0.3,
        max_probes=2, new_capacity=len(pts))
    idx = rng.choice(len(pts), n, replace=False)
    src = pts[torch.as_tensor(idx, device=dev)] + torch.tensor(
        rng.normal(0, 0.01, (n, 3)), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.uniform(size=n) < 0.95, device=dev)
    guess = se3.exp_twist(torch.tensor(
        [0.004, -0.003, 0.006, 0.05, -0.04, 0.03], device=dev))
    return m, src, mask, guess


def check_icp(dev, results):
    k = config.bench_config().kiss
    m, src, mask, guess = icp_scene(dev)
    q_w = se3.transform(guess, src)
    cand = icp.gather_candidates(m, q_w, voxel_size=0.3, max_probes=2,
                                 neighborhood=7, n_voxels=4,
                                 fit_planes=False)
    r = k.plane_fit_radius
    pk, pp, err = check_prep(cand, mask, q_w, r, "gn_prep")
    check(pk.cx.shape == (32, 2048), f"candidate shape {pk.cx.shape}")
    # a ragged N: the last CTA holds 6 points
    m_ = 2046
    cand_r = icp.CandidateSet(*(x[:m_] for x in cand))
    _, _, err_r = check_prep(cand_r, mask[:m_], q_w[:m_].contiguous(), r,
                             "gn_prep ragged")

    def kern_prep():
        return cuda_gn.prep_with_plane(cand, mask, q_w, r)

    # reads the CandidateSet (pts, valid), the query points and the mask
    # once, writes feat and the lane-major rows; ~20 operations per
    # candidate, ~150 per point for the finish
    c, n = pk.cx.shape
    results["gn_prep"] = dict(
        max_abs_err=max(err, err_r),
        **bound(nbytes(cand.pts, cand.valid, q_w, mask, pk),
                n * (20 * c + 150)),
        ms=cuda_ms(kern_prep, 200),
        plain_ms=cuda_ms(
            lambda: cuda_gn.prep_with_plane_torch(cand, mask, q_w, r), 20),
        device_us=kernel_us(kern_prep, "gn_prep"))
    say(f"  gn_prep on the device: {results['gn_prep']['device_us']:.2f} us "
        f"(bound {results['gn_prep']['bound_ms'] * 1e3:.3f} us)")

    # K3's point mode (loss="point"): the instance without the fit
    pk_pt, err_pt = check_prep_point(cand, mask, q_w, r, "gn_prep point")
    _, err_pt_r = check_prep_point(cand_r, mask[:m_],
                                   q_w[:m_].contiguous(), r,
                                   "gn_prep point ragged")

    def kern_point():
        return cuda_gn.prep_with_plane(cand, mask, q_w, r, loss="point")

    # reads the CandidateSet and the mask, writes feat and the rows
    point = dict(
        max_abs_err=max(err_pt, err_pt_r),
        **bound(nbytes(cand.pts, cand.valid, mask, pk_pt), 0),
        ms=cuda_ms(kern_point, 200),
        plain_ms=cuda_ms(lambda: cuda_gn.prep_with_plane_torch(
            cand, mask, q_w, r, loss="point"), 20),
        device_us=kernel_us(kern_point, "gn_prep"))
    results["gn_prep"]["point"] = point
    say(f"  gn_prep point mode on the device: {point['device_us']:.2f} us "
        f"(bound {point['bound_ms'] * 1e3:.3f} us; plane mode "
        f"{results['gn_prep']['device_us']:.2f} us)")

    kern = torch.tensor(0.1667, device=dev)
    max_d2 = torch.tensor(0.25, device=dev)
    kw = dict(plane_min_quality=k.plane_min_quality,
              max_iterations=k.max_iterations,
              prior_rot_weight=k.prior_rot_weight,
              prior_trans_weight=k.prior_trans_weight)
    c, n = pp.cx.shape
    plan = cuda_icp.loop_plan(n, c)
    check(plan.staged and plan.cluster >= 8,
          f"icp_loop plan at the bench shapes {plan}")
    d, nk, npl, ik, ip, kern_loop, plain_loop = check_loop(
        "icp_loop staged", src, pp, guess, kern, max_d2, 1e-5, kw)
    check(npl > 1000, f"icp_loop twin found {npl} correspondences")
    # a ragged slice: at N = 2046 the last CTA is short and the rows are
    # not 16-byte aligned, so the staged variant copies them plainly
    m_ = 2046
    cut = cuda_gn.PreppedCandidates(*(x[:, :m_].contiguous() for x in pp))
    check_loop("icp_loop ragged", src[:m_], cut, guess, kern, max_d2,
               1e-5, kw)
    # point rows only (K3's point-mode candidates: quality -1)
    _, _, npt, _, _, kern_pt, _ = check_loop(
        "icp_loop point", src, pk_pt, guess, kern, max_d2, 1e-5, kw)
    check(npt > 1000, f"icp_loop point twin found {npt} correspondences")
    # reads the source, feat and candidates once; per iteration ~8
    # operations per candidate and ~120 per point
    results["icp_loop"] = dict(
        max_abs_err=d, ms=cuda_ms(kern_loop, 50),
        plain_ms=cuda_ms(plain_loop, 5), iterations=ik,
        device_us=kernel_us(kern_loop, "icp_loop"), plan=plan._asdict(),
        device_us_point=kernel_us(kern_pt, "icp_loop"),
        **bound(nbytes(src, pp, guess), ik * n * (8 * c + 120)))
    say(f"  icp_loop plan {plan}: kernel "
        f"{results['icp_loop']['device_us']:.2f} us on the device")


def check_prep(cand, mask, q_w, r, name):
    """K3 against its twin: the lane-major rows bit for bit (copies of the
    CandidateSet), feat at tests/test_pallas_gn.py's bars (normal |dot|
    1%-quantile > 0.999, centroid 2e-3, quality 2e-2, mask row exact), a
    second launch bit for bit. Returns (kernel, twin, largest error)."""
    pk = cuda_gn.prep_with_plane(cand, mask, q_w, r)
    pp = cuda_gn.prep_with_plane_torch(cand, mask, q_w, r)
    again = cuda_gn.prep_with_plane(cand, mask, q_w, r)
    check(all(torch.equal(a, b) for a, b in zip(pk[1:], pp[1:])),
          f"{name}: lane-major rows differ from lane_major(cand)")
    check(all(torch.equal(a, b) for a, b in zip(pk, again)),
          f"{name} does not repeat bit for bit")
    ok = pp.feat[6] > 0.3
    check(int(ok.sum()) > 500, f"{name}: too few well-conditioned fits")
    dots = (pk.feat[0:3, ok] * pp.feat[0:3, ok]).sum(0).abs()
    cen = float((pk.feat[3:6, ok] - pp.feat[3:6, ok]).abs().max())
    qual = float((pk.feat[6, ok] - pp.feat[6, ok]).abs().max())
    q01 = float(torch.quantile(dots, 0.01))
    check(q01 > 0.999, f"{name} normal dot 1%-quantile {q01}")
    check(cen <= 2e-3, f"{name} centroid {cen}")
    check(qual <= 2e-2, f"{name} quality {qual}")
    check(torch.equal(pk.feat[7], pp.feat[7]), f"{name} mask row")
    say(f"  {name} (N={q_w.shape[0]}, C={pk.cx.shape[0]}): lane-major rows "
        f"exact, normal dot q01 {q01:.6f} (> 0.999), centroid {cen:.2e} "
        f"(2e-3), quality {qual:.2e} (2e-2); repeats bit for bit")
    return pk, pp, max(cen, qual, 1.0 - float(dots.min()))


def check_prep_point(cand, mask, q_w, r, name):
    """K3's point mode against its twin and ``prep_with_plane_pallas``'s
    point branch (feat zeros, quality -1, the mask; the lane-major rows):
    every output bit for bit, a second launch too. Returns (kernel output,
    largest difference from the twin)."""
    pk = cuda_gn.prep_with_plane(cand, mask, q_w, r, loss="point")
    pp = cuda_gn.prep_with_plane_torch(cand, mask, q_w, r, loss="point")
    again = cuda_gn.prep_with_plane(cand, mask, q_w, r, loss="point")
    err = max(float((a - b).abs().max()) for a, b in zip(pk, pp)
              if a.numel())
    check(all(torch.equal(a, b) for a, b in zip(pk, pp)),
          f"{name}: differs from its twin by {err}")
    check(all(torch.equal(a, b) for a, b in zip(pk, again)),
          f"{name} does not repeat bit for bit")
    check(bool((pk.feat[6] == -1).all()), f"{name}: quality row")
    say(f"  {name} (N={q_w.shape[0]}, C={pk.cx.shape[0]}): feat and "
        "lane-major rows bit for bit against the twin; repeats bit for bit")
    return pk, err


def check_loop(name, src, prepped, guess, kern, max_d2, conv, kw):
    """K4 (shaped by ``loop_plan``) against its twin at
    tests/test_pallas_icp.py:test_fused_loop_matches_xla_loop's bars
    (log-pose 5e-4, n_corr within max(3, 1 %), iterations within 2), and a
    second call bit for bit. Returns (log-pose error, kernel and twin
    n_corr and iterations, kernel call, twin call)."""

    def kern_loop():
        return cuda_icp.icp_loop(src, prepped, guess, kern, max_d2, conv,
                                 **kw)

    def plain_loop():
        return cuda_icp.icp_loop_torch(src, prepped, guess, kern, max_d2,
                                       conv, **kw)

    ok_, pl = kern_loop(), plain_loop()
    again = kern_loop()
    check(all(torch.equal(a, b) for a, b in zip(ok_, again)),
          f"{name} does not repeat bit for bit")
    d = float(torch.linalg.vector_norm(
        se3.log_pose(se3.inv(pl[0]) @ ok_[0])))
    nk, npl = int(ok_[1]), int(pl[1])
    ik, ip = int(ok_[2]), int(pl[2])
    check(d < 5e-4, f"{name} log-pose vs twin {d}")
    check(abs(nk - npl) <= max(3, int(0.01 * npl)),
          f"{name} n_corr {nk} vs {npl}")
    check(abs(ik - ip) <= 2, f"{name} iterations {ik} vs {ip}")
    say(f"  {name} (N={src.shape[0]}, C={prepped.cx.shape[0]}): "
        f"|log(twin^-1 kernel)| {d:.2e} (5e-4), n_corr {nk} vs {npl}, "
        f"iterations {ik} vs {ip}; repeats bit for bit")
    return d, nk, npl, ik, ip, kern_loop, plain_loop


def check_icp_streamed(dev, results):
    """K4's streamed variant at the CLI shapes (N = 8192, C = 80, too large
    to stage): cli_gn_scene's prepped candidates through the loop at
    cli_config's ICP settings, against the twin at check_loop's bars."""
    k = config.cli_config(128, 1024).kiss
    t, src, mask, cand = cli_gn_scene(dev)
    prepped = cuda_gn.prep_candidates(cand, mask)
    c, n = prepped.cx.shape
    plan = cuda_icp.loop_plan(n, c)
    check(not plan.staged, f"icp_loop plan at the CLI shapes {plan}")
    kw = dict(plane_min_quality=k.plane_min_quality,
              max_iterations=k.max_iterations,
              prior_rot_weight=k.prior_rot_weight,
              prior_trans_weight=k.prior_trans_weight)
    args = (src, prepped, t, torch.tensor(0.1667, device=dev),
            torch.tensor(2.25, device=dev), k.convergence_criterion, kw)
    d, nk, npl, ik, ip, kern_loop, plain_loop = check_loop(
        "icp_loop streamed", *args)
    check(npl > 1000, f"icp_loop streamed twin found {npl} correspondences")
    r = results["icp_loop"]
    r.update(max_abs_err=max(r["max_abs_err"], d),
             ms_streamed_cli=cuda_ms(kern_loop, 20),
             device_us_streamed_cli=kernel_us(kern_loop, "icp_loop"),
             plain_ms_streamed_cli=cuda_ms(plain_loop, 3),
             iterations_streamed_cli=ik, plan_streamed_cli=plan._asdict())


def tie_scene(dev, n=2044, c=32, seed=11):
    """Prepped candidates whose nearest rows tie exactly (n = 2044 leaves
    K5's last CTA and K4's last slice short): source points on
    a 1/8 m grid, candidate rows in pairs p + o and p - o with offsets on a
    1/16 m grid (every d2 exact, each pair's equal), a fifth of the rows
    invalid, half the points on the point-to-point branch (quality 0),
    where the winning row sets the residual."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-64, 65, (n, 3)) / 8.0
    off = rng.integers(-8, 9, (c // 2, n, 3)) / 16.0
    pts = np.empty((c, n, 3))
    pts[0::2], pts[1::2] = src + off, src - off
    inf = np.where(rng.uniform(size=(c, n)) < 0.2, 1e30, 0.0)
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    feat = np.concatenate([
        normal.T, (src + rng.normal(0, 0.01, (n, 3))).T,
        np.where(rng.uniform(size=n) < 0.5, 0.0, 0.9)[None],
        (rng.uniform(size=n) < 0.95)[None]])

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev).contiguous()

    prepped = cuda_gn.PreppedCandidates(
        f32(feat), f32(pts[..., 0]), f32(pts[..., 1]), f32(pts[..., 2]),
        f32(inf))
    return f32(src), prepped


def check_ties(dev):
    """K4 (one iteration, while the ties are exact) and K5 on
    :func:`tie_scene` against their twins: n_corr exact, K5's jtj and jtr
    within 1e-5 of their largest magnitude, K4's log-pose within 1e-4 (a
    last-row tie rule moves K5's jtr by 4x its magnitude and K4's pose by
    3e-3 here)."""
    src, prepped = tie_scene(dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    kern, max_d2 = (torch.tensor(v, device=dev) for v in (0.1667, 1.0))
    gk = cuda_gn.gn_prepped(eye, src, prepped, kern, max_d2,
                            plane_min_quality=0.2)
    gp = cuda_gn.gn_prepped_torch(eye, src, prepped, kern, max_d2,
                                  plane_min_quality=0.2)
    rel_j = float((gk[0] - gp[0]).abs().max() / gp[0].abs().max())
    rel_r = float((gk[1] - gp[1]).abs().max() / gp[1].abs().max())
    check(int(gk[2]) == int(gp[2]) and int(gp[2]) > 1000,
          f"gn_iter ties n_corr {int(gk[2])} vs {int(gp[2])}")
    check(rel_j <= 1e-5 and rel_r <= 1e-5,
          f"gn_iter ties jtj rel {rel_j}, jtr rel {rel_r}")
    kw = dict(plane_min_quality=0.2, max_iterations=1, prior_rot_weight=0.01,
              prior_trans_weight=0.01)
    lk = cuda_icp.icp_loop(src, prepped, eye, kern, max_d2, 1e-5, **kw)
    lp = cuda_icp.icp_loop_torch(src, prepped, eye, kern, max_d2, 1e-5, **kw)
    d = float(torch.linalg.vector_norm(se3.log_pose(se3.inv(lp[0]) @ lk[0])))
    check(int(lk[1]) == int(lp[1]) == int(gp[2]),
          f"icp_loop ties n_corr {int(lk[1])} vs {int(lp[1])}")
    check(d < 1e-4, f"icp_loop ties log-pose vs twin {d}")
    say(f"  ties (N={src.shape[0]}, C={prepped.cx.shape[0]}): gn_iter "
        f"n_corr {int(gk[2])} exact, jtj rel {rel_j:.2e}, jtr rel "
        f"{rel_r:.2e} (1e-5); icp_loop n_corr {int(lk[1])} exact, "
        f"|log(twin^-1 kernel)| {d:.2e} (1e-4)")


def gn_map(dev, pts, frame_voxel, voxel_size, capacity, ppv, new_capacity):
    """A map of ``pts`` deduplicated at ``frame_voxel``, inserted in
    chunks of ``new_capacity`` (the exact insert)."""
    pts = torch.tensor(pts, dtype=torch.float32, device=dev)
    frame, keep = voxel.first_in_voxel_sorted(
        pts, torch.ones(len(pts), dtype=torch.bool, device=dev), frame_voxel,
        len(pts))
    return hashmap.insert_deduped(
        hashmap.create(capacity, ppv, dev), frame, keep,
        voxel_size=voxel_size, max_probes=2, new_capacity=new_capacity)


def pallas_gn_scene(dev):
    """tests/test_pallas_gn.py's scene (its hash dedup replaced by the
    sort-based one): 40000 random points in a 2^14-slot map of 16 points
    per voxel, 4096 source points, 7-neighbourhood over 4 voxels."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-15, 15, (40000, 3))
    m = gn_map(dev, pts, 0.15, 0.3, 1 << 14, 16, 8192)
    n = 4096
    src = torch.tensor(rng.uniform(-14, 14, (n, 3)), dtype=torch.float32,
                       device=dev)
    mask = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    t = torch.eye(4, dtype=torch.float32, device=dev)
    t[:3, 3] = torch.tensor([0.05, -0.03, 0.02], device=dev)
    cand = icp.gather_candidates(
        m, se3.transform(t, src), voxel_size=0.3, max_probes=2,
        neighborhood=7, n_voxels=4, fit_planes=True, plane_radius=0.6)
    return t, src, mask, cand


def cli_map_scene(dev):
    """The CLI path's map and source: a floor and four walls in a 60 m
    box, a 2^19-slot map of 20 points per voxel at the 0.7 m voxel of a
    70 m clip, 8192 source points, a perturbed gather pose."""
    rng = np.random.default_rng(9)
    k = 60000
    floor = np.stack([rng.uniform(-30, 30, k), rng.uniform(-30, 30, k),
                      rng.normal(0, 0.02, k)], -1)
    walls = []
    for axis, at in ((0, -30.0), (0, 30.0), (1, -30.0), (1, 30.0)):
        w = np.stack([rng.uniform(-30, 30, k // 2), rng.uniform(-30, 30, k // 2),
                      rng.uniform(0, 5, k // 2)], -1)
        w[:, axis] = at + rng.normal(0, 0.02, k // 2)
        walls.append(w)
    pts = np.vstack([floor, *walls])
    m = gn_map(dev, pts, 0.35, 0.7, 1 << 19, 20, 8192)
    n = 8192
    idx = rng.choice(len(pts), n, replace=False)
    src = torch.tensor(pts[idx] + rng.normal(0, 0.01, (n, 3)),
                       dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.uniform(size=n) < 0.95, device=dev)
    t = se3.exp_twist(torch.tensor([0.002, -0.001, 0.003, 0.04, -0.03, 0.02],
                                   device=dev))
    return m, src, mask, t


def cli_gn_scene(dev):
    """The CLI path's shapes: :func:`cli_map_scene`'s candidates over the
    27-neighbourhood and 4 voxels (C = 80)."""
    m, src, mask, t = cli_map_scene(dev)
    cand = icp.gather_candidates(
        m, se3.transform(t, src), voxel_size=0.7, max_probes=2,
        neighborhood=27, n_voxels=4, fit_planes=True)
    return t, src, mask, cand


def check_gn_iter(dev, results):
    kern = torch.tensor(0.1667, device=dev)
    max_d2 = torch.tensor(2.25, device=dev)
    worst, times, bounds = 0.0, {}, {}
    cli = cli_gn_scene(dev)
    # the CLI shapes with the plane and with the point loss (loss="point":
    # quality -1, point rows only), tests/test_pallas_gn.py's scene
    for name, scene, loss in (("cli", cli, "plane"),
                              ("cli_point", cli, "point"),
                              ("test_pallas_gn", pallas_gn_scene(dev),
                               "plane")):
        t, src, mask, cand = scene
        prepped = cuda_gn.prep_candidates(cand, mask, loss=loss)
        c, n = prepped.cx.shape

        def kern_build():
            return cuda_gn.gn_prepped(t, src, prepped, kern, max_d2,
                                      plane_min_quality=0.2)

        def plain_build():
            return cuda_gn.gn_prepped_torch(t, src, prepped, kern, max_d2,
                                            plane_min_quality=0.2)

        (jk, rk, nk, wk), (jp, rp, np_, wp) = kern_build(), plain_build()
        rel_j = float((jk - jp).abs().max() / jp.abs().max())
        rel_r = float((rk - rp).abs().max() / rp.abs().max())
        rel_w = float((wk - wp).abs() / wp.abs())
        # bars of tests/test_pallas_gn.py:test_pallas_gn_parity
        check(int(nk) == int(np_) and int(np_) > 100,
              f"gn_iter ({name}) n_corr {int(nk)} vs {int(np_)}")
        check(rel_j < 1e-5, f"gn_iter ({name}) jtj rel {rel_j}")
        check(rel_r < 1e-5, f"gn_iter ({name}) jtr rel {rel_r}")
        check(rel_w <= 1e-5, f"gn_iter ({name}) total_w rel {rel_w}")
        again = kern_build()
        check(all(torch.equal(a, b) for a, b in zip(again, (jk, rk, nk, wk))),
              f"gn_iter ({name}) does not repeat bit for bit")
        worst = max(worst, float((jk - jp).abs().max()),
                    float((rk - rp).abs().max()), float((wk - wp).abs()))
        times[name] = (cuda_ms(kern_build, 200), cuda_ms(plain_build, 20),
                       kernel_us(kern_build, "gn_iter", 50))
        # one build: the source, feat and candidates once, ~8 operations
        # per candidate and ~120 per point
        bounds[name] = bound(nbytes(src, prepped, t), n * (8 * c + 120))
        say(f"  gn_iter {name} (N={n}, C={c}, {loss} loss): n_corr "
            f"{int(nk)} exact, jtj "
            f"rel {rel_j:.2e}, jtr rel {rel_r:.2e}, total_w rel {rel_w:.2e} "
            f"(1e-5); repeats bit for bit; {times[name][0]:.4f} ms vs twin "
            f"{times[name][1]:.4f} ms; kernel {times[name][2]:.2f} us on "
            f"the device")
    results["gn_iter"] = dict(
        max_abs_err=worst, ms=times["cli"][0], plain_ms=times["cli"][1],
        device_us=times["cli"][2], **bounds["cli"],
        ms_point=times["cli_point"][0], plain_ms_point=times["cli_point"][1],
        device_us_point=times["cli_point"][2],
        ms_test_shape=times["test_pallas_gn"][0],
        plain_ms_test_shape=times["test_pallas_gn"][1],
        device_us_test_shape=times["test_pallas_gn"][2])


def check_refresh_loop(dev):
    """register_frame_cached with candidate refresh, kernel form against
    twin form, on icp_scene (its guess drifts past the refresh threshold
    on the way to the solution)."""
    m, src, mask, guess = icp_scene(dev)
    kw = dict(voxel_size=0.3, max_probes=2, max_iterations=30,
              convergence=1e-5, plane_min_quality=0.2,
              prior_rot_weight=0.01, prior_trans_weight=0.01,
              neighborhood=27, n_voxels=4, plane_radius=0.6,
              refresh_drift=0.5)
    args = (src, mask, m, guess, torch.tensor(0.5, device=dev),
            torch.tensor(0.1667, device=dev))
    icp.reset_refresh_counts()
    kernels.reset_launches()
    rk = icp.register_frame_cached(*args, form="cuda", **kw)
    counts, builds = dict(icp.REFRESH_COUNTS), kernels.LAUNCHES["gn_iter"]
    rp = icp.register_frame_cached(*args, form="torch", **kw)
    d = float(torch.linalg.vector_norm(
        se3.log_pose(se3.inv(rp.pose) @ rk.pose)))
    nk, npl = int(rk.num_corr), int(rp.num_corr)
    ik, ip = int(rk.iterations), int(rp.iterations)
    # bars of tests/test_pallas_icp.py:test_fused_loop_matches_xla_loop
    check(counts["regathers"] >= 1, f"refresh loop re-gathered {counts}")
    check(builds == ik, f"refresh loop: {builds} K5 launches, {ik} "
          "iterations")
    check(counts["host_reads"] <= ik, f"refresh loop reads {counts}")
    check(d < 5e-4, f"refresh loop log-pose vs twin {d}")
    check(abs(nk - npl) <= max(3, int(0.01 * npl)),
          f"refresh loop n_corr {nk} vs {npl}")
    check(abs(ik - ip) <= 2, f"refresh loop iterations {ik} vs {ip}")
    check(npl > 1000, f"refresh loop twin found {npl} correspondences")
    say(f"  refresh loop: |log(twin^-1 kernel)| {d:.2e} (5e-4), n_corr {nk} "
        f"vs {npl}, iterations {ik} vs {ip}, re-gathers "
        f"{counts['regathers']}, host reads {counts['host_reads']}")


def fit_errors(got, ref, what: str) -> dict:
    """K3's phase-3 bars for the patch plane fit of ``got`` against
    ``ref`` (both PreppedCandidates): where the reference quality > 0.3,
    normal |dot| 1%-quantile > 0.999 and min > 0.995, centroid <= 2e-3,
    quality <= 2e-2; the mask row equal everywhere."""
    ok = ref.feat[6] > 0.3
    check(int(ok.sum()) > 100, f"{what}: {int(ok.sum())} plane fits > 0.3")
    dots = (got.feat[0:3, ok] * ref.feat[0:3, ok]).sum(0).abs()
    e = dict(q01=float(torch.quantile(dots, 0.01)), dot_min=float(dots.min()),
             centroid=float((got.feat[3:6, ok] - ref.feat[3:6, ok])
                            .abs().max()),
             quality=float((got.feat[6, ok] - ref.feat[6, ok]).abs().max()))
    check(e["q01"] > 0.999 and e["dot_min"] > 0.995,
          f"{what}: normal dots {e}")
    check(e["centroid"] <= 2e-3, f"{what}: centroid {e}")
    check(e["quality"] <= 2e-2, f"{what}: quality {e}")
    check(torch.equal(got.feat[7], ref.feat[7]), f"{what}: mask row")
    return e


def probed_meta_rows(vmap_, pts_w, voxel_size, max_probes,
                     neighborhood) -> int:
    """The distinct meta rows (32 bytes each) the select function needs for
    these points: per neighbour, the probes up to the first match (all of
    them without one)."""
    cap = vmap_.meta.shape[0]
    keys = voxel.voxel_coords(pts_w, voxel_size)[:, None, :] \
        + icp.neighbor_offsets(neighborhood, pts_w.device)[None]
    _, h0 = hashmap._fingerprint_and_slot(keys, cap)
    slot, _, _, found = hashmap.probe(vmap_, keys, max_probes, miss_slot=0)
    last = torch.where(found, (slot - h0) & (cap - 1), max_probes - 1)
    rows = torch.cat([((h0 + r) & (cap - 1))[last >= r]
                      for r in range(max_probes)])
    return int(torch.unique(rows).numel())


def needed_point_sectors(vmap_, aux) -> int:
    """The distinct 32-byte sectors of the points table that hold the
    stored points of the selected voxels (picks with count > 0)."""
    v = aux.shape[0] // 5
    row_bytes = 4 * vmap_.points.shape[1]
    used = aux[v:2 * v] > 0
    start = aux[:v].long()[used] * row_bytes
    lo = start // 32
    hi = (start + 4 * aux[v:2 * v].long()[used] - 1) // 32
    sec = lo[:, None] + torch.arange(row_bytes // 32 + 2, device=aux.device)
    return int(torch.unique(sec[sec <= hi[:, None]]).numel())


def gather_shapes(dev):
    """K6's shape sets: (name, map, source, mask, gather pose, kwargs)."""
    m, src, mask, guess = icp_scene(dev)
    bench = [(f"bench R={r}", m, src, mask, guess,
              dict(voxel_size=0.3, max_probes=r, neighborhood=7, n_voxels=4,
                   plane_radius=0.6)) for r in (1, 2)]
    cm, csrc, cmask, ct = cli_map_scene(dev)
    return bench + [("cli", cm, csrc, cmask, ct,
                     dict(voxel_size=0.7, max_probes=2, neighborhood=27,
                          n_voxels=4, plane_radius=1.05))]


def check_gather(dev, results):
    """K6's one launch against its twins on the card: the selection (aux)
    counts exact, slot and corner exact where count > 0, inf and the valid
    candidates bit for bit, the fit at K3's bars, the path's launch (no
    aux) and a repeated one bit for bit, the point-loss feat exact; the
    call and twin times and the kernel's device time."""
    for name, m, src, mask, t, kw in gather_shapes(dev):
        sel_kw = {k: kw[k] for k in ("voxel_size", "max_probes",
                                     "neighborhood", "n_voxels")}
        v, n = kw["n_voxels"], src.shape[0]
        r2 = cuda_gather.fused_radius2(kw["plane_radius"])
        pts_w = se3.transform(t, src).contiguous()

        def launch(loss="plane", aux=None):
            return cuda_gather.gather_fused(m, pts_w, mask, radius2=r2,
                                            loss=loss, aux=aux, **sel_kw)

        ak = torch.full((5 * v, n), -1, dtype=torch.int32, device=dev)
        gk = launch(aux=ak)
        ap = cuda_gather.select_voxels_torch(m, pts_w, **sel_kw)
        gp = cuda_gather.prep_selected_torch(
            m, pts_w, mask, ap, voxel_size=kw["voxel_size"], radius2=r2,
            loss="plane")
        cnt = ap[v:2 * v]
        check(torch.equal(ak[v:2 * v], cnt), f"gather_fused {name}: counts")
        used = (cnt > 0).repeat(4, 1)
        rows = torch.cat([ak[:v], ak[2 * v:]]), torch.cat([ap[:v], ap[2 * v:]])
        check(torch.equal(rows[0][used], rows[1][used]),
              f"gather_fused {name}: slot or corner where count > 0")
        # what the checks above compared: every count, slot and corner of
        # the picks with count > 0
        sel_err = float(torch.cat([(ak[v:2 * v] - cnt).flatten(),
                                   (rows[0] - rows[1])[used]]).abs().max())
        check(torch.equal(gk.inf, gp.inf), f"gather_fused {name}: inf")
        valid = gp.inf == 0
        check(int(valid.sum()) > 1000, f"gather_fused {name}: "
              f"{int(valid.sum())} valid candidates")
        for a, b, ax in ((gk.cx, gp.cx, "x"), (gk.cy, gp.cy, "y"),
                         (gk.cz, gp.cz, "z")):
            check(torch.equal(a[valid], b[valid]),
                  f"gather_fused {name}: candidate {ax} where valid")
        e = fit_errors(gk, gp, f"gather_fused {name}")
        ak2 = torch.full_like(ak, -2)
        again = launch(aux=ak2)
        path = cuda_gather.gather_prep_fused(m, src, mask, t, **kw)
        check(torch.equal(ak, ak2)
              and all(torch.equal(a, b) for a, b in zip(again, gk))
              and all(torch.equal(a, b) for a, b in zip(path, gk)),
              f"gather_fused {name} does not repeat bit for bit")
        pk = launch(loss="point")
        pp = cuda_gather.prep_selected_torch(
            m, pts_w, mask, ap, voxel_size=kw["voxel_size"], radius2=r2,
            loss="point")
        check(torch.equal(pk.feat, pp.feat) and torch.equal(pk.inf, pp.inf),
              f"gather_fused {name}: loss='point' feat rows")

        def kern_call():
            return cuda_gather.gather_prep_fused(m, src, mask, t, **kw)

        times = (cuda_ms(kern_call, 200), cuda_ms(
            lambda: cuda_gather.gather_prep_fused_torch(m, src, mask, t,
                                                        **kw), 20),
            kernel_us(kern_call, "gather_fused"))
        c = gk.cx.shape[0]
        rows_read = probed_meta_rows(m, pts_w, kw["voxel_size"],
                                     kw["max_probes"], kw["neighborhood"])
        sectors = needed_point_sectors(m, ap)
        # the query points and mask, each probed 32-byte meta row and each
        # sector of stored points of the picked voxels once, the candidates
        # and feat out; ~8 operations per neighbour, ~26 per candidate and
        # ~150 per point for the finish
        b = bound(nbytes(pts_w, mask, gk) + 32 * (rows_read + sectors),
                  n * (8 * kw["neighborhood"] + 26 * c + 150))
        err = max(e["centroid"], e["quality"], 1.0 - e["dot_min"], sel_err)
        say(f"  gather {name} (N={n}, J={kw['neighborhood']}, "
            f"R={kw['max_probes']}, C={c}): aux counts exact, slot/corner "
            f"exact where count > 0, inf and valid candidates exact, "
            f"normal dot q01 {e['q01']:.6f} min {e['dot_min']:.6f}, "
            f"centroid {e['centroid']:.2e}, quality {e['quality']:.2e}; "
            f"point-loss feat exact; repeats bit for bit, with and without "
            f"aux; whole aux equal {torch.equal(ak, ap)}; {rows_read} "
            f"distinct meta rows probed, {sectors} point sectors needed")
        say(f"    K6 call {times[0]:.4f} ms vs twin {times[1]:.4f} ms; "
            f"kernel {times[2]:.2f} us on the device (bound "
            f"{b['bound_ms'] * 1e3:.3f} us)")
        if name == "bench R=1":          # the bench path's shapes
            results["gather_fused"] = dict(
                max_abs_err=err, ms=times[0], plain_ms=times[1],
                device_us=times[2], **b)
        else:
            tag = name.replace(" ", "_").replace("=", "")
            r = results["gather_fused"]
            r.update({f"ms_{tag}": times[0], f"plain_ms_{tag}": times[1],
                      f"device_us_{tag}": times[2],
                      f"bound_ms_{tag}": b["bound_ms"]})
            r["max_abs_err"] = max(r["max_abs_err"], err)


def check_fused_registration(dev):
    """K6 -> K4 against gather_candidates -> K3 -> K4 on icp_scene, at
    tests/test_pallas_gather.py:100-124's bars (pose atol 2e-4,
    iterations within 2)."""
    m, src, mask, guess = icp_scene(dev)
    kw = dict(voxel_size=0.3, max_probes=2, max_iterations=30,
              convergence=1e-5, plane_min_quality=0.2,
              prior_rot_weight=0.01, prior_trans_weight=0.01,
              neighborhood=7, n_voxels=4, plane_radius=0.6, form="cuda")
    args = (src, mask, m, guess, torch.tensor(0.5, device=dev),
            torch.tensor(0.1667, device=dev))
    kernels.reset_launches()
    rf = icp.register_frame_cached(*args, fused_gather=True, **kw)
    fused = dict(kernels.LAUNCHES)
    ru = icp.register_frame_cached(*args, fused_gather=False, **kw)
    check(fused["gather_fused"] == 1 and fused["gn_prep"] == 0
          and fused["icp_loop"] == 1,
          f"fused registration launches {fused}")
    d = float((rf.pose - ru.pose).abs().max())
    i_f, i_u = int(rf.iterations), int(ru.iterations)
    check(d <= 2e-4, f"K6 -> K4 pose vs gather -> K3 -> K4: {d}")
    check(abs(i_f - i_u) <= 2, f"K6 -> K4 iterations {i_f} vs {i_u}")
    say(f"  K6 -> K4 vs gather -> K3 -> K4: max |pose diff| {d:.2e} "
        f"(2e-4), iterations {i_f} vs {i_u}, n_corr {int(rf.num_corr)} vs "
        f"{int(ru.num_corr)}")


def check_plane_moments(dev, results):
    """K7 against its twin at the bench and CLI shapes: the count row
    exact, the other rows within 1e-5 of each row's largest magnitude,
    rows 10-15 zero. Returns its launches in the checks (the timing
    loops' not counted)."""
    checked = 0
    cm, csrc, _, ct = cli_map_scene(dev)
    m, src, _, guess = icp_scene(dev)
    for name, (vm, s_, t, vs, nb, r) in (
            ("bench", (m, src, guess, 0.3, 7, 0.6)),
            ("cli", (cm, csrc, ct, 0.7, 27, 1.05))):
        q_w = se3.transform(t, s_)
        cand = icp.gather_candidates(vm, q_w, voxel_size=vs, max_probes=2,
                                     neighborhood=nb, n_voxels=4,
                                     fit_planes=False)
        cx, cy, cz, inf = cuda_gn.lane_major(cand)
        n = q_w.shape[0]
        ptq = torch.cat([q_w.T, torch.zeros((5, n), device=dev)]).contiguous()
        r2 = cuda_gn._radius2(r)
        before = kernels.LAUNCHES["plane_moments"]
        ok_ = cuda_gn.plane_moments(ptq, cx, cy, cz, inf, r2)
        checked += kernels.LAUNCHES["plane_moments"] - before
        op = cuda_gn.plane_moments_torch(ptq, cx, cy, cz, inf, r2)
        check(torch.equal(ok_[0], op[0]) and float(op[0].sum()) > 4 * n,
              f"plane_moments {name}: count row")
        rel = max(float((ok_[i] - op[i]).abs().max() / op[i].abs().max())
                  for i in range(1, 10))
        check(rel <= 1e-5, f"plane_moments {name}: rows 1-9 rel {rel}")
        check(bool((ok_[10:] == 0).all()), f"plane_moments {name}: pad rows")
        tk = cuda_ms(lambda: cuda_gn.plane_moments(ptq, cx, cy, cz, inf, r2),
                     200)
        tp = cuda_ms(lambda: cuda_gn.plane_moments_torch(
            ptq, cx, cy, cz, inf, r2), 20)
        c = cx.shape[0]
        # the kernel reads ptq's query rows 0-2 only
        b = bound(nbytes(ptq[:3], cx, cy, cz, inf, ok_), 20 * n * c)
        say(f"  plane_moments {name} (N={n}, C={c}): count row exact, rows "
            f"1-9 rel {rel:.2e} (1e-5), pad rows zero; {tk:.4f} ms vs twin "
            f"{tp:.4f} ms (bound {b['bound_ms'] * 1e3:.3f} us)")
        if name == "bench":
            results["plane_moments"] = dict(max_abs_err=rel, ms=tk,
                                            plain_ms=tp, **b)
        else:
            results["plane_moments"].update(
                max_abs_err=max(rel, results["plane_moments"]["max_abs_err"]),
                ms_cli=tk, plain_ms_cli=tp, bound_ms_cli=b["bound_ms"])
    return checked


# --------------------------------------------------------------- phase 4

def timed_run(c, batches, lut, dev, log=False, state=None):
    """One ``lio.run_sequence`` from ``state`` (default a fresh one) with
    host syncs made errors (the refresh loop lifts that for its counted
    reads only); returns (out, seconds)."""
    state = lio.init_state(c, dev) if state is None else state
    torch.cuda.synchronize()
    t = time.monotonic()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = lio.run_sequence(state, batches, lut, cfg=c, log=log)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, time.monotonic() - t


def run_main_path(n_scans: int, dev):
    """Phase 4; returns each kernel's launches in the timed run, the scene,
    the timed run's output and scans/s, and the largest difference between
    the warm-up's and the timed run's poses (0: they repeat bit for
    bit)."""
    t0 = time.monotonic()
    scene = sim.bench_scene(n_scans)
    sensor, scans, scan_ts, gt_mid, imu = scene
    say(f"  scene: {n_scans} scans of {scans.shape[1]}x{scans.shape[2]} "
        f"ready in {time.monotonic() - t0:.1f} s")
    cfg = config.bench_config()
    lut = convert.lut_from_numpy(sensor.lut, dev)
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu.ts, device=dev)

    def timed(c):
        return timed_run(c, batches, lut, dev)

    warm, _ = timed(cfg)                        # warm-up
    kernels.reset_launches()
    out, dt = timed(cfg)
    launches = launch_counts()
    repeat = max(float((getattr(warm, f) - getattr(out, f)).abs().max())
                 for f in ("kiss_pose", "ekf_pose"))
    for name, count in launches.items():
        # K1-K4 once a scan; K5 (refresh), K6 (fused gather), K7 never
        want = n_scans if name in ("ekf_predict", "ekf_update", "gn_prep",
                                   "icp_loop") else 0
        check(count == want,
              f"{name} launched {count} times in {n_scans} scans")
    kp = out.kiss_pose.double().cpu().numpy()
    check(bool(np.isfinite(kp).all()), "non-finite poses")
    check(kp.shape == (n_scans, 4, 4), f"pose shape {kp.shape}")
    _, ate = metrics.calc_ate_rmse(kp, gt_mid)
    check(ate <= ATE_GATE_M, f"ATE RMSE {ate:.4f} m > {ATE_GATE_M} m")
    ref = np.loadtxt(REF_POSES).reshape(-1, 3, 4)[:n_scans]
    ref_err = np.linalg.norm(kp[:, :3, 3] - ref[:, :, 3], axis=1)
    check(float(ref_err.max()) <= POSE_GATE_M,
          f"pose vs JAX reference {ref_err.max():.4f} m > {POSE_GATE_M} m")
    say(f"  kernel path: {n_scans / dt:.2f} scans/s ({dt:.3f} s), ATE RMSE "
        f"{ate:.4f} m (<= {ATE_GATE_M}), max |pose - JAX| "
        f"{ref_err.max():.4f} m (<= {POSE_GATE_M}), no host sync, "
        f"launches {launches}; the warm-up's poses "
        + ("repeat bit for bit" if repeat == 0 else
           f"DIFFER by up to {repeat:.3e} (a fault: whole runs should "
           "repeat bit for bit)"))

    tcfg = config.twin_config(cfg)
    lio.run_sequence(lio.init_state(tcfg, dev),
                     lio.scan_at(batches, slice(0, 4)), lut,
                     cfg=tcfg)                          # warm-up
    kernels.reset_launches()
    out_t, dt_t = timed(tcfg)
    check(sum(kernels.LAUNCHES.values()) == 0, "twin path launched kernels")
    kt = out_t.kiss_pose.double().cpu().numpy()
    _, ate_t = metrics.calc_ate_rmse(kt, gt_mid)
    say(f"  twin path: {n_scans / dt_t:.2f} scans/s ({dt_t:.3f} s), ATE "
        f"RMSE {ate_t:.4f} m, max |pose - kernel path| "
        f"{np.linalg.norm(kt[:, :3, 3] - kp[:, :3, 3], axis=1).max():.4f} m")
    return launches, scene, out, n_scans / dt, repeat


# --------------------------------------------------------------- phase 7

def run_log_path(scene, n_scans: int, dev, bench_out, bench_rate,
                 repeat: float) -> dict[str, int]:
    """Phase 7c: ``bench_config()`` with ``log=True``: K1 writes the
    history (once a scan, no twin step), the carried poses are phase 4's
    (bit for bit, or within the difference phase 4's two runs showed),
    one knot a scan with samples at its last valid slot holding the scan's
    EKF pose, and the flattened log rises in time. Returns the launches."""
    sensor, scans, scan_ts, gt_mid, imu = scene
    cfg = config.bench_config()
    lut = convert.lut_from_numpy(sensor.lut, dev)
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu.ts, device=dev)
    timed_run(cfg, batches, lut, dev, log=True)    # warm-up
    twin_steps = [0]
    step = esekf.process_imu

    def counted(*a, **kw):
        twin_steps[0] += 1
        return step(*a, **kw)

    kernels.reset_launches()
    esekf.process_imu = counted
    try:
        out, dt = timed_run(cfg, batches, lut, dev, log=True)
    finally:
        esekf.process_imu = step
    launches = launch_counts()
    for name, count in launches.items():
        want = 0 if name in ("gn_iter", "gather_fused", "plane_moments") \
            else n_scans
        check(count == want,
              f"{name} launched {count} times in {n_scans} logged scans")
    check(twin_steps[0] == 0, f"{twin_steps[0]} twin predict steps ran")
    diff = max(float((getattr(out, f) - getattr(bench_out, f)).abs().max())
               for f in ("kiss_pose", "ekf_pose"))
    check(diff <= repeat, f"logged poses differ from phase 4's by {diff} "
          f"(phase 4's two runs: {repeat})")
    flog = out.flog
    k = cfg.max_imu_per_scan
    check(flog.pos.shape == (n_scans, k, 3)
          and flog.cov_diag.shape == (n_scans, k, 18),
          f"flog shapes {flog.pos.shape} {flog.cov_diag.shape}")
    valid = batches.imu_valid
    upd = flog.updated
    has = valid.any(1)
    last = valid.sum(1) - 1
    rows = torch.arange(n_scans, device=dev)
    check(torch.equal(upd.sum(1), has.long())
          and bool(upd[rows[has], last[has]].all()),
          "knots: not one a scan with samples at its last valid slot")
    check(torch.equal(flog.pos[rows[has], last[has]],
                      out.ekf_pose[has, :3, 3]),
          "knot positions differ from the scans' EKF poses")
    flat = lio.flatten_filter_log(flog, valid)
    n_valid = int(valid.sum())
    check(len(flat.ts) == n_valid and bool((np.diff(flat.ts) > 0).all()),
          f"flattened log: {len(flat.ts)} entries of {n_valid}, ts rising "
          f"{bool((np.diff(flat.ts) > 0).all())}")
    say(f"  7c bench_config, log=True: {n_scans / dt:.2f} scans/s ({dt:.3f} "
        f"s; phase 4 in this call {bench_rate:.2f}), poses "
        + ("bit-equal to phase 4's" if diff == 0 else
           f"within {diff:.3e} of phase 4's") + f", flog [{n_scans}, {k}], "
        f"{int(upd.sum())} knots, {n_valid} flattened entries rising in "
        f"time, no twin step, no host sync, launches {launches}")
    return launches


def run_filter_path(dev) -> dict[str, int]:
    """Phase 7d: ``esekf.run_filter`` at ``ekf-bench sim``'s defaults (2 s
    at 100 Hz, noise 0.4 / 0.4, seed 42, a pose update every 10 steps at
    the noise-free run's poses) on the card with the op-chain update and
    with K2, each against the CPU run at tests/test_esekf.py:364-376's
    bars (pos, vel, quat, bias_gyr, grav 1e-5, cov rtol 1e-4 atol 1e-5;
    bias_acc 3e-5 as in tests/test_torch_ekf_forms.py). Every run takes the
    CPU's noise-free poses. Returns the K2 run's launches."""
    n, every = 200, 10
    idx = torch.arange(n)
    corr = (idx % every == 0) & (idx > 0)

    def run(device, update_form, gt=None):
        ideal, noisy = sim.sim_imu_arrays(42, n, acc_noise_std=0.4,
                                          gyr_noise_std=0.4, device=device)
        cfg = config.EkfConfig(update_form=update_form)
        if gt is None:
            _, log_gt = esekf.run_filter(
                esekf.init_state(cfg, device),
                ideal, torch.zeros(n, dtype=torch.bool, device=device),
                torch.eye(4, device=device).repeat(n, 1, 1), cfg=cfg)
            return se3.make_pose(so3.quat_to_mat(log_gt.att_q), log_gt.pos)
        return esekf.run_filter(esekf.init_state(cfg, device), noisy,
                                corr.to(device), gt.to(device), cfg=cfg)

    gt = run("cpu", "xla")
    s_ref, log_ref = run("cpu", "xla", gt)
    gt_dev = float((run(dev, "xla").cpu() - gt).abs().max())
    launches = None
    for form in ("xla", "cuda"):
        run(dev, form, gt)                      # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.monotonic()
        s_, log_ = run(dev, form, gt)
        torch.cuda.synchronize()
        dt = time.monotonic() - t
        got = launch_counts()
        want = {"ekf_update": n if form == "cuda" else 0}
        check(all(c == want.get(k, 0) for k, c in got.items()),
              f"7d update_form={form}: launches {got}")
        errs = {f: float((getattr(log_, f).cpu() - getattr(log_ref, f))
                         .abs().max())
                for f in ("pos", "vel", "bias_gyr", "bias_acc", "grav")}
        errs["quat"] = float(torch.minimum(
            (log_.att_q.cpu() - log_ref.att_q).abs().amax(1),
            (log_.att_q.cpu() + log_ref.att_q).abs().amax(1)).max())
        check(max(v for f, v in errs.items() if f != "bias_acc") <= 1e-5
              and errs["bias_acc"] <= 3e-5,
              f"7d update_form={form} vs the CPU run: {errs}")
        check(torch.allclose(log_.cov_diag.cpu(), log_ref.cov_diag,
                             rtol=1e-4, atol=1e-5)
              and torch.allclose(s_.cov.cpu(), s_ref.cov, rtol=1e-4,
                                 atol=1e-5),
              f"7d update_form={form}: covariance vs the CPU run")
        check(torch.equal(log_.updated.cpu(), corr)
              and torch.equal(log_.ts.cpu(), log_ref.ts),
              f"7d update_form={form}: updated or ts differ")
        say(f"  7d run_filter, update_form={form!r}: {n} steps in {dt:.3f} "
            f"s, max |card - CPU| over the history {errs} (1e-5; bias_acc "
            f"3e-5), cov rtol 1e-4 atol 1e-5, {int(corr.sum())} updates, "
            f"launches {got}")
        if form == "cuda":
            launches = got
    say(f"  7d noise-free run on the card (not gated): max |card - CPU| "
        f"pose entry {gt_dev:.3e}")
    return launches


# ---------------------------------------- phases 5-8: one path's run

def reference_ate(path: str) -> float:
    """The JAX ATE RMSE a reference poses file states in its header."""
    with open(path) as f:
        for line in f:
            if "JAX ATE RMSE" in line:
                return float(line.split(":")[1].split()[0])
    raise ValueError(f"{path}: no JAX ATE RMSE in the header")


def ref_poses(name: str) -> tuple[str, np.ndarray]:
    """(path, [N, 3, 4]) of ``tests/data/<name>_jax_poses.txt``."""
    path = os.path.join(HERE, "tests", "data", f"{name}_jax_poses.txt")
    return path, np.loadtxt(path).reshape(-1, 3, 4)


def busy_us(events) -> float:
    """Length of the union of the device intervals of ``events`` (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def device_window(run, n_scans: int) -> dict:
    """Device busy us a scan (the union of the device intervals in a
    ``torch.profiler`` trace) and device operations (kernels, copies and
    fills) a scan over ``run()``, which runs ``n_scans`` scans."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(busy_us_per_scan=busy_us(ev) / n_scans,
                device_ops_per_scan=len(ev) / n_scans)


def lio_warm_up(cfg, batches, lut, dev, state, window: int) -> dict:
    """A phase-8 run's warm-up: its first scans, then its last ``window``
    scans from there (the steady step, as in an unbroken run) under the
    profiler; returns :func:`device_window`'s numbers."""
    n = batches.range_m.shape[0]
    k = n - window
    state = lio.init_state(cfg, dev) if state is None else state
    state, _ = lio.run_sequence(state, lio.scan_at(batches, slice(0, k)),
                                lut, cfg=cfg)
    tail = dataclasses.replace(cfg, bootstrap_scans=0)
    return device_window(lambda: lio.run_sequence(
        state, lio.scan_at(batches, slice(k, n)), lut, cfg=tail), window)


def run_option_path(scene, dev, cfg, tag: str, ref_name: str, want, *,
                    card: str, batches=None, state=None, rows=None,
                    ate_slack=None, ate_max=None, twins: bool = False,
                    window: int = 10):
    """A run of ``cfg`` on the bench scene (phases 5-8): ``batches`` and
    the start ``state`` when given, else the scans the JAX poses
    ``tests/data/<ref_name>_jax_poses.txt`` hold from a fresh state. The
    warm-up with its last ``window`` scans profiled, then a run timed with
    host syncs made errors (the counted reads of ``icp.read_flags``
    excepted). Gates: each kernel launched ``want(n, gn_iterations)[name]``
    times (0 when absent), at most one host read a GN iteration and scan,
    every pose finite and within 0.02 m of the JAX poses (their ``rows``),
    with ``ate_slack`` the ATE RMSE within that of the JAX run's, with
    ``ate_max`` at most that. With ``twins`` the same run with every kernel
    replaced by its twin (no launch). Returns (launches, output,
    summary)."""
    sensor, scans, scan_ts, gt_mid, imu = scene
    ref_path, ref = ref_poses(ref_name)
    lut = convert.lut_from_numpy(sensor.lut, dev)
    if batches is None:
        k = min(len(scans), len(ref))
        batches = lio.scan_at(lio.build_batches(
            cfg, scans, scan_ts, imu.lacc, imu.avel, imu.ts, device=dev),
            slice(0, k))
    n = batches.range_m.shape[0]
    window = min(window, n // 2)
    rows = slice(0, n) if rows is None else rows
    ref, gt = ref[rows], gt_mid[rows]
    busy = lio_warm_up(cfg, batches, lut, dev, state, window)
    kernels.reset_launches()
    icp.reset_refresh_counts()
    out, dt = timed_run(cfg, batches, lut, dev, state=state)
    launches, counts = launch_counts(), dict(icp.REFRESH_COUNTS)
    reads = counts["host_reads"]
    iters = int(out.aux.iterations.sum())
    expect = want(n, iters)
    check(all(c == expect.get(k, 0) for k, c in launches.items()),
          f"{tag}: launches {launches} in {n} scans, {iters} GN "
          f"iterations, want {expect}")
    check(reads <= iters + n, f"{tag}: {reads} host reads")
    kp = out.kiss_pose.double().cpu().numpy()
    check(bool(np.isfinite(kp).all()) and kp.shape == (n, 4, 4),
          f"{tag}: poses {kp.shape}, finite {np.isfinite(kp).all()}")
    check(bool(out.scan_valid.all()), f"{tag}: a scan was skipped")
    err = np.linalg.norm(kp[:, :3, 3] - ref[:, :, 3], axis=1)
    check(float(err.max()) <= POSE_GATE_M,
          f"{tag}: pose vs JAX reference {err.max():.4f} m > "
          f"{POSE_GATE_M} m")
    _, ate = metrics.calc_ate_rmse(kp, gt)
    jax_ate = reference_ate(ref_path)
    if ate_slack is not None:
        check(ate <= jax_ate + ate_slack,
              f"{tag}: ATE RMSE {ate:.4f} m > JAX {jax_ate:.4f} + "
              f"{ate_slack} m")
    if ate_max is not None:
        check(ate <= ate_max, f"{tag}: ATE RMSE {ate:.4f} m > {ate_max} m")
    ran = {k: v / n for k, v in launches.items() if v}
    summary = dict(path=tag, scans=n, scans_per_s=n / dt,
                   max_pose_vs_jax_m=float(err.max()), ate_rmse_m=ate,
                   jax_ate_rmse_m=jax_ate, gn_iterations=iters,
                   host_reads=reads, regathers=counts["regathers"],
                   kernel_launches_per_scan=ran, **busy, card=card)
    say(f"  {tag}: {n} scans, {n / dt:.2f} scans/s ({dt:.3f} s), device "
        f"busy {busy['busy_us_per_scan']:.1f} us and "
        f"{busy['device_ops_per_scan']:.1f} device operations a scan (the "
        f"last {window} scans), ATE RMSE {ate:.4f} m (JAX run "
        f"{jax_ate:.4f}), max |pose - JAX| {err.max():.4f} m (<= "
        f"{POSE_GATE_M}), {iters} GN iterations, {counts['regathers']} "
        f"re-gathers, {reads} host reads (<= {iters + n}), no other host "
        f"sync, hand kernels a scan {ran}; {card}")
    if twins:
        tcfg = config.twin_config(cfg)
        lio.run_sequence(lio.init_state(tcfg, dev) if state is None
                         else state, lio.scan_at(batches, slice(0, 4)), lut,
                         cfg=tcfg)                      # warm-up
        kernels.reset_launches()
        out_t, dt_t = timed_run(tcfg, batches, lut, dev, state=state)
        check(sum(kernels.LAUNCHES.values()) == 0,
              f"{tag}: the twin path launched kernels")
        kt = out_t.kiss_pose.double().cpu().numpy()
        _, ate_t = metrics.calc_ate_rmse(kt, gt)
        say(f"  {tag} twin path: {n / dt_t:.2f} scans/s ({dt_t:.3f} s), "
            f"ATE RMSE {ate_t:.4f} m, max |pose - kernel path| "
            f"{np.linalg.norm(kt[:, :3, 3] - kp[:, :3, 3], axis=1).max():.4f}"
            " m")
    return launches, out, summary


def run_cli_path(scene, dev, card: str):
    """Phase 5: ``cli_config(128, 1024)`` through :func:`run_option_path`,
    with the twins; returns (launches, output)."""
    h, w = scene[1].shape[1:]
    cli = config.cli_config(h, w)
    launches, out, _ = run_option_path(
        scene, dev, cli, "5 cli", "cli", cli_want(cli), card=card,
        ate_slack=CLI_ATE_SLACK_M, twins=True)
    return launches, out


def run_kiss_paths(scene, dev, card: str):
    """Phases 7a and 7b: ``cli_config(128, 1024, guess="kiss")`` (with the
    twins) and the same with ``predict_batch="assoc"``, each on the 15
    scans of ``cli_kiss_jax_poses.txt``; returns (launches by cell, 7b's
    output)."""
    h, w = scene[1].shape[1:]
    kiss_cfg = config.cli_config(h, w, guess="kiss")
    launches = {}
    launches["cli_kiss"], _, _ = run_option_path(
        scene, dev, kiss_cfg, "7a cli kiss", "cli_kiss", cli_want(kiss_cfg),
        card=card, ate_slack=CLI_ATE_SLACK_M, twins=True)
    assoc = dataclasses.replace(kiss_cfg, ekf=dataclasses.replace(
        kiss_cfg.ekf, predict_batch="assoc"))
    launches["cli_kiss_assoc"], out, _ = run_option_path(
        scene, dev, assoc, "7b cli kiss assoc", "cli_kiss", cli_want(assoc),
        card=card, ate_slack=CLI_ATE_SLACK_M)
    return launches, out


def cli_want(cfg):
    """``want`` of the refresh-loop paths: K1 once a scan (none with the
    associative predict), K5 once a GN iteration."""
    k1 = cfg.ekf.predict_batch == "cuda"
    return lambda n, iters: {"ekf_predict": n if k1 else 0,
                             "gn_iter": iters}


def once_a_scan(*names):
    """``want`` for kernels launched once a scan each."""
    return lambda n, iters: {k: n for k in names}


# --------------------------------------------------------------- phase 8

def run_frozen_path(scene, dev, bench_out, card: str):
    """Phase 8c: ``bench_config()`` maps scans 0..split-1 (bit-equal to
    phase 4's first scans), the state goes through ``checkpoint.save_state``
    (with ``time_origin`` and ``end_scan_ts``) and ``load_state`` into a
    fresh state, and the rest of the scans run with ``map_frozen=True`` on
    batches built on the checkpoint's clock (``prev_scan_ts``), as
    ``ekf-bench ouster --save-state`` and then ``--resume-state
    --frozen-map`` do: the map after the frozen run is the loaded one bit
    for bit, and the poses are within 0.02 m of JAX's same two-step run.
    The same resume without freezing (``bootstrap_scans=0``) is phase 4's
    unbroken run bit for bit."""
    sensor, scans, scan_ts, gt_mid, imu = scene
    n = len(scans)
    split = min(25, n // 2)       # the reference's 25 at the 50-scan scene
    cfg = config.bench_config()
    lut = convert.lut_from_numpy(sensor.lut, dev)
    origin = lio.time_origin(scan_ts[:split], imu.ts)
    head = lio.build_batches(cfg, scans[:split], scan_ts[:split], imu.lacc,
                             imu.avel, imu.ts, time_origin=origin,
                             device=dev)
    fin, out_head = lio.run_sequence(lio.init_state(cfg, dev), head, lut,
                                     cfg=cfg)
    check(torch.equal(out_head.kiss_pose, bench_out.kiss_pose[:split]),
          "8c: the mapping scans differ from phase 4's")
    _, ref = ref_poses("bench_frozen")
    kp = out_head.kiss_pose.double().cpu().numpy()
    err_head = np.linalg.norm(kp[:, :3, 3] - ref[:split, :, 3], axis=1)
    check(float(err_head.max()) <= POSE_GATE_M,
          f"8c: mapping pose vs JAX {err_head.max():.4f} m")
    frozen = dataclasses.replace(cfg, map_frozen=True)
    resume = dataclasses.replace(cfg, bootstrap_scans=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_state(path, fin, extra={
            "end_scan_ts": float(scan_ts[split - 1]),
            "time_origin": float(origin)})
        extra = checkpoint.checkpoint_extra(path)
        loaded = checkpoint.load_state(path, lio.init_state(frozen, dev))
        again = checkpoint.load_state(path, lio.init_state(resume, dev))

    def tail(c):
        return lio.build_batches(
            c, scans[split:], scan_ts[split:], imu.lacc, imu.avel, imu.ts,
            time_origin=extra["time_origin"],
            prev_scan_ts=extra["end_scan_ts"], device=dev)

    launches, out, summary = run_option_path(
        scene, dev, frozen, "8c frozen map", "bench_frozen",
        once_a_scan("ekf_predict", "gn_prep", "icp_loop", "ekf_update"),
        card=card, batches=tail(frozen), state=loaded,
        rows=slice(split, n))
    fin_frozen, _ = lio.run_sequence(loaded, tail(frozen), lut, cfg=frozen)
    check(torch.equal(fin_frozen.kiss.local_map.meta,
                      loaded.kiss.local_map.meta)
          and torch.equal(fin_frozen.kiss.local_map.points,
                          loaded.kiss.local_map.points),
          "8c: the frozen run changed the map")
    check(int(fin_frozen.kiss.num_scans) == n, "8c: num_scans")
    _, out_resume = lio.run_sequence(again, tail(resume), lut, cfg=resume)
    check(torch.equal(out_resume.kiss_pose, bench_out.kiss_pose[split:])
          and torch.equal(out_resume.ekf_pose, bench_out.ekf_pose[split:]),
          "8c: save -> load -> continue differs from phase 4's run")
    say(f"  8c: map after the frozen run bit-equal to the loaded one; "
        f"mapping scans bit-equal to phase 4's (max |pose - JAX| "
        f"{err_head.max():.4f} m); the unfrozen resume bit-equal to phase "
        "4's unbroken run")
    return launches, summary


def run_kiss_every(scene, dev, card: str, window: int = 5):
    """Phase 8f: ``kiss.register_scan`` alone, scan after scan, at
    ``KissConfig()``'s defaults with ``nn_mode="every"`` and
    ``loss="point"`` (a map query every GN iteration, plain torch as in the
    JAX package), no range-image grid, the constant-velocity guess and
    deskew, on the scans ``tests/data/kiss_every_jax_poses.txt`` holds (the
    JAX run leaves the track after them): no kernel launches, at most one
    host read a GN iteration, every pose within 0.02 m of JAX's."""
    sensor, scans, scan_ts, gt_mid, imu = scene
    ref_path, ref = ref_poses("kiss_every")
    n = min(len(ref), len(scans))
    ref, window = ref[:n], min(window, n // 2)
    kcfg = config.KissConfig(nn_mode="every", loss="point")
    cap = config.Capacity(max_points=scans.shape[1] * scans.shape[2])
    lut = convert.lut_from_numpy(sensor.lut, dev)
    ranges = torch.tensor(scans[:n], dtype=torch.float32, device=dev)

    def run(k0, k1, state=None):
        state = kiss.init_state(kcfg, cap, dev) if state is None else state
        poses, iters = [], []
        for i in range(k0, k1):
            state, pose, aux = kiss.register_scan(
                state, *scan_to_points(lut, ranges[i]), cfg=kcfg, cap=cap)
            poses.append(pose)
            iters.append(aux.iterations)
        return state, torch.stack(poses), torch.stack(iters)

    state, _, _ = run(0, n - window)
    busy = device_window(lambda: run(n - window, n, state), window)
    kernels.reset_launches()
    icp.reset_refresh_counts()
    torch.cuda.synchronize()
    t = time.monotonic()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, poses, iters = run(0, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.monotonic() - t
    launches, reads = launch_counts(), icp.REFRESH_COUNTS["host_reads"]
    n_it = int(iters.sum())
    check(sum(launches.values()) == 0, f"8f: kernels launched {launches}")
    check(reads <= n_it, f"8f: {reads} host reads, {n_it} iterations")
    kp = poses.double().cpu().numpy()
    check(bool(np.isfinite(kp).all()), "8f: non-finite poses")
    err = np.linalg.norm(kp[:, :3, 3] - ref[:, :, 3], axis=1)
    check(float(err.max()) <= POSE_GATE_M,
          f"8f: pose vs JAX reference {err.max():.4f} m")
    _, ate = metrics.calc_ate_rmse(kp, gt_mid[:n])
    summary = dict(path="8f kiss every", scans=n, scans_per_s=n / dt,
                   max_pose_vs_jax_m=float(err.max()), ate_rmse_m=ate,
                   jax_ate_rmse_m=reference_ate(ref_path),
                   gn_iterations=n_it, host_reads=reads,
                   kernel_launches_per_scan={}, **busy, card=card)
    say(f"  8f kiss every ({n} scans): {n / dt:.2f} scans/s ({dt:.3f} s), "
        f"device busy {busy['busy_us_per_scan']:.1f} us and "
        f"{busy['device_ops_per_scan']:.1f} device operations a scan (the "
        f"last {window} scans), ATE RMSE {ate:.4f} m (JAX run "
        f"{summary['jax_ate_rmse_m']:.4f}), max |pose - JAX| "
        f"{err.max():.4f} m (<= {POSE_GATE_M}), {n_it} GN iterations, "
        f"{reads} host reads (one a GN iteration at most), no kernel; "
        f"{card}")
    return launches, summary


def run_phase8(scene, dev, bench_out, card: str
               ) -> dict[str, dict[str, int]]:
    """Phase 8: the options the port carries since the bring-up of the
    point loss, frozen-map localisation on a checkpoint, column
    decimation, the octant gather and the every-iteration query. Returns
    each run's launches; prints one JSON line of the runs' summaries."""
    sensor, scans, scan_ts, gt_mid, imu = scene
    h, w = scans.shape[1:]
    R = dataclasses.replace
    bench = config.bench_config()
    by_path, summaries = {}, []

    def kiss_cfg(base, **kw):
        return R(base, kiss=R(base.kiss, **kw))

    cli = config.cli_config(h, w)
    by_path["cli_point"], _, sm = run_option_path(
        scene, dev, kiss_cfg(cli, loss="point"), "8a cli point",
        "cli_point", cli_want(cli), card=card, ate_slack=CLI_ATE_SLACK_M)
    summaries.append(sm)
    outs = []
    for fused, name in ((False, "bench_point"), (True, "bench_point_fused")):
        want = (once_a_scan("ekf_predict", "gather_fused", "icp_loop",
                            "ekf_update") if fused else
                once_a_scan("ekf_predict", "gn_prep", "icp_loop",
                            "ekf_update"))
        by_path[name], out, sm = run_option_path(
            scene, dev, kiss_cfg(bench, loss="point", fused_gather=fused),
            f"8b bench point{' fused' if fused else ''}", "bench_point",
            want, card=card)
        outs.append(out.kiss_pose.double().cpu().numpy())
        summaries.append(sm)
    gap = float(np.abs(outs[0] - outs[1])[:, :3, 3].max())
    say(f"  8b: max |pose(fused) - pose(gather + K3)| {gap:.3e} m")
    by_path["bench_frozen"], sm = run_frozen_path(scene, dev, bench_out,
                                                  card)
    summaries.append(sm)
    by_path["bench_dec2"], _, sm = run_option_path(
        scene, dev, R(bench, col_decimation=2), "8d column decimation 2",
        "bench_dec2",
        once_a_scan("ekf_predict", "gn_prep", "icp_loop", "ekf_update"),
        card=card)
    summaries.append(sm)
    # the octant gather with fused_gather=True: the gather and K3, never K6
    by_path["bench_nn4"], _, sm = run_option_path(
        scene, dev, kiss_cfg(bench, nn_neighborhood=4, fused_gather=True),
        "8e octant gather (fused_gather=True)", "bench_nn4",
        once_a_scan("ekf_predict", "gn_prep", "icp_loop", "ekf_update"),
        card=card)
    summaries.append(sm)
    by_path["kiss_every"], sm = run_kiss_every(scene, dev, card)
    summaries.append(sm)
    say(json.dumps({"phase8": summaries}))
    return by_path


# --------------------------------------------------------------- phase 9

def run_recording_path(scene, dev, card: str) -> dict[str, dict[str, int]]:
    """Phase 9: the recording path through the port's command line. The
    bench scene is written as an Ouster recording (``tools/
    make_torch_fixture.py``'s ``bench`` writer: a LEGACY pcap, 1024x10, IP-
    fragmented, epoch timestamps, its metadata and ground truth) into a
    temp dir, decoded by the native and the numpy decoders (the same
    arrays; both times printed, set-up not step time), then run through
    ``ekf-bench ouster --use-imu-prediction -g gt.csv --save-kitti-poses``
    on the card in batch (its two runs: K1 once a scan, K5 once a GN
    iteration, K2, K3, K4 and K6 never; the native decoder) and with
    ``--online`` (K1 once a scan, K5 once a GN iteration; poses bit-equal
    to the batch run's, else the largest difference and the first scan
    where they part are printed), and ``stat`` on the same file. Every
    pose within 0.02 m of ``tests/data/cli_pcap_jax_poses.txt`` and the
    printed ATE RMSE within the JAX run's + 0.005 m. Prints one JSON line
    of the decode times, scans/s and latencies with the card. Returns the
    launches of the batch and the online runs."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import make_torch_fixture
    from ptudes_tpu_torch import native
    from ptudes_tpu_torch.cli import main as cli
    from ptudes_tpu_torch.io import metadata, sources

    sensor = scene[0]
    ref_path, ref = ref_poses("cli_pcap")
    jax_ate = reference_ate(ref_path)
    tmp = tempfile.mkdtemp(prefix="ptudes_rec_")
    try:
        t = time.monotonic()
        rec, meta, gt = make_torch_fixture.bench(tmp, scene=scene)
        t_write = time.monotonic() - t
        rec_bytes = os.path.getsize(rec)
        info = metadata.read_metadata_json(meta)
        lut = cli.nav_frame_lut(info, dev)
        want = convert.lut_from_numpy(sensor.lut, dev)
        check(all(torch.equal(a, b) for a, b in zip(lut, want)),
              "9: the recording's LUT is not the scene sensor's")
        # the library builds at first use: build it before the timed
        # decodes, which alternate (native, numpy, native, numpy)
        t = time.monotonic()
        check(native.get_lib() is not None, "9: the native decoder did "
              "not build")
        native_build_s = time.monotonic() - t
        decode, first = {"native": [], "numpy": []}, None
        for name in ("native", "numpy") * 2:
            ctx = native.numpy_only() if name == "numpy" \
                else contextlib.nullcontext()
            with ctx:
                t = time.monotonic()
                scans, imu = sources.read_packet_source(rec, info)
                decode[name].append(time.monotonic() - t)
                check(native.backend() == name,
                      f"9: decoded with {native.backend()}, not {name}")
            got = (scans.range_mm, scans.col_ts, scans.ts, imu.lacc,
                   imu.avel, imu.ts)
            first = first or got
            check(all(np.array_equal(a, b) for a, b in zip(first, got)),
                  "9: the native and numpy decodes differ")
        n = len(scans)
        check(scans.range_mm.shape == (n, info.h, info.w) and n == len(ref),
              f"9: {scans.range_mm.shape} decoded, {len(ref)} reference "
              "poses")
        check(np.array_equal(scans.range_mm, np.clip(
            scene[1][:n] * 1000.0, 0, (1 << 20) - 1).astype(np.uint32)),
            "9: the decoded ranges are not the scene's in mm")

        base = ["ekf-bench", "ouster", rec, "-m", meta,
                "--use-imu-prediction", "-g", gt]
        runs, launches, outs = {}, {}, {}
        for mode in ("batch", "online"):
            kitti = os.path.join(tmp, f"{mode}.txt")
            kernels.reset_launches()
            icp.reset_refresh_counts()
            t = time.monotonic()
            res = cli.run(base + ["--save-kitti-poses", kitti]
                          + (["--online"] if mode == "online" else []))
            wall = time.monotonic() - t
            launches[mode] = launch_counts()
            reads = icp.REFRESH_COUNTS["host_reads"]
            check(native.backend() == "native",
                  f"9 {mode}: the command decoded with {native.backend()}")
            iters = int(res["iterations"].sum()) + (
                int(res["iterations_first"].sum()) if mode == "batch"
                else 0)
            k = 2 if mode == "batch" else 1     # the batch command runs twice
            expect = {"ekf_predict": k * n, "gn_iter": iters}
            check(all(c == expect.get(name, 0)
                      for name, c in launches[mode].items()),
                  f"9 {mode}: launches {launches[mode]}, want {expect}")
            kp = np.loadtxt(kitti).reshape(-1, 3, 4)
            check(kp.shape == (n, 3, 4) and bool(np.isfinite(kp).all()),
                  f"9 {mode}: saved poses {kp.shape}")
            err = np.linalg.norm(kp[:, :, 3] - ref[:, :, 3], axis=1)
            check(float(err.max()) <= POSE_GATE_M,
                  f"9 {mode}: pose vs JAX {err.max():.4f} m > "
                  f"{POSE_GATE_M} m")
            ate = res["ate_ekf"]["rmse_trans"]
            check(ate <= jax_ate + CLI_ATE_SLACK_M,
                  f"9 {mode}: ATE RMSE {ate:.4f} m > JAX {jax_ate:.4f} + "
                  f"{CLI_ATE_SLACK_M} m")
            outs[mode] = res
            runs[mode] = dict(
                wall_s=wall, max_pose_vs_jax_m=float(err.max()),
                ate_rmse_m=ate, jax_ate_rmse_m=jax_ate, gn_iterations=iters,
                host_reads=reads, kernel_launches=launches[mode])
            if mode == "batch":
                runs[mode].update(first_s=res["first_s"],
                                  steady_s=res["steady_s"],
                                  scans_per_s=n / res["steady_s"])
            else:
                lat = np.asarray(res["latencies_s"][1:]) * 1e3
                runs[mode].update(
                    first_scan_s=res["latencies_s"][0],
                    latency_ms={f"p{q}": float(np.percentile(lat, q))
                                for q in (50, 95, 99)},
                    latency_max_ms=float(lat.max()),
                    scans_per_s=n / float(np.sum(res["latencies_s"])))
        diff = {key: np.abs(outs["online"][key] - outs["batch"][key])
                for key in ("ekf_poses", "kiss_poses")}
        gap = max(float(d.max()) for d in diff.values())
        if gap == 0:
            say("  9: the online poses are the batch run's bit for bit")
        else:
            parted = int(np.argmax(diff["kiss_poses"].reshape(n, -1).max(1)
                                   + diff["ekf_poses"].reshape(n, -1).max(1)
                                   > 0))
            say(f"  9: online vs batch poses differ by up to {gap:.3e} from "
                f"scan {parted} on: the online run steps the same scan "
                "functions on the same inputs, so a difference is the "
                "card's order of sums in a kernel or op repeating "
                "differently between runs (phase 3 repeats each kernel bit "
                "for bit), not the online run's windowing")
        runs["online"]["max_pose_vs_batch"] = gap
        st = cli.run(["stat", rec, "-m", meta])["tracker"]
        check(st._scans_num == n and st._imu_num == len(imu),
              f"9 stat: {st._scans_num} scans, {st._imu_num} IMU samples")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = dict(phase9=dict(
        recording=dict(bytes=rec_bytes, scans=n, imu=len(imu),
                       write_s=t_write),
        native_build_s=native_build_s, decode_s=decode, **runs, card=card))
    say(json.dumps(summary))
    return {"cli_pcap": launches["batch"],
            "cli_pcap_online": launches["online"]}


# -------------------------------------------------------------- phase 10

REPLICAS = (1, 2, 4)        # the batched driver's replica counts
SELF_GATE_M = 1e-4          # B = 1 against phase 4's run_sequence


def same_bits(a, b) -> bool:
    """Every tensor of the trees ``a`` and ``b`` equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def replica_axis_kernel(name, many, one, inputs, outputs, flops_one):
    """Phase 10a for one kernel: ``many(b)`` launches it once with a
    replica axis over the first b of four distinct inputs, ``one(i)``
    once for replica i alone; replica i of the B = 4 launch must equal that
    single launch bit for bit, and a second B = 4 launch the first. Returns
    the device us at B = 1, 2, 4 and the bounds at B = 2, 4 (``inputs(b)``
    and ``outputs(b)`` the tensors moved, ``flops_one(i)`` replica i's
    operations)."""
    kernels.reset_launches()
    got = many(4)
    check(kernels.LAUNCHES[name] == 1,
          f"10a {name}: {kernels.LAUNCHES[name]} launches for B = 4")
    again = many(4)
    check(same_bits(got, again), f"10a {name}: B = 4 does not repeat")
    for i in range(4):
        check(same_bits(replicas.take(got, i), one(i)),
              f"10a {name}: replica {i} of the B = 4 launch differs from "
              "its single launch")
    r = {f"device_us_b{b}": kernel_us(lambda b=b: many(b), name)
         for b in REPLICAS}
    for b in (2, 4):
        bd = bound(nbytes(inputs(b), outputs(b)),
                   sum(flops_one(i) for i in range(b)))
        r[f"bound_ms_b{b}"], r[f"bound_by_b{b}"] = bd["bound_ms"], \
            bd["bound_by"]
    say(f"  10a {name}: each replica of one B = 4 launch equals its own "
        f"single launch bit for bit, repeats bit for bit; device "
        f"{r['device_us_b1']:.2f} / {r['device_us_b2']:.2f} / "
        f"{r['device_us_b4']:.2f} us at B = 1 / 2 / 4 (bound "
        f"{r['bound_ms_b2'] * 1e3:.3f} / {r['bound_ms_b4'] * 1e3:.3f} us "
        f"at B = 2 / 4)")
    return r


def check_replica_axis(dev, results):
    """Phase 10a: K1 (both instances), K2, K3 and K4 with a replica axis at
    B = 4 on four distinct inputs against four single launches, bit for
    bit; their device times at B = 1, 2, 4 and bounds at B = 2, 4."""
    rng = np.random.default_rng(10)
    bench = config.bench_config()
    cfg = bench.ekf
    states = [generic_ekf_state(cfg, dev, rng) for _ in range(4)]
    k = bench.max_imu_per_scan
    valid = torch.ones((4, k), dtype=torch.bool, device=dev)
    valid[1, 10:] = False
    valid[2, 3] = valid[2, 7] = False
    valid[3] = False
    t0 = np.array([float(s.imu_ts) for s in states])[:, None]
    imus = esekf.Imu(
        lacc=torch.tensor(rng.normal(0, 1, (4, k, 3)) + [0, 0, 9.78],
                          dtype=torch.float32, device=dev),
        avel=torch.tensor(rng.normal(0, 0.2, (4, k, 3)),
                          dtype=torch.float32, device=dev),
        ts=torch.tensor(t0 + np.arange(1, k + 1) * 0.01,
                        dtype=torch.float32, device=dev))
    st = replay.stack_bags(states)
    out = {}
    for log, name in ((False, "ekf_predict"),
                      (True, "ekf_predict_history")):
        def many(b, log=log):
            return cuda_ekf.predict_block(
                replicas.take(st, slice(0, b)),
                replicas.take(imus, slice(0, b)), valid[:b], cfg=cfg,
                want_twist=True, log=log)

        def one(i, log=log):
            return cuda_ekf.predict_block(
                states[i], replicas.take(imus, i), valid[i], cfg=cfg,
                want_twist=True, log=log)

        out[name] = replica_axis_kernel(
            "ekf_predict", many, one,
            lambda b: (replicas.take(st, slice(0, b)),
                       replicas.take(imus, slice(0, b)), valid[:b]),
            many, lambda i: predict_block_ops(int(valid[i].sum())))
    meas = se3.exp_twist(torch.tensor(rng.normal(0, 0.05, (4, 6)),
                                      dtype=torch.float32, device=dev))
    mc = esekf.default_meas_cov(cfg, dev)
    out["ekf_update"] = replica_axis_kernel(
        "ekf_update",
        lambda b: cuda_ekf.update_pose(replicas.take(st, slice(0, b)),
                                       meas[:b], mc),
        lambda i: cuda_ekf.update_pose(states[i], meas[i], mc),
        lambda b: (replicas.take(st, slice(0, b)), meas[:b], mc),
        lambda b: cuda_ekf.update_pose(replicas.take(st, slice(0, b)),
                                       meas[:b], mc),
        lambda i: 4 * 18 ** 3 + 8 * 18 * 18 * 6)

    kc = bench.kiss
    r = kc.plane_fit_radius
    scenes = [icp_scene(dev, seed=5 + i) for i in range(4)]
    cands, masks, qws, srcs, guesses = [], [], [], [], []
    for m, src, mask, guess in scenes:
        q_w = se3.transform(guess, src)
        cands.append(icp.gather_candidates(
            m, q_w, voxel_size=0.3, max_probes=2, neighborhood=7,
            n_voxels=4, fit_planes=False))
        masks.append(mask)
        qws.append(q_w)
        srcs.append(src)
        guesses.append(guess)
    cand = icp.CandidateSet(*(torch.stack(x) for x in zip(*cands)))
    mask, q_w = torch.stack(masks), torch.stack(qws)
    src, guess = torch.stack(srcs), torch.stack(guesses)
    c, n = 4 * 8, src.shape[1]
    for loss in ("plane", "point"):
        def prep_b(b, loss=loss):
            return cuda_gn.prep_with_plane(
                icp.CandidateSet(*(x[:b] for x in cand)), mask[:b],
                q_w[:b], r, loss=loss)

        out["gn_prep" if loss == "plane" else "gn_prep_point"] = \
            replica_axis_kernel(
                "gn_prep", prep_b,
                lambda i, loss=loss: cuda_gn.prep_with_plane(
                    cands[i], masks[i], qws[i], r, loss=loss),
                lambda b: (cand.pts[:b], cand.valid[:b], q_w[:b],
                           mask[:b]),
                prep_b, lambda i, loss=loss: n * (
                    20 * c + 150 if loss == "plane" else 0))
    prepped = cuda_gn.prep_with_plane(cand, mask, q_w, r)
    kern = torch.tensor([0.1667, 0.15, 0.2, 0.1], device=dev)
    max_d2 = torch.tensor([0.25, 0.2, 0.3, 0.16], device=dev)
    kw = dict(plane_min_quality=kc.plane_min_quality,
              max_iterations=kc.max_iterations,
              prior_rot_weight=kc.prior_rot_weight,
              prior_trans_weight=kc.prior_trans_weight)

    def loop_b(b):
        return cuda_icp.icp_loop(
            src[:b], cuda_gn.PreppedCandidates(*(x[:b] for x in prepped)),
            guess[:b], kern[:b], max_d2[:b], 1e-5, **kw)

    singles = [cuda_icp.icp_loop(
        srcs[i], cuda_gn.prep_with_plane(cands[i], masks[i], qws[i], r),
        guesses[i], kern[i], max_d2[i], 1e-5, **kw) for i in range(4)]
    iters = [int(x[2]) for x in singles]
    out["icp_loop"] = replica_axis_kernel(
        "icp_loop", loop_b, lambda i: singles[i],
        lambda b: (src[:b], tuple(x[:b] for x in prepped), guess[:b]),
        loop_b, lambda i: iters[i] * n * (8 * c + 120))
    say(f"  10a icp_loop: each cluster its own exit: iterations {iters}")
    out["gn_iter"] = check_gn_iter_replica_axis(dev)
    for name, r_ in out.items():
        if name == "gn_prep_point":
            results.setdefault("gn_prep", {}).setdefault(
                "point", {})["replica_axis"] = r_
        else:
            results.setdefault(name, {})["replica_axis"] = r_
    return out


def check_gn_iter_replica_axis(dev) -> dict:
    """Phase 10a for K5: one launch with a replica axis at B = 4 on four
    distinct inputs at the CLI shapes (:func:`cli_map_scene`'s map; four
    sources, masks, poses, kernel widths and max_d2), the prepped rows of
    all four in one [4, 8 + 4C, N] buffer (``cuda_gn.prep_candidates``).
    With every replica active each one is bit-equal to its own single
    launch; with replica 2 inactive its output row keeps what it held and
    the others are bit-equal again; every replica's ticket is back at 0;
    a B = 4 launch repeats bit for bit. Returns the device us at B = 1, 2,
    4 and the bounds at B = 2, 4."""
    m, src0, _, t0 = cli_map_scene(dev)
    rng = np.random.default_rng(12)
    srcs, masks, poses, cands, singles = [], [], [], [], []
    for i in range(4):
        src = src0 + torch.tensor(rng.normal(0, 0.01, src0.shape),
                                  dtype=torch.float32, device=dev)
        mask = torch.as_tensor(rng.uniform(size=len(src)) < 0.9 - 0.1 * i,
                               device=dev)
        t = t0 @ se3.exp_twist(torch.tensor(
            rng.normal(0, 0.002, 6), dtype=torch.float32, device=dev))
        cand = icp.gather_candidates(
            m, se3.transform(t, src), voxel_size=0.7, max_probes=2,
            neighborhood=27, n_voxels=4, fit_planes=True)
        srcs.append(src)
        masks.append(mask)
        poses.append(t)
        cands.append(cand)
        singles.append(cuda_gn.prep_candidates(cand, mask))
    src, t = torch.stack(srcs), torch.stack(poses)
    prepped = cuda_gn.prep_candidates(replicas.stack(cands),
                                      torch.stack(masks))
    kern = torch.tensor([0.1667, 0.15, 0.2, 0.12], device=dev)
    max_d2 = torch.tensor([2.25, 2.0, 2.5, 1.8], device=dev)
    q = 0.2

    def many(b, active=None, out=None):
        return cuda_gn.gn_prepped(
            t[:b], src[:b], cuda_gn.PreppedCandidates(
                *(x[:b] for x in prepped)), kern[:b], max_d2[:b],
            plane_min_quality=q, active=active, out=out)

    ones = [cuda_gn.gn_prepped(poses[i], srcs[i], singles[i], kern[i],
                               max_d2[i], plane_min_quality=q)
            for i in range(4)]
    kernels.reset_launches()
    got = many(4)
    check(kernels.LAUNCHES["gn_iter"] == 1,
          f"10a gn_iter: {kernels.LAUNCHES['gn_iter']} launches for B = 4")
    check(same_bits(got, many(4)), "10a gn_iter: B = 4 does not repeat")
    for i in range(4):
        check(same_bits(replicas.take(got, i), ones[i]),
              f"10a gn_iter: replica {i} of the B = 4 launch differs from "
              "its single launch")
        check(int(ones[i][2]) > 1000, f"10a gn_iter: replica {i} n_corr "
              f"{int(ones[i][2])}")
    active = torch.tensor([True, True, False, True], device=dev)
    out = torch.full((4, cuda_gn.GN_OUT), 7.0, device=dev)
    got = many(4, active, out)
    check(bool((out[2] == 7.0).all()),
          "10a gn_iter: the inactive replica's row changed")
    for i in (0, 1, 3):
        check(same_bits(replicas.take(got, i), ones[i]),
              f"10a gn_iter: active replica {i} differs from its single "
              "launch")
    torch.cuda.synchronize()
    check(int(cuda_gn._ticket(dev, 4).abs().sum()) == 0,
          "10a gn_iter: a ticket is not back at 0")
    c, n = prepped.cx.shape[-2:]
    r = {f"device_us_b{b}": kernel_us(lambda b=b: many(b), "gn_iter")
         for b in REPLICAS}
    r["device_us_b4_one_inactive"] = kernel_us(
        lambda: many(4, active, out), "gn_iter")
    for b in (2, 4):
        # each replica: its source, feat and candidates once, its pose and
        # output row; ~8 operations per candidate and ~120 per point
        bd = bound(nbytes(src[:b], tuple(x[:b] for x in prepped), t[:b],
                          out[:b]), b * n * (8 * c + 120))
        r[f"bound_ms_b{b}"], r[f"bound_by_b{b}"] = bd["bound_ms"], \
            bd["bound_by"]
    say(f"  10a gn_iter (N={n}, C={c}): each replica of one B = 4 launch "
        "equals its own single launch bit for bit, repeats bit for bit; "
        "with replica 2 inactive its row is untouched and the others equal "
        "their single launches; every ticket back at 0; device "
        f"{r['device_us_b1']:.2f} / {r['device_us_b2']:.2f} / "
        f"{r['device_us_b4']:.2f} us at B = 1 / 2 / 4, "
        f"{r['device_us_b4_one_inactive']:.2f} us at B = 4 with one "
        f"inactive (bound {r['bound_ms_b2'] * 1e3:.3f} / "
        f"{r['bound_ms_b4'] * 1e3:.3f} us at B = 2 / 4)")
    return r


def batched_window(cfg, states, batches, lut, window: int) -> dict:
    """The batched run's first scans, then its last ``window`` scans (the
    steady step) under the profiler: device busy us and operations a scan
    and the idle share of the window (1 - busy / the span from the first
    device operation's start to the last one's end)."""
    from torch.profiler import ProfilerActivity, profile

    n = batches.range_m.shape[1]
    k = n - window
    fin, _ = batched.run_sequence_batched(
        states, batched.scan_of(batches, slice(0, k)), lut, cfg=cfg)
    tail = dataclasses.replace(cfg, bootstrap_scans=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        batched.run_sequence_batched(
            fin, batched.scan_of(batches, slice(k, n)), lut, cfg=tail)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(ev)
    span = max(e.time_range.end for e in ev) - min(
        e.time_range.start for e in ev)
    return dict(busy_us_per_scan=busy / window,
                device_ops_per_scan=len(ev) / window,
                idle_share=1.0 - busy / span)


def timed_batched(cfg, states, batches, lut):
    """One ``run_sequence_batched`` with host syncs made errors; returns
    (out, seconds)."""
    torch.cuda.synchronize()
    t = time.monotonic()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = batched.run_sequence_batched(states, batches, lut, cfg=cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, time.monotonic() - t


def run_batched_path(scene, dev, bench_out, card: str):
    """Phase 10b: ``parallel.batched.run_sequence_batched`` at
    ``bench_config()`` on B = 1, 2, 4 replicas of the bench scene and on
    B = 2 of {the scene, the scene at 64 beams}, each warmed up (its last
    10 scans profiled) and timed with host syncs made errors. K1-K4 launch
    once a scan whatever B is, K5 and K6 never; identical replicas are
    bit-equal; every replica within 0.02 m of its JAX poses
    (``bench_jax_poses.txt``, ``bench_beams64_jax_poses.txt``); B = 1
    within 1e-4 m of phase 4. Aggregate scans/s from alternating timed
    runs (B = 1, 2, 4, 4, 2, 1). Returns (launches by run, summary)."""
    from ptudes_tpu_torch.ops.projection import reduce_active_beams_mask

    sensor, scans, scan_ts, gt_mid, imu = scene
    cfg = config.bench_config()
    lut = convert.lut_from_numpy(sensor.lut, dev)
    n = len(scans)
    one = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel, imu.ts,
                            device=dev)
    beams64 = scans * reduce_active_beams_mask(scans.shape[1], 64)[
        None, :, None]
    low = lio.build_batches(cfg, beams64, scan_ts, imu.lacc, imu.avel,
                            imu.ts, device=dev)
    _, ref = ref_poses("bench")
    _, ref64 = ref_poses("bench_beams64")
    runs = {f"bench_x{b}": ([one] * b, [ref] * b) for b in REPLICAS}
    runs["bench_mixed"] = ([one, low], [ref, ref64])
    phase4 = bench_out.kiss_pose.double().cpu().numpy()
    launches, summary, timed = {}, {}, {}
    for tag, (bags, refs) in runs.items():
        b = len(bags)
        states = replay.stack_bags([lio.init_state(cfg, dev)] * b)
        batches = replay.stack_bags(bags)
        win = batched_window(cfg, states, batches, lut, min(10, n // 2))
        kernels.reset_launches()
        out, dt = timed_batched(cfg, states, batches, lut)
        launches[tag] = launch_counts()
        want = {k_: n for k_ in ("ekf_predict", "ekf_update", "gn_prep",
                                 "icp_loop")}
        check(all(c == want.get(k_, 0) for k_, c in launches[tag].items()),
              f"10b {tag}: launches {launches[tag]}, want {want} at B = "
              f"{b}")
        kp = out.kiss_pose.double().cpu().numpy()
        check(kp.shape == (b, n, 4, 4) and bool(np.isfinite(kp).all()),
              f"10b {tag}: poses {kp.shape}")
        check(bool(out.scan_valid.all()), f"10b {tag}: a scan was skipped")
        errs = [float(np.linalg.norm(kp[i, :, :3, 3] - r_[:n, :, 3],
                                     axis=1).max())
                for i, r_ in enumerate(refs)]
        check(max(errs) <= POSE_GATE_M,
              f"10b {tag}: pose vs JAX {errs} m > {POSE_GATE_M} m")
        if tag.startswith("bench_x"):
            for i in range(1, b):
                check(torch.equal(out.kiss_pose[i], out.kiss_pose[0])
                      and torch.equal(out.ekf_pose[i], out.ekf_pose[0]),
                      f"10b {tag}: replica {i} differs from replica 0")
        vs4 = float(np.abs(kp[0] - phase4).max())
        if tag == "bench_x1":
            check(vs4 <= SELF_GATE_M,
                  f"10b {tag}: {vs4:.3e} from phase 4 > {SELF_GATE_M}")
        _, ate = metrics.calc_ate_rmse(kp[0], gt_mid[:n])
        iters = out.aux.iterations.sum(1).tolist()
        summary[tag] = dict(replicas=b, scans=n, max_pose_vs_jax_m=errs,
                            max_pose_vs_phase4_m=vs4, ate_rmse_m=ate,
                            gn_iterations=iters, first_scans_per_s=b * n
                            / dt, **win)
        timed[tag] = [dt]
        say(f"  10b {tag}: B = {b}, {win['device_ops_per_scan']:.1f} device "
            f"operations and {win['busy_us_per_scan'] / 1e3:.3f} ms busy a "
            f"scan, idle {win['idle_share'] * 100:.1f} % (the last 10 "
            f"scans); max |pose - JAX| {', '.join(f'{e:.4f}' for e in errs)}"
            f" m (<= {POSE_GATE_M}); max |replica 0 - phase 4| {vs4:.3e} m"
            + (f" (<= {SELF_GATE_M})" if tag == "bench_x1" else "")
            + f"; identical replicas bit-equal; GN iterations {iters}; "
            f"launches {launches[tag]}; no host sync")
    for b in (*REPLICAS, *reversed(REPLICAS)):
        tag = f"bench_x{b}"
        states = replay.stack_bags([lio.init_state(cfg, dev)] * b)
        _, dt = timed_batched(cfg, states, replay.stack_bags([one] * b),
                              lut)
        timed[tag].append(dt)
    for tag, dts in timed.items():
        b = summary[tag]["replicas"]
        summary[tag]["aggregate_scans_per_s"] = [b * n / t for t in dts]
    ops = {b: summary[f"bench_x{b}"]["device_ops_per_scan"]
           for b in REPLICAS}
    check(ops[4] <= 1.25 * ops[1],
          f"10b: {ops[4]:.1f} device operations a scan at B = 4 against "
          f"{ops[1]:.1f} at B = 1 (> 1.25x)")
    say("  10b aggregate scans/s (alternating runs B = 1, 2, 4, 4, 2, 1; "
        "the first of each B its checked run): " + "; ".join(
            f"B = {summary[f'bench_x{b}']['replicas']}: "
            + ", ".join(f"{x:.1f}" for x in
                        summary[f"bench_x{b}"]["aggregate_scans_per_s"])
            for b in REPLICAS) + f"; operations a scan at B = 4 / B = 1: "
        f"{ops[4] / ops[1]:.3f} (<= 1.25); {card}")
    return launches, summary


def refresh_launches(iterations: torch.Tensor) -> int:
    """K5 launches of a batched refresh-loop run with GN iteration counts
    ``iterations`` [B, N]: each scan's largest count among the replicas
    (one launch an iteration for all replicas), summed over the scans."""
    return int(iterations.max(0).values.sum())


def run_batched_refresh_cell(tag, cfg, bags, refs, lut, single, *,
                             self_gate: bool, window: int = 10):
    """One cell of phases 10d/10e: ``run_sequence_batched`` of ``cfg`` on
    the stacked ``bags``, warmed up (its last ``window`` scans profiled:
    device operations, busy and idle share a scan), then timed with host
    syncs made errors (but the refresh loop's counted reads). Gates: K1
    once a scan (none with the associative predict), K5 once a GN
    iteration for all replicas (:func:`refresh_launches`), no other
    kernel; host reads at most the GN iterations so counted; every pose
    finite and within 0.02 m of its JAX poses ``refs``; identical
    replicas bit-equal; with ``self_gate`` replica 0 within 1e-4 m of
    ``single`` (the single run of the same cell; the difference and the
    first scan where it passes 1e-6 m are printed in any case). Returns
    (launches, out, summary, seconds)."""
    b, n = bags.range_m.shape[:2]
    states = replay.stack_bags([lio.init_state(cfg, lut.direction.device)]
                               * b)
    win = batched_window(cfg, states, bags, lut, min(window, n // 2))
    kernels.reset_launches()
    icp.reset_refresh_counts()
    out, dt = timed_batched(cfg, states, bags, lut)
    launches, counts = launch_counts(), dict(icp.REFRESH_COUNTS)
    k5 = refresh_launches(out.aux.iterations)
    k1 = n if cfg.ekf.predict_batch == "cuda" else 0
    want = {"ekf_predict": k1, "gn_iter": k5}
    check(all(c == want.get(k_, 0) for k_, c in launches.items()),
          f"{tag}: launches {launches}, want {want} (K5: each scan's "
          f"largest iteration count, summed)")
    check(counts["host_reads"] <= k5,
          f"{tag}: {counts['host_reads']} host reads > {k5}")
    kp = out.kiss_pose.double().cpu().numpy()
    check(kp.shape == (b, n, 4, 4) and bool(np.isfinite(kp).all()),
          f"{tag}: poses {kp.shape}")
    check(bool(out.scan_valid.all()), f"{tag}: a scan was skipped")
    errs = [float(np.linalg.norm(kp[i, :, :3, 3] - r_[:n, :, 3],
                                 axis=1).max()) for i, r_ in enumerate(refs)]
    check(max(errs) <= POSE_GATE_M,
          f"{tag}: pose vs JAX {errs} m > {POSE_GATE_M} m")
    for i in range(1, b):
        check(torch.equal(out.kiss_pose[i], out.kiss_pose[0])
              and torch.equal(out.ekf_pose[i], out.ekf_pose[0]),
              f"{tag}: replica {i} differs from replica 0")
    d1 = np.linalg.norm(
        kp[0, :, :3, 3] - single.kiss_pose.double().cpu().numpy()[:, :3, 3],
        axis=1)
    vs1 = float(d1.max())
    parts = np.nonzero(d1 > 1e-6)[0]
    first = int(parts[0]) if len(parts) else None
    if self_gate:
        check(vs1 <= SELF_GATE_M,
              f"{tag}: replica 0 {vs1:.3e} m from the single run > "
              f"{SELF_GATE_M} (first above 1e-6 m at scan {first})")
    iters = out.aux.iterations.sum(1).tolist()
    summary = dict(replicas=b, scans=n, max_pose_vs_jax_m=errs,
                   max_pose_vs_single_m=vs1, first_scan_above_1e6_m=first,
                   gn_iterations=iters,
                   k5_launches=launches["gn_iter"], k5_want=k5,
                   host_reads=counts["host_reads"],
                   regathers=counts["regathers"],
                   first_scans_per_s=b * n / dt, **win)
    say(f"  {tag}: B = {b}, {n} scans, {win['device_ops_per_scan']:.1f} "
        f"device operations and {win['busy_us_per_scan'] / 1e3:.3f} ms busy"
        f" a scan, idle {win['idle_share'] * 100:.1f} % (the last "
        f"{min(window, n // 2)} scans); K5 {launches['gn_iter']} launches = "
        f"{k5} (each scan's largest iteration count, summed; GN iterations "
        f"by replica {iters}), K1 {launches['ekf_predict']}; "
        f"{counts['host_reads']} host reads (<= {k5}), "
        f"{counts['regathers']} re-gathers, no other host sync; max |pose - "
        f"JAX| {', '.join(f'{e:.4f}' for e in errs)} m (<= {POSE_GATE_M});"
        f" max |replica 0 - single run| {vs1:.3e} m"
        + (f" (<= {SELF_GATE_M})" if self_gate else "")
        + f", above 1e-6 m from scan {first}; identical replicas bit-equal")
    return launches, out, summary, dt


def run_batched_refresh_path(scene, dev, cli_out, assoc_out, card: str):
    """Phases 10d and 10e. 10d: ``run_sequence_batched`` at
    ``cli_config(128, 1024)`` (the EKF guess; K1 and K5) on B = 1, 2, 4
    replicas of the bench scene over its 50 scans, B = 1 against phase 5's
    run; aggregate scans/s from alternating timed runs (B = 1, 2, 4, 4, 2,
    1). 10e: B = 2 at cli_kiss_assoc (the constant-velocity guess, the
    associative predict, the refresh loop; the 15 scans of
    ``cli_kiss_jax_poses.txt``) against phase 7b's single run. Returns
    (launches by run, summary)."""
    sensor, scans, scan_ts, gt_mid, imu = scene
    h, w = scans.shape[1:]
    lut = convert.lut_from_numpy(sensor.lut, dev)
    launches, summary, timed = {}, {}, {}
    cli = config.cli_config(h, w)
    _, ref = ref_poses("cli")
    n = min(len(scans), len(ref))
    one = lio.scan_at(lio.build_batches(
        cli, scans, scan_ts, imu.lacc, imu.avel, imu.ts, device=dev),
        slice(0, n))
    for b in REPLICAS:
        tag = f"cli_x{b}"
        launches[tag], _, summary[tag], dt = run_batched_refresh_cell(
            f"10d {tag}", cli, replay.stack_bags([one] * b), [ref] * b, lut,
            cli_out, self_gate=b == 1)
        timed[tag] = [dt]
    for b in (*REPLICAS, *reversed(REPLICAS)):
        states = replay.stack_bags([lio.init_state(cli, dev)] * b)
        _, dt = timed_batched(cli, states, replay.stack_bags([one] * b), lut)
        timed[f"cli_x{b}"].append(dt)
    for tag, dts in timed.items():
        b = summary[tag]["replicas"]
        summary[tag]["aggregate_scans_per_s"] = [b * n / t for t in dts]
    say("  10d aggregate scans/s (alternating runs B = 1, 2, 4, 4, 2, 1; "
        "the first of each B its checked run): " + "; ".join(
            f"B = {b}: " + ", ".join(
                f"{x:.2f}" for x in summary[f"cli_x{b}"][
                    "aggregate_scans_per_s"]) for b in REPLICAS)
        + f"; {card}")

    kiss_cfg = config.cli_config(h, w, guess="kiss")
    assoc = dataclasses.replace(kiss_cfg, ekf=dataclasses.replace(
        kiss_cfg.ekf, predict_batch="assoc"))
    _, kref = ref_poses("cli_kiss")
    k = min(len(scans), len(kref))
    kone = lio.scan_at(lio.build_batches(
        assoc, scans, scan_ts, imu.lacc, imu.avel, imu.ts, device=dev),
        slice(0, k))
    tag = "cli_kiss_assoc_x2"
    launches[tag], _, summary[tag], dt = run_batched_refresh_cell(
        f"10e {tag}", assoc, replay.stack_bags([kone] * 2), [kref] * 2, lut,
        assoc_out, self_gate=True, window=5)
    summary[tag]["aggregate_scans_per_s"] = [2 * k / dt]
    return launches, summary


def sweep_refs(name: str) -> dict[str, np.ndarray]:
    """{variant: [N, 3, 4]} of a multi-variant sweep reference
    (``tests/data/<name>_jax_poses.txt``: rows variant after variant, the
    variants named in its header)."""
    path, rows = ref_poses(name)
    with open(path) as f:
        head = [line for line in f if line.startswith("# variants")]
    names = head[0].split(":", 1)[1].strip().split(", ")
    per = rows.reshape(len(names), -1, 3, 4)
    return dict(zip(names, per))


def run_sweep_path(scene, dev, card: str):
    """Phase 10c: ``ekf-bench sweep`` through the port's command line on
    the bench scene written as phase 9's recording, its variants on one
    card as one program (``run_sequence_batched``): ``--replicas 2`` over
    the 50 scans (the two replicas bit-equal, each within 0.02 m of
    ``tests/data/sweep_pcap_jax_poses.txt``, the printed ATE within the JAX
    run's + 0.005 m), then ``--bacc-z -0.1,0,0.1`` and ``--beams 128,64``
    on scans 0-20, every variant within 0.02 m of its JAX poses
    (``sweep_bacc_z_jax_poses.txt``, ``sweep_beams_jax_poses.txt``). K5
    once a GN iteration for all variants (each scan's largest iteration
    count, summed over the command's two runs), K1-K4 and K6 never.
    Returns (launches by command, summary)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import make_torch_fixture
    from ptudes_tpu_torch.cli import main as cli

    ref_path, base_ref = ref_poses("sweep_pcap")
    jax_ate = reference_ate(ref_path)
    refs = {"sweep_replicas": {f"replica {i}": base_ref for i in range(2)},
            "sweep_bacc_z": sweep_refs("sweep_bacc_z"),
            "sweep_beams": sweep_refs("sweep_beams")}
    # the same commands with the bags run one after another through
    # lio.run_sequence, two earlier runs on an H100 80GB HBM3 at 700 W
    serial = {"sweep_replicas": "7.35 / 8.41",
              "sweep_bacc_z": "4.62 / 9.11", "sweep_beams": "4.53 / 8.03"}
    tmp = tempfile.mkdtemp(prefix="ptudes_sweep_")
    launches, summary = {}, {}
    try:
        rec, meta, gt = make_torch_fixture.bench(tmp, scene=scene)
        for tag, flags in (
                ("sweep_replicas", ["--replicas", "2"]),
                ("sweep_bacc_z", ["--bacc-z", "-0.1,0,0.1", "--end-scan",
                                  "20"]),
                ("sweep_beams", ["--beams", "128,64", "--end-scan", "20"])):
            kernels.reset_launches()
            icp.reset_refresh_counts()
            t = time.monotonic()
            res = cli.run(["ekf-bench", "sweep", rec, "-m", meta, "-g", gt,
                           *flags])
            wall = time.monotonic() - t
            launches[tag] = launch_counts()
            n = res["n_scans"]
            k5 = refresh_launches(torch.as_tensor(res["iterations"])) \
                + refresh_launches(torch.as_tensor(res["iterations_first"]))
            check(all(c == (k5 if k_ == "gn_iter" else 0)
                      for k_, c in launches[tag].items()),
                  f"10c {tag}: launches {launches[tag]}, want gn_iter {k5} "
                  "(each scan's largest iteration count, summed over the "
                  "two runs)")
            ek = res["ekf_poses"]
            check(bool(np.isfinite(ek).all()), f"10c {tag}: poses")
            check(list(refs[tag]) == res["variants"],
                  f"10c {tag}: variants {res['variants']}, references "
                  f"{list(refs[tag])}")
            errs = {v: float(np.linalg.norm(
                ek[i, :, :3, 3] - refs[tag][v][:n, :, 3], axis=1).max())
                for i, v in enumerate(res["variants"])}
            check(max(errs.values()) <= POSE_GATE_M,
                  f"10c {tag}: pose vs JAX {errs} > {POSE_GATE_M} m")
            rows = res["rows"]
            if tag == "sweep_replicas":
                check(np.array_equal(ek[0], ek[1]),
                      "10c: the two replicas differ")
                # the JAX ATE is over the reference's scans: comparable
                # when the run covers them all (not with --scans < 50)
                for row in rows if n == len(base_ref) else ():
                    check(row["ate_rmse"] <= jax_ate + CLI_ATE_SLACK_M,
                          f"10c: ATE {row['ate_rmse']:.4f} m > JAX "
                          f"{jax_ate:.4f} + {CLI_ATE_SLACK_M}")
            rate = len(rows) * n / res["steady_s"]
            summary[tag] = dict(
                scans=n, variants=res["variants"], wall_s=wall,
                first_s=res["first_s"], steady_s=res["steady_s"],
                aggregate_scans_per_s=rate, rows=rows,
                max_pose_vs_jax_m=errs, k5_launches=k5,
                gn_iterations=int(res["iterations"].sum()) + int(
                    res["iterations_first"].sum()),
                host_reads=icp.REFRESH_COUNTS["host_reads"],
                jax_ate_rmse_m=jax_ate, kernel_launches=launches[tag])
            say(f"  10c {tag}: {len(rows)} x {n} scans as one batched "
                f"program, {rate:.2f} scans/s aggregate steady (the bags "
                f"one after another: {serial[tag]}); max |pose - JAX| "
                + ", ".join(f"{v} {e:.5f}" for v, e in errs.items())
                + f" m (<= {POSE_GATE_M}); rows "
                + "; ".join(f"{r_['variant']}: drift {r_['drift']:.3f}, "
                            f"ATE {r_['ate_rmse']:.4f}" for r_ in rows)
                + f" (JAX {jax_ate:.4f}); K5 {k5} launches for "
                f"{summary[tag]['gn_iterations']} replica GN iterations, no "
                f"other kernel; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, summary


def run_phase10(scene, dev, bench_out, cli_out, assoc_out, card: str,
                results):
    """Phase 10: the replica-axis launches (a), the batched driver at the
    bench configuration (b) and with the refresh loop (d, e), ``ekf-bench
    sweep`` (c); one JSON line of their figures. ``cli_out`` and
    ``assoc_out``: phase 5's and phase 7b's runs. Returns the launches by
    run."""
    axis = check_replica_axis(dev, results)
    launches, summary = run_batched_path(scene, dev, bench_out, card)
    refresh_launch, refresh = run_batched_refresh_path(
        scene, dev, cli_out, assoc_out, card)
    launches.update(refresh_launch)
    sweep_launches, sweep = run_sweep_path(scene, dev, card)
    launches.update(sweep_launches)
    say(json.dumps(dict(phase10=dict(replica_axis=axis, batched=summary,
                                     batched_refresh=refresh, sweep=sweep,
                                     card=card))))
    return launches


# -------------------------------------------------------------- phase 11

# (cell, source points of one shard, scene): the sharded paths' shard
# shapes at n_pt = 2, bench_config (C = 4 x 8) and cli_config (C = 4 x 20)
SHARD_SHAPES = (("bench_pt2", 1024, "bench"), ("cli_pt2", 4096, "cli"))
CLI_PT_SCANS = 25   # scans of the sharded CLI cell (cli_jax_poses.txt's first)
# a sharded bench cell's correspondence count a scan against phase 4's:
# within this share (+1), the bar of tests/test_torch_sharded.py against
# JAX; a reduction that gave the ranks a wrong sum misses it
SHARD_CORR_FRAC = 0.005
# ekf-bench ouster's flags of 11d (tools/make_torch_reference.py's
# debug_scene reference: scans 0-10, a knot every second scan)
DEBUG_SCENE_FLAGS = ["--use-imu-prediction", "--end-scan", "10",
                     "--debug-scene-stride", "2"]


def shard_scene(dev, which: str, n: int):
    """K3's and K5's inputs at a shard's shapes: ``icp_scene``'s map over
    the 7-neighbourhood and 4 voxels of 8 points (bench, C = 32), or
    ``cli_map_scene``'s over the 27-neighbourhood and 4 voxels of 20 (CLI,
    C = 80), with ``n`` source points."""
    if which == "bench":
        m, src, mask, t = icp_scene(dev, n=n)
        vs, nb = 0.3, 7
    else:
        m, src, mask, t = cli_map_scene(dev)
        src, mask = src[:n].contiguous(), mask[:n].contiguous()
        vs, nb = 0.7, 27
    q_w = se3.transform(t, src)
    cand = icp.gather_candidates(m, q_w, voxel_size=vs, max_probes=2,
                                 neighborhood=nb, n_voxels=4,
                                 fit_planes=False)
    return t, src, mask, q_w, cand, 1.5 * vs


def check_shard_kernels(dev, results) -> dict:
    """11a: K3 and K5 at the shard shapes against their twins (K3: the
    lane-major rows bit for bit and feat at phase 3's bars; K5 on K3's rows:
    n_corr exact, jtj / jtr / total weight at 1e-5 relative; both repeat
    bit for bit), with device us and bounds."""
    kern = torch.tensor(0.1667, device=dev)
    max_d2 = torch.tensor(2.25, device=dev)
    out = {}
    for tag, n, which in SHARD_SHAPES:
        t, src, mask, q_w, cand, r = shard_scene(dev, which, n)
        pk, _, err = check_prep(cand, mask, q_w, r, f"11a gn_prep {tag}")
        c = pk.cx.shape[0]
        check(pk.cx.shape == (32 if which == "bench" else 80, n),
              f"11a {tag}: candidates {tuple(pk.cx.shape)}")

        def k3():
            return cuda_gn.prep_with_plane(cand, mask, q_w, r)

        def k5():
            return cuda_gn.gn_prepped(t, src, pk, kern, max_d2,
                                      plane_min_quality=0.2)

        (jk, rk, nk, wk) = k5()
        (jp, rp, np_, wp) = cuda_gn.gn_prepped_torch(
            t, src, pk, kern, max_d2, plane_min_quality=0.2)
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in ((jk, jp), (rk, rp), (wk, wp))]
        check(int(nk) == int(np_) > 100,
              f"11a gn_iter {tag}: n_corr {int(nk)} vs {int(np_)}")
        check(max(rel) < 1e-5, f"11a gn_iter {tag}: rel {rel}")
        check(all(torch.equal(a, b) for a, b in zip(k5(), (jk, rk, nk, wk))),
              f"11a gn_iter {tag} does not repeat bit for bit")
        prep = dict(max_abs_err=err, ms=cuda_ms(k3, 200),
                    plain_ms=cuda_ms(lambda: cuda_gn.prep_with_plane_torch(
                        cand, mask, q_w, r), 20),
                    device_us=kernel_us(k3, "gn_prep"),
                    **bound(nbytes(cand.pts, cand.valid, q_w, mask, pk),
                            n * (20 * c + 150)))
        build = dict(max_abs_err=max(float((jk - jp).abs().max()),
                                     float((rk - rp).abs().max()),
                                     float((wk - wp).abs())),
                     ms=cuda_ms(k5, 200),
                     plain_ms=cuda_ms(lambda: cuda_gn.gn_prepped_torch(
                         t, src, pk, kern, max_d2, plane_min_quality=0.2),
                         20),
                     device_us=kernel_us(k5, "gn_iter", 50),
                     **bound(nbytes(src, pk, t), n * (8 * c + 120)))
        say(f"  11a {tag} (N={n}, C={c}): gn_prep "
            f"{prep['device_us']:.2f} us (bound "
            f"{prep['bound_ms'] * 1e3:.3f} us), gn_iter n_corr {int(nk)} "
            f"exact, rel {max(rel):.2e} (1e-5), "
            f"{build['device_us']:.2f} us (bound "
            f"{build['bound_ms'] * 1e3:.3f} us); both repeat bit for bit")
        out[tag] = dict(gn_prep=prep, gn_iter=build)
        for name in ("gn_prep", "gn_iter"):
            results.setdefault(name, {}).setdefault("shard", {})[tag] = \
                out[tag][name]
    return out


def run_sharded_path(scene, dev, bench_out, card: str):
    """11b-c: ``parallel.sharded.run_sharded`` on the bench scene, a rank a
    process, each run twice from a fresh state (a warm-up, then the timed
    run, whose launches and reads are counted): ``bench_config`` at world
    size 1 with NCCL on the card (host syncs made errors but the counted
    reads), ``bench_config``, the same with ``fused_gather=True`` (K6 on
    each rank's shard) and ``cli_config(128, 1024)`` (the refresh loop,
    the first ``CLI_PT_SCANS`` scans) at world size 2 with gloo, both
    ranks on the one card (gloo stages each all-reduce through host
    memory); with two cards also NCCL across them. Every rank bit-equal,
    every pose within 0.02 m of the JAX reference, K4 never, K5 once a GN
    iteration (the summed iterations) with one all-reduce after each, K3
    (bench; K6 fused) and K1 once a scan. The bench cells also against
    phase 4's single run (K4): each scan's correspondence count within
    ``SHARD_CORR_FRAC``, and, printed, the scans whose GN iteration count
    differs and the pose gap before the first of them. Returns (cells,
    launches by cell)."""
    from ptudes_tpu_torch.parallel import sharded

    sensor, scans, scan_ts, gt_mid, imu = scene
    n_all = scans.shape[0]
    h, w = scans.shape[1:]
    lut = convert.lut_from_numpy(sensor.lut, dev)
    bench, cli = config.bench_config(), config.cli_config(h, w)
    fused = dataclasses.replace(bench, kiss=dataclasses.replace(
        bench.kiss, fused_gather=True))
    plan = [("bench_pt1", bench, n_all, ["cuda:0"], "nccl", "bench"),
            ("bench_pt2", bench, n_all, ["cuda:0"] * 2, "gloo", "bench"),
            ("bench_fused_pt2", fused, n_all, ["cuda:0"] * 2, "gloo",
             "bench_fused"),
            ("cli_pt2", cli, min(CLI_PT_SCANS, n_all), ["cuda:0"] * 2,
             "gloo", "cli")]
    if torch.cuda.device_count() >= 2:
        plan.append(("bench_pt2_nccl", bench, n_all, ["cuda:0", "cuda:1"],
                     "nccl", "bench"))
    single = bench_out.kiss_pose.double().cpu().numpy()
    corr4 = bench_out.aux.num_corr.cpu().numpy().astype(np.int64)
    iters4 = bench_out.aux.iterations.cpu().numpy()
    cells, launches = {}, {}
    for tag, cfg, n, devices, backend, ref_name in plan:
        batches = lio.scan_at(lio.build_batches(
            cfg, scans, scan_ts, imu.lacc, imu.avel, imu.ts, device=dev),
            slice(0, n))
        t0 = time.monotonic()
        run = sharded.run_sharded(
            lio.init_state(cfg, dev), batches, lut, cfg, devices=devices,
            backend=backend, probe=True)
        wall = time.monotonic() - t0
        check((run.backend, run.world_size) == (backend, len(devices)),
              f"11 {tag}: ran {run.backend} x {run.world_size}")
        check(run.ranks_equal, f"11 {tag}: the ranks' outputs differ")
        st = run.rank_stats[0]
        iters = run.out.aux.iterations
        total = int(iters.sum())
        want = {"ekf_predict": n, "gn_iter": total}
        if cfg.kiss.nn_refresh_drift == 0.0:
            want.update(ekf_update=n)
            want["gather_fused" if cfg.kiss.fused_gather else "gn_prep"] = n
        check(all(c == want.get(name, 0)
                  for name, c in st["launches"].items()),
              f"11 {tag}: launches {st['launches']}, want {want}")
        check(st["allreduces"] == total,
              f"11 {tag}: {st['allreduces']} all-reduces, {total} builds")
        capped = int((iters == cfg.kiss.max_iterations).sum())
        check(st["host_reads"] == total - capped,
              f"11 {tag}: {st['host_reads']} host reads")
        kp = run.out.kiss_pose.double().numpy()
        check(bool(np.isfinite(kp).all()), f"11 {tag}: non-finite poses")
        _, ref = ref_poses(ref_name)
        err = np.linalg.norm(kp[:, :3, 3] - ref[:n, :, 3], axis=1)
        check(float(err.max()) <= POSE_GATE_M,
              f"11 {tag}: pose vs JAX {err.max():.4f} m > {POSE_GATE_M} m")
        vs_single = None
        if tag.startswith("bench_pt"):
            d_corr = (run.out.aux.num_corr.numpy().astype(np.int64)
                      - corr4[:n])
            it_diff = np.flatnonzero(iters.numpy() != iters4[:n])
            first = int(it_diff[0]) if len(it_diff) else n
            gap = np.linalg.norm(kp[:, :3, 3] - single[:n, :3, 3], axis=1)
            above = np.flatnonzero(gap > 1e-5)
            vs_single = dict(
                max_pose_m=float(np.abs(kp - single[:n]).max()),
                max_num_corr_diff=int(np.abs(d_corr).max()),
                scans_num_corr_differ=int((d_corr != 0).sum()),
                first_scan_num_corr_differs=(int(np.flatnonzero(d_corr)[0])
                                             if d_corr.any() else None),
                scans_iterations_differ=int(len(it_diff)),
                first_scan_iterations_differ=(first if first < n else None),
                first_scan_trans_above_1e5_m=(int(above[0]) if len(above)
                                              else None),
                iterations_minus_phase4=int(iters.numpy().sum()
                                            - iters4[:n].sum()),
                max_trans_before_first_m=float(gap[:first].max()
                                               if first else 0.0),
                max_trans_from_first_m=float(gap[first:].max()
                                             if first < n else 0.0))
        cells[tag] = dict(
            backend=backend, world_size=len(devices), devices=devices,
            scans=n, seconds=st["seconds"],
            scans_per_s=n / st["seconds"][-1], wall_s=wall,
            gn_iterations=total, allreduces_per_scan=total / n,
            allreduce_us=st["allreduce_us"], host_reads=st["host_reads"],
            max_pose_vs_jax_m=float(err.max()),
            vs_phase4=vs_single, launches=st["launches"],
            ranks_equal=run.ranks_equal, card=card)
        launches[f"sharded_{tag}"] = st["launches"]
        say(f"  11 {tag}: {backend} x {len(devices)} on {devices}: "
            f"{cells[tag]['scans_per_s']:.2f} scans/s (timed run "
            f"{st['seconds'][-1]:.3f} s, warm-up {st['seconds'][0]:.3f} s), "
            f"{total / n:.2f} all-reduces a scan, "
            f"{st['allreduce_us']:.1f} us an all-reduce (probe), ranks "
            f"bit-equal, max |pose - JAX| {err.max():.4f} m"
            + ("" if vs_single is None else
               f"; against phase 4: max |pose - phase 4| "
               f"{vs_single['max_pose_m']:.3e}, num_corr differs on "
               f"{vs_single['scans_num_corr_differ']} of {n} scans (first "
               f"{vs_single['first_scan_num_corr_differs']}, max "
               f"{vs_single['max_num_corr_diff']}, bar {SHARD_CORR_FRAC:.1%} "
               f"+ 1), GN iterations differ on "
               f"{vs_single['scans_iterations_differ']} scans (first "
               f"{vs_single['first_scan_iterations_differ']}, summed "
               f"{vs_single['iterations_minus_phase4']:+d}), max |trans - "
               f"phase 4| {vs_single['max_trans_before_first_m']:.3e} m "
               f"before that scan, "
               f"{vs_single['max_trans_from_first_m']:.3e} m from it; "
               f"first scan more than 1e-5 m off "
               f"{vs_single['first_scan_trans_above_1e5_m']}")
            + f"; launches {st['launches']}")
        if vs_single is not None:
            check(bool(np.all(np.abs(d_corr)
                              <= SHARD_CORR_FRAC * corr4[:n] + 1)),
                  f"11 {tag}: num_corr - phase 4 {d_corr.tolist()}")
    return cells, launches


def run_debug_scene_path(scene, dev, card: str):
    """11d: the command paths of ``viz`` on the bench scene written as an
    Ouster recording (phase 9's writer), on the card: ``ekf-bench ouster
    -g gt.csv --save-kitti-poses --save-map-ply --save-debug-scene`` with
    ``DEBUG_SCENE_FLAGS`` (scans 0-10; the scene exported every second
    scan), each knot's ICP and EKF pose within 0.02 m of
    ``tests/data/debug_scene_jax_poses.txt`` and the saved poses of
    ``cli_pcap_jax_poses.txt``'s first rows; ``flyby --kitti-poses`` (a
    finite PLY and a camera program); ``viz --stream-dir --max-scans 5``
    (the player's files); a plot flag refused where matplotlib is
    missing. Returns (summary, the ouster command's launches)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import make_torch_fixture
    from ptudes_tpu_torch.cli import main as cli
    from ptudes_tpu_torch.viz import cloud

    ref = np.loadtxt(os.path.join(HERE, "tests", "data",
                                  "debug_scene_jax_poses.txt"), ndmin=2)
    _, pcap_ref = ref_poses("cli_pcap")
    h, w = scene[1].shape[1:]
    tmp = tempfile.mkdtemp(prefix="ptudes_viz_")
    try:
        rec, meta, gt = make_torch_fixture.bench(tmp, scene=scene)
        kitti, ply = os.path.join(tmp, "k.txt"), os.path.join(tmp, "m.ply")
        sdir = os.path.join(tmp, "scene")
        kernels.reset_launches()
        icp.reset_refresh_counts()
        t = time.monotonic()
        res = cli.run(["ekf-bench", "ouster", rec, "-m", meta, "-g", gt,
                       "--save-kitti-poses", kitti, "--save-map-ply", ply,
                       "--save-debug-scene", sdir] + DEBUG_SCENE_FLAGS)
        wall = time.monotonic() - t
        launches = launch_counts()
        n = res["n_scans"]
        cmd_iters = int(res["iterations"].sum()
                        + res["iterations_first"].sum())
        # K1 once a scan in each of the command's two runs and twice a
        # scan in the export (its step, and the prediction it writes as
        # pred_pose); K5 once a GN iteration of each (the export's
        # iterations are not the command's: its whole-frame insert makes
        # other maps)
        check(launches["ekf_predict"] == 4 * n
              and launches["gn_iter"] > cmd_iters
              and all(launches[k] == 0 for k in launches
                      if k not in ("ekf_predict", "gn_iter")),
              f"11d: launches {launches} ({n} scans, {cmd_iters} command "
              "GN iterations)")
        kp = np.loadtxt(kitti).reshape(-1, 3, 4)
        err_k = np.linalg.norm(kp[:, :, 3] - pcap_ref[:n, :, 3], axis=1)
        check(float(err_k.max()) <= POSE_GATE_M,
              f"11d: saved poses vs JAX {err_k.max():.4f} m")
        knots = res["debug_scene"]["knots"]
        check(knots == [int(k) for k in ref[:, 0]],
              f"11d: knots {knots}, JAX {ref[:, 0]}")
        worst, corr_diff, iter_diff = 0.0, [], []
        for row in ref:
            k = int(row[0])
            with open(os.path.join(sdir, f"knot_{k:04d}.json")) as f:
                m = json.load(f)
            for key, cols in (("icp_pose", row[3:15]), ("ekf_pose",
                                                      row[15:27])):
                e = float(np.linalg.norm(np.asarray(m[key])[:3, 3]
                                         - cols.reshape(3, 4)[:, 3]))
                worst = max(worst, e)
            corr_diff.append(m["num_corr"] - int(row[1]))
            iter_diff.append(m["iterations"] - int(row[2]))
            src = cloud.load_ply(os.path.join(sdir,
                                              f"knot_{k:04d}_source.ply"))
            check(len(src) == m["num_corr"] and np.isfinite(src).all(),
                  f"11d: knot {k} source {len(src)} of {m['num_corr']}")
        check(worst <= POSE_GATE_M, f"11d: knot pose vs JAX {worst:.4f} m")
        mp = cloud.load_ply(ply)
        fmap = res["state"].kiss.local_map
        # a slot's count can pass its row of points (8 of 3494 slots after
        # these scans on the CPU); map_to_points and the PLY hold the
        # stored points, at most a row a slot
        stored = int(fmap.meta[:, 1].clamp(max=fmap.points.shape[1]).sum())
        check(len(mp) == stored > 0 and bool(np.isfinite(mp).all()),
              f"11d: map PLY {mp.shape}, {stored} stored points")

        fply, cam = os.path.join(tmp, "fly.ply"), os.path.join(tmp, "c.json")
        t = time.monotonic()
        fly = cli.run(["flyby", rec, "-m", meta, "--kitti-poses", kitti,
                       "--end-scan", "10", "-o", fply, "--camera-json", cam])
        fly_s = time.monotonic() - t
        fp = cloud.load_ply(fply)
        with open(cam) as f:
            prog = json.load(f)
        check(len(fp) == fly["points"] > 0 and bool(np.isfinite(fp).all())
              and len(prog) > 0 and set(prog[0]) == {"t", "target", "pitch",
                                                     "yaw", "dolly"},
              f"11d flyby: {len(fp)} points, {len(prog)} keyframes")
        stream = os.path.join(tmp, "stream")
        cli.run(["viz", rec, "-m", meta, "--stream-dir", stream,
                 "--max-scans", "5"])
        with open(os.path.join(stream, "stream.json")) as f:
            sj = json.load(f)
        check(sj["n"] == 5 and os.path.getsize(os.path.join(
            stream, "ranges.bin")) == 5 * h * w * 2 and os.path.exists(
            os.path.join(stream, "viewer_stream.html")),
            f"11d viz --stream-dir: {sorted(os.listdir(stream))}")
        try:
            import matplotlib  # noqa: F401
            plots = "matplotlib is installed: the plot flags run"
        except ImportError:
            rc = cli.main(["ekf-bench", "sim", "-p", "graphs"])
            check(rc == 2, f"11d: -p graphs without matplotlib gave rc {rc}")
            plots = "matplotlib is missing: -p graphs refused (exit 2)"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  11d: ekf-bench ouster with the exports {wall:.2f} s ({n} scans, "
        f"{len(knots)} knots {knots}), max |knot pose - JAX| {worst:.4f} m, "
        f"num_corr - JAX {corr_diff}, iterations - JAX {iter_diff}, saved "
        f"poses within {err_k.max():.4f} m; map PLY {len(mp)} points; flyby "
        f"{len(fp)} points, {len(prog)} keyframes in {fly_s:.2f} s; viz "
        f"--stream-dir {sj['n']} scans; {plots}; launches {launches}")
    return dict(wall_s=wall, scans=n, knots=knots,
                max_knot_pose_vs_jax_m=worst, num_corr_minus_jax=corr_diff,
                iterations_minus_jax=iter_diff,
                max_pose_vs_jax_m=float(err_k.max()), map_points=len(mp),
                flyby_points=len(fp), flyby_keyframes=len(prog),
                flyby_s=fly_s, plots=plots, launches=launches,
                card=card), launches


def run_phase11(scene, dev, bench_out, card: str, results) -> dict:
    """Phase 11: the point-sharded driver and the viz paths (11a-d); prints
    one JSON line of its figures. Returns the launches by path."""
    shapes = check_shard_kernels(dev, results)
    cells, launches = run_sharded_path(scene, dev, bench_out, card)
    viz, launches["debug_scene_pcap"] = run_debug_scene_path(scene, dev,
                                                             card)
    say(json.dumps(dict(phase11=dict(shard_shapes=shapes, sharded=cells,
                                     debug_scene_pcap=viz, card=card))))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=50,
                    help="scans of the bench scene to run (default 50)")
    ap.add_argument("--phases", default="all",
                    help="comma list of the phases to run after 1-2 "
                    "(default all; 10 runs phases 4, 5 and 7a-b first, "
                    "whose runs it compares with, 11 runs phase 4 first)")
    args = ap.parse_args()
    want = set(range(3, 12)) if args.phases == "all" else {
        int(x) for x in args.phases.split(",")}
    if 10 in want:
        want |= {5, 7}
    if want & {5, 7, 11}:
        want.add(4)

    say("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    say("phase 2: build")
    t0 = time.monotonic()
    path = kernels.build()
    kernels.lib()
    say(f"  built {os.path.relpath(path, HERE)} in "
        f"{time.monotonic() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        spills = "spill" in line and " 0 bytes spill" not in line
        if "registers" in line or spills:
            say(f"  {line.strip()}")
    sass = sass_sizes(path, "gn_prep_kernel")
    # the template instances: ILb1E the plane fit, ILb0E the point mode
    k3_sass = None if sass is None else {
        ("plane" if "ILb1E" in k else "point" if "ILb0E" in k else k): v
        for k, v in sass.items()}
    say("  K3 SASS instructions: " + (
        str(k3_sass) if k3_sass is not None else "not measured (no "
        "cuobjdump)"))

    results: dict[str, dict] = {}
    if want != set(range(3, 12)):
        # a subset, for working on a phase: its own checks, no summary
        if 3 in want:
            say("phase 3: kernels against their twins")
            check_ekf(dev, np.random.default_rng(0), results)
            check_icp(dev, results)
        if 4 in want:
            say("phase 4: bench path")
            _, scene, bench_out, _, _ = run_main_path(args.scans, dev)
        card = card_line()
        if 5 in want:
            say("phase 5: CLI path")
            _, cli_out = run_cli_path(scene, dev, card)
        if 7 in want:
            say("phase 7: the CLI's EKF-facing paths (a, b)")
            _, assoc_out = run_kiss_paths(scene, dev, card)
        if 10 in want:
            say("phase 10: several sequences at once")
            run_phase10(scene, dev, bench_out, cli_out, assoc_out, card,
                        results)
        if 11 in want:
            say("phase 11: point-sharded LIO and the viz paths")
            run_phase11(scene, dev, bench_out, card, results)
        say(f"phases {sorted(want)} passed (a subset: no kernel summary)")
        say(card_line())
        return 0

    say("phase 3: kernels against their twins")
    rng = np.random.default_rng(0)
    check_ekf(dev, rng, results)
    check_icp(dev, results)
    results["gn_prep"]["sass_instructions"] = k3_sass
    check_icp_streamed(dev, results)
    check_gn_iter(dev, results)
    check_ties(dev)
    check_refresh_loop(dev)
    check_gather(dev, results)
    check_fused_registration(dev)
    phase3 = {"plane_moments": check_plane_moments(dev, results)}

    say("phase 4: bench path")
    bench_launches, scene, bench_out, bench_rate, repeat = run_main_path(
        args.scans, dev)
    bench = config.bench_config()
    card = card_line()
    say("phase 5: CLI path")
    cli_launches, cli_out = run_cli_path(scene, dev, card)
    say("phase 6: fused bench path")
    fused = dataclasses.replace(bench, kiss=dataclasses.replace(
        bench.kiss, fused_gather=True))
    fused_launches, fused_out, sm = run_option_path(
        scene, dev, fused, "6 bench fused", "bench_fused",
        once_a_scan("ekf_predict", "gather_fused", "icp_loop", "ekf_update"),
        card=card, ate_max=ATE_GATE_M, twins=True)
    vs_bench = (fused_out.kiss_pose - bench_out.kiss_pose)[:, :3, 3].abs()
    say(f"  6: {sm['scans_per_s']:.2f} scans/s against phase 4's "
        f"{bench_rate:.2f} in this call; max |pose - phase 4| "
        f"{float(vs_bench.max()):.4f} m")
    by_path = {"bench": bench_launches, "cli": cli_launches,
               "bench_fused": fused_launches}
    say("phase 7: the CLI's EKF-facing paths")
    kiss_launches, assoc_out = run_kiss_paths(scene, dev, card)
    by_path.update(kiss_launches)
    by_path["bench_log"] = run_log_path(scene, args.scans, dev, bench_out,
                                        bench_rate, repeat)
    by_path["sim_filter"] = run_filter_path(dev)
    say("phase 8: the pipeline's remaining options")
    by_path.update(run_phase8(scene, dev, bench_out, card))
    say("phase 9: the recording path through the command line")
    by_path.update(run_recording_path(scene, dev, card))
    say("phase 10: several sequences at once (the batched driver, "
        "ekf-bench sweep)")
    by_path.update(run_phase10(scene, dev, bench_out, cli_out, assoc_out,
                               card, results))
    say("phase 11: point-sharded LIO (parallel.sharded) and the viz paths")
    by_path.update(run_phase11(scene, dev, bench_out, card, results))

    rows = []
    for name in (*kernels.KERNELS, *kernels.VARIANT_LAUNCHES):
        paths = {p: n[name] for p, n in by_path.items() if n[name]}
        if name in phase3:
            # K7: no pipeline path calls it (the JAX package moved the fit
            # into K3), so its row reports its phase-3 checks
            check(not paths, f"{name} launched on a path: {paths}")
            paths = {"phase3": phase3[name]}
        check(bool(paths), f"{name} launched on no path")
        rows.append(dict(
            name=name, route="cuda",
            source=f"ptudes_tpu_torch/csrc/{REPLACES[name][0]}",
            replaces=REPLACES[name][1], path="+".join(paths),
            launches=sum(paths.values()), launches_by_path=paths,
            library_ms=None, **results[name]))
    say(json.dumps({"kernels": rows}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
