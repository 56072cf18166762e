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
     summaries with the card's name and power limit.
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
from ptudes_tpu_torch.utils import checkpoint, convert, metrics

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
    kept 34 of 50 once, with every launch checked), so a short count is
    profiled again up to twice, then the mean of what it kept is used and
    the count printed; no record, or more than one a call, fails."""
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
    check(0 < len(ds) <= reps, f"{name}: {len(ds)} kernels in {reps} calls")
    if len(ds) < reps:
        say(f"  {name}: the profiler kept {len(ds)} of {reps} kernel records")
    return float(np.mean(ds))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=50,
                    help="scans of the bench scene to run (default 50)")
    args = ap.parse_args()

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

    say("phase 3: kernels against their twins")
    results: dict[str, dict] = {}
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
    h, w = scene[1].shape[1:]
    bench = config.bench_config()
    card = card_line()
    say("phase 5: CLI path")
    cli = config.cli_config(h, w)
    cli_launches, _, _ = run_option_path(
        scene, dev, cli, "5 cli", "cli", cli_want(cli), card=card,
        ate_slack=CLI_ATE_SLACK_M, twins=True)
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
    kiss_cfg = config.cli_config(h, w, guess="kiss")
    by_path["cli_kiss"], _, _ = run_option_path(
        scene, dev, kiss_cfg, "7a cli kiss", "cli_kiss", cli_want(kiss_cfg),
        card=card, ate_slack=CLI_ATE_SLACK_M, twins=True)
    assoc = dataclasses.replace(kiss_cfg, ekf=dataclasses.replace(
        kiss_cfg.ekf, predict_batch="assoc"))
    by_path["cli_kiss_assoc"], _, _ = run_option_path(
        scene, dev, assoc, "7b cli kiss assoc", "cli_kiss", cli_want(assoc),
        card=card, ate_slack=CLI_ATE_SLACK_M)
    by_path["bench_log"] = run_log_path(scene, args.scans, dev, bench_out,
                                        bench_rate, repeat)
    by_path["sim_filter"] = run_filter_path(dev)
    say("phase 8: the pipeline's remaining options")
    by_path.update(run_phase8(scene, dev, bench_out, card))

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
