"""Benchmark: the PyTorch port's fused LIO (ICP + EKF) scan throughput on
one CUDA card — the port of ``bench.py``, which imports no JAX.

    python3 bench_torch.py                        # on the card
    python3 bench_torch.py --device cpu --scans 3 --replicas 2 --runs 1

The bench scene (``sim.bench_scene``: 50 scans of 128 x 1024 on an 8 m
circle, rendered over a process pool into the temp dir, cached) runs at
``config.bench_config()`` through ``lio.run_sequence`` in its default
form on the card, a replayed CUDA graph (K1-K4 and K8 once a scan, K9
twice). The first call is set-up: the graph runner's warm-up and
capture, reported as ``compile_s``. Then ``--runs`` calls of the kept
runner are timed, each from a synchronize to a synchronize with host
syncs made errors, alternating with eager calls (graph, eager; eager,
graph; ...): the host clock varies between runs, so only alternating runs
compare. ``value`` is the median graph scans/s; each run and the eager
median are printed beside it. Kernel build and scene render are timed apart.

``vs_baseline``: ratio against ``tools/oracle_kiss.py``'s OracleLio, the
policy-identical f64 numpy LIO oracle, on the host's CPU over the same
scans, fed by the port's ``scan_to_points``. Replicas: ``parallel.batched
.run_sequence_batched`` on 2 and 4 copies of the scene (aggregate
scans/s, the median of ``--runs`` graph calls after a set-up call).

Gates (the script exits 1 if one fails): every pose within 0.02 m of
``tests/data/bench_jax_poses.txt`` (the JAX package's run of this scene),
ATE RMSE <= 0.02 m and <= 1.05x the oracle's. The last line of standard
output is one JSON object with ``bench.py``'s keys and the port's
(``device``, ``power_limit``, ``form``, ``kernels``, ``runs``).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

from ptudes_tpu_torch import config  # noqa: E402
from ptudes_tpu_torch.models import lio, sim  # noqa: E402
from ptudes_tpu_torch.ops.projection import scan_to_points  # noqa: E402
from ptudes_tpu_torch.parallel import batched, replay  # noqa: E402
from ptudes_tpu_torch.utils import benchrun, convert, metrics  # noqa: E402

REF_POSES = os.path.join(HERE, "tests", "data", "bench_jax_poses.txt")
ATE_GATE_M = 0.02    # bench.py's absolute gate
REL_GATE = 1.05      # bench.py's gate against the oracle's ATE
POSE_GATE_M = 0.02   # each pose against the JAX package's


def say(msg: str) -> None:
    print(msg, flush=True)


def sequence_runs(cfg, batches, lut, dev, runs: int) -> dict:
    """The set-up call, an untimed eager call, then ``runs`` timed graph
    calls of the kept runner alternating with eager calls (on the CPU,
    which has no graph, ``runs`` eager calls). Each call starts from a
    fresh state made before the clock starts; each is checked to have run
    in its form, K1-K4 and K8 once a scan and K9 twice on a card."""
    n = batches.range_m.shape[0]
    cuda = dev.type == "cuda"

    def call(form, cached=True):
        state = lio.init_state(cfg, dev)
        run = benchrun.timed(lambda: lio.run_sequence(
            state, batches, lut, cfg=cfg,
            graph=None if form == "graph" else False), dev)
        benchrun.check_form(run, form, cached)
        if cuda:
            benchrun.check_launches(run, n, benchrun.BENCH_LAUNCHES)
        return run

    setup = call("graph" if cuda else "eager", cached=False)
    forms = ["eager"] * runs
    if cuda:
        call("eager")                                 # untimed warm-up
        forms = [f for i in range(runs) for f in (
            ("graph", "eager") if i % 2 == 0 else ("eager", "graph"))]
    return dict(setup=setup, timed=[(f, call(f)) for f in forms])


def oracle(sensor, scans, scan_ts, gt_mid, imu) -> tuple[float, float]:
    """``bench.py:bench_cpu_oracle`` with the port's ``scan_to_points``:
    (scans/s, ATE RMSE m) of OracleLio over the whole sequence."""
    from oracle_kiss import OracleLio

    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    ok = OracleLio(voxel_size=0.3, max_range=70.0, min_range=1.0,
                   max_iters=30, loss="plane", plane_min_quality=0.2,
                   plane_radius=0.6, prior_rot_weight=0.01,
                   prior_trans_weight=0.01)
    imu_ts = np.arange(1, len(scans) * 10 + 2) * 0.01   # bench.py:59, f64
    pts_list = []
    prev = -np.inf
    for i in range(len(scans)):
        pts, mask, ts01 = scan_to_points(lut, torch.as_tensor(scans[i]))
        m = mask.numpy()
        sel = np.where((imu_ts > prev) & (imu_ts <= scan_ts[i]))[0]
        prev = scan_ts[i]
        pts_list.append((pts.numpy().astype(np.float64)[m],
                         ts01.numpy().astype(np.float64)[m],
                         imu.lacc[sel], imu.avel[sel], imu_ts[sel]))
    t0 = time.monotonic()
    for p, t01, la, av, it in pts_list:
        ok.process(p, t01, la, av, it)
    dt = time.monotonic() - t0
    _, ate = metrics.calc_ate_rmse(np.asarray(ok.poses), gt_mid)
    return len(scans) / dt, float(ate)


def replica_runs(cfg, batches, lut, dev, counts, runs: int) -> dict:
    """Aggregate scans/s of ``run_sequence_batched`` on ``r`` copies of the
    scene for each ``r`` of ``counts``: a set-up call, then ``runs`` timed
    calls (the kept runner's on a card); each call's seconds and the
    largest pose difference from the single run's reference poses."""
    n = batches.range_m.shape[0]
    form = "graph" if dev.type == "cuda" else "eager"
    rows = {}
    for r in counts:
        stacked = replay.stack_bags([batches] * r)

        def call():
            states = replay.stack_bags([lio.init_state(cfg, dev)
                                        for _ in range(r)])
            return benchrun.timed(lambda: batched.run_sequence_batched(
                states, stacked, lut, cfg=cfg), dev)

        benchrun.check_form(call(), form)
        timed = [call() for _ in range(runs)]
        for run in timed:
            benchrun.check_form(run, form, cached=True)
            if dev.type == "cuda":
                benchrun.check_launches(run, n, benchrun.BENCH_LAUNCHES)
        rows[f"x{r}"] = dict(
            s=[run["s"] for run in timed],
            scans_per_sec=benchrun.median([r * n / run["s"]
                                           for run in timed]),
            poses=timed[-1]["result"][1].kiss_pose.double().cpu().numpy())
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the rehearsal: the "
                    "kernels' plain twins, eager form only")
    ap.add_argument("--scans", type=int, default=sim.BENCH_SCANS,
                    help="scans of the bench scene (default 50)")
    ap.add_argument("--runs", type=int, default=5,
                    help="timed calls of each form (default 5)")
    ap.add_argument("--replicas", default="2,4",
                    help="comma list of replica counts (default 2,4)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes rendering the scene (default: every "
                    "core)")
    ap.add_argument("--cache-dir", default=None,
                    help="where the rendered scene is cached (default: "
                    "the temp dir)")
    ap.add_argument("--poses-out", default=None,
                    help="also write the timed run's poses there, a row "
                    "of 12 (the 3 x 4 pose) a scan")
    args = ap.parse_args(argv)
    counts = [int(x) for x in args.replicas.split(",") if x]

    dev = benchrun.open_device(args.device)
    card = benchrun.card_line(dev)
    say(f"device {benchrun.device_name(dev)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}; "
        f"os.cpu_count() {os.cpu_count()}")
    t0 = time.monotonic()
    sensor, scans, scan_ts, gt_mid, imu = sim.bench_scene(
        args.scans, cache_dir=args.cache_dir, workers=args.workers)
    render_s = time.monotonic() - t0
    say(f"scene: {len(scans)} scans of {scans.shape[1]}x{scans.shape[2]} "
        f"in {render_s:.1f} s ({args.workers} processes)")
    build_s = benchrun.build_kernels(dev)
    if build_s is not None:
        say(f"kernels built in {build_s:.1f} s")

    cfg = config.bench_config()
    lut = convert.lut_from_numpy(sensor.lut, dev)
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu.ts, device=dev)
    seq = sequence_runs(cfg, batches, lut, dev, args.runs)
    setup = seq["setup"]
    main_form = setup["record"]["form"]
    n = len(scans)
    rates = {f: [n / run["s"] for g, run in seq["timed"] if g == f]
             for f in ("graph", "eager")}
    for g, run in seq["timed"]:
        say(f"{g}: {n / run['s']:.2f} scans/s ({run['s']:.4f} s)")
    value = benchrun.median(rates[main_form])
    last = [run for g, run in seq["timed"] if g == main_form][-1]
    poses = last["result"][1].kiss_pose.double().cpu().numpy()
    first = setup["result"][1].kiss_pose
    repeat = all(torch.equal(run["result"][1].kiss_pose, first)
                 for _, run in seq["timed"])

    t0 = time.monotonic()
    cpu_rate, cpu_ate = oracle(sensor, scans, scan_ts, gt_mid, imu)
    say(f"oracle: {cpu_rate:.3f} scans/s, ATE RMSE {cpu_ate:.4f} m "
        f"({time.monotonic() - t0:.1f} s)")
    reps = replica_runs(cfg, batches, lut, dev, counts, args.runs)

    ref = np.loadtxt(REF_POSES).reshape(-1, 3, 4)[:n]
    pose_err = float(np.linalg.norm(poses[:, :3, 3] - ref[:, :, 3],
                                    axis=1).max())
    finite = bool(np.isfinite(poses).all())
    _, ate = metrics.calc_ate_rmse(poses, gt_mid) if finite else (0, np.inf)
    rel_pass = bool(ate <= REL_GATE * cpu_ate)
    abs_pass = bool(ate <= ATE_GATE_M)
    pose_pass = bool(finite and pose_err <= POSE_GATE_M)
    result = {
        "metric": "lio_scans_per_sec_per_chip",
        "value": value,
        "unit": f"scans/s ({scans.shape[1]}x{scans.shape[2]}, ICP+EKF "
                "fused step)",
        "vs_baseline": value / cpu_rate,
        "baseline": {
            "what": "policy-identical f64 numpy LIO oracle on host CPU "
                    "(tools/oracle_kiss.py OracleLio fed by the port's "
                    f"scan_to_points), full {n}-scan sequence",
            "cpu_scans_per_sec": cpu_rate,
            "cpu_ate_rmse_m": cpu_ate,
        },
        "quality": {
            "ate_rmse_m": float(ate),
            "vs_oracle_ate": float(ate) / max(cpu_ate, 1e-9),
            "gate_rel": f"ATE <= {REL_GATE}x oracle ATE",
            "gate_rel_pass": rel_pass,
            "gate_abs": f"ATE RMSE <= {ATE_GATE_M} m",
            "gate_abs_pass": abs_pass,
            "gate_pose": f"every pose within {POSE_GATE_M} m of "
                         "tests/data/bench_jax_poses.txt",
            "gate_pose_pass": pose_pass,
            "max_pose_err_m": pose_err,
            "gate_pass": rel_pass and abs_pass and pose_pass,
        },
        "replica_aggregate_scans_per_sec": {
            k: v["scans_per_sec"] for k, v in reps.items()},
        "replica_note": "parallel.batched.run_sequence_batched: the "
                        "replicas' maps in one flat table, each kernel "
                        "launched once a scan for all replicas; median of "
                        f"{args.runs} calls after a set-up call",
        "compile_s": (setup["record"]["capture_ms"] / 1e3
                      if main_form == "graph" else None),
        "device": benchrun.device_name(dev),
        "power_limit": benchrun.power_limit(card),
        "form": main_form,
        "kernels": benchrun.kernel_list(last["launches"]),
        "runs": {
            "graph_scans_per_sec": rates["graph"],
            "eager_scans_per_sec": rates["eager"],
            "eager_median_scans_per_sec": benchrun.median(rates["eager"]),
            "order": [g for g, _ in seq["timed"]],
            "bit_equal_to_setup": repeat,
        },
        "setup": {
            "first_call_s": setup["s"],
            "capture_ms": setup["record"].get("capture_ms"),
            "pool_mb": setup["record"].get("pool_mb"),
            "build_s": build_s,
            "render_s": render_s,
            "render_workers": args.workers,
        },
        "replica_runs": {k: {"s": v["s"], "max_pose_err_m": float(
            np.linalg.norm(v["poses"][..., :3, 3] - ref[None, :, :, 3],
                           axis=-1).max())} for k, v in reps.items()},
        "nvidia_smi": card,
    }
    if args.poses_out:
        np.savetxt(args.poses_out, poses[:, :3].reshape(n, 12))
    print(json.dumps(result), flush=True)
    return 0 if result["quality"]["gate_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
