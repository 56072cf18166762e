"""Endurance run of the PyTorch port on one CUDA card: 1000 scans with map
growth, saturation and eviction churn — the port of ``bench_long.py``,
which imports no JAX.

    python3 bench_long_torch.py                   # on the card
    python3 bench_long_torch.py --device cpu --scans 20 --chunk 10

A 30 m-radius loop (one lap and a re-entry into the mapped start) through a
70 m world of 300 boxes, 64 x 512 scans clipped at 25 m
(``sim.long_scene``, rendered over a process pool into the temp dir and
cached; ``config.long_config()``): the map holds a moving window of the
world, so voxels evict behind the platform while new ones insert ahead.
All chunks' batches are built and put on the device before any timing;
then the chunks of 250 scans run in turn through ``lio.run_sequence`` in
its default form on the card, one kept CUDA-graph runner replayed with the
state carried from chunk to chunk, each chunk timed from a synchronize to
a synchronize with host syncs made errors (chunk 0 includes the runner's
warm-up and capture). Each chunk re-runs its first 3 scans with the
bootstrap insert, and its IMU window starts after the last scan of the
chunk before, as in ``bench_long.py``.

Checks (``bench_long.py``'s thresholds; the script exits 1 if one fails):
every pose finite; map occupancy < 0.95 of the capacity; more than 10
scans after which the map holds fewer points than before (eviction churn);
the steady chunks' rates within 25 % of each other; ATE RMSE against the
exact mid-sweep poses < 0.25 m; end-of-lap position error < 1 m. The last
line of standard output is one JSON object with ``bench_long.py``'s keys
and the port's (``device``, ``power_limit``, ``form``, ``capture_ms``,
``render_s``).
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

from ptudes_tpu_torch import config  # noqa: E402
from ptudes_tpu_torch.models import lio, sim  # noqa: E402
from ptudes_tpu_torch.utils import benchrun, convert, metrics  # noqa: E402

CHUNK = 250


def say(msg: str) -> None:
    print(msg, flush=True)


def chunk_batches(cfg, scans, scan_ts, imu, imu_ts, chunk: int, dev):
    """Each chunk's batches on ``dev`` (``bench_long.py:111-126``): chunk
    c's first IMU window starts after scan ``chunk * c - 1``."""
    out = []
    for lo in range(0, len(scans) - chunk + 1, chunk):
        sl = slice(lo, lo + chunk)
        out.append(lio.build_batches(
            cfg, scans[sl], scan_ts[sl], imu.lacc, imu.avel, imu_ts,
            prev_scan_ts=scan_ts[lo - 1] if lo else None, device=dev))
    return out


def run_chunks(cfg, state, all_batches, lut, dev):
    """Every chunk in turn from ``state``, the state carried: each chunk's
    :func:`benchrun.timed` record, checked to have run as a graph on a
    card (chunks after the first on the kept runner), K1-K4 and K8 once
    a scan and K9 twice; the outputs copied to numpy after each chunk's synchronize."""
    cuda = dev.type == "cuda"
    runs = []
    for c, batches in enumerate(all_batches):
        run = benchrun.timed(lambda: lio.run_sequence(
            state, batches, lut, cfg=cfg), dev)
        benchrun.check_form(run, "graph" if cuda else "eager",
                            cached=c > 0)
        n = batches.range_m.shape[0]
        if cuda:
            benchrun.check_launches(run, n, benchrun.BENCH_LAUNCHES)
        state, out = run["result"]
        run["out"] = dict(
            kiss_pose=out.kiss_pose.double().cpu().numpy(),
            ekf_cov_diag=out.ekf_cov_diag.double().cpu().numpy(),
            map_points=out.aux.map_points.cpu().numpy().astype(np.int64))
        run["result"] = None
        mp = int(run["out"]["map_points"][-1])
        cap = cfg.cap.map_capacity * cfg.kiss.max_points_per_voxel
        say(f"chunk {c}: {n / run['s']:7.1f} scans/s ({run['s']:.3f} s)  "
            f"map_points={mp} ({mp / cap:.1%} of capacity)")
        runs.append(run)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the rehearsal: the "
                    "kernels' plain twins, eager form only")
    ap.add_argument("--scans", type=int, default=sim.LONG_SCANS,
                    help="scans of the endurance scene (default 1000)")
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="scans a run_sequence call (default 250)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes rendering the scene (default: every "
                    "core)")
    ap.add_argument("--cache-dir", default=None,
                    help="where the rendered scene is cached (default: "
                    "the temp dir)")
    args = ap.parse_args(argv)
    if args.scans % args.chunk or args.scans < 2 * args.chunk:
        ap.error("--scans must be a multiple of --chunk, at least two "
                 "chunks")

    dev = benchrun.open_device(args.device)
    card = benchrun.card_line(dev)
    say(f"device {benchrun.device_name(dev)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}; "
        f"os.cpu_count() {os.cpu_count()}")
    t0 = time.monotonic()
    sensor, scans, scan_ts, gt_mid, imu = sim.long_scene(
        args.scans, cache_dir=args.cache_dir, workers=args.workers)
    render_s = time.monotonic() - t0
    say(f"scene: {len(scans)} scans of {scans.shape[1]}x{scans.shape[2]} "
        f"in {render_s:.1f} s ({args.workers} processes)")
    build_s = benchrun.build_kernels(dev)
    if build_s is not None:
        say(f"kernels built in {build_s:.1f} s")

    cfg = config.long_config()
    lut = convert.lut_from_numpy(sensor.lut, dev)
    imu_ts = np.arange(1, args.scans * 10 + 2) * 0.01  # bench_long.py:60
    t0 = time.monotonic()
    all_batches = chunk_batches(cfg, scans, scan_ts, imu, imu_ts,
                                args.chunk, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload_s = time.monotonic() - t0
    runs = run_chunks(cfg, lio.init_state(cfg, dev), all_batches, lut, dev)

    kp = np.concatenate([r["out"]["kiss_pose"] for r in runs])
    cov = np.concatenate([r["out"]["ekf_cov_diag"] for r in runs])
    mp = np.concatenate([r["out"]["map_points"] for r in runs])
    ppv = cfg.kiss.max_points_per_voxel
    chunk_times = [r["s"] for r in runs]
    finite = bool(np.isfinite(kp).all() and np.isfinite(cov).all())
    occupancy_frac = float(mp.max() / (cfg.cap.map_capacity * ppv))
    churn_events = int(np.sum(np.diff(mp) < 0))
    # steady throughput: the chunks after the first, which pays the capture
    steady = [args.chunk / t for t in chunk_times[1:]]
    stable = bool(max(steady) / max(min(steady), 1e-9) < 1.25)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_mid[0]), gt_mid)
    _, ate_rmse = (metrics.calc_ate_rmse(kp, gt_mid) if finite
                   else (0.0, np.inf))
    end_err = float(np.linalg.norm(kp[-1, :3, 3] - rel[-1, :3, 3]))
    checks = {
        "finite": finite,
        "occupancy_bounded": occupancy_frac < 0.95,
        "eviction_churn": churn_events > 10,
        "throughput_stable": stable,
        "ate_ok": float(ate_rmse) < 0.25,
        "loop_end_ok": end_err < 1.0,
    }
    first = runs[0]["record"]
    result = {
        "metric": "lio_long_run",
        "scans": len(kp),
        "scans_per_sec_steady": float(np.mean(steady)),
        "chunk_scans_per_sec": [args.chunk / t for t in chunk_times],
        "ate_rmse_m": float(ate_rmse),
        "end_pos_err_m": end_err,
        "map_points_max": int(mp.max()),
        "map_occupancy_frac": occupancy_frac,
        "eviction_churn_events": churn_events,
        "checks": checks,
        "ok": all(checks.values()),
        "device": benchrun.device_name(dev),
        "power_limit": benchrun.power_limit(card),
        "form": first["form"],
        "capture_ms": first.get("capture_ms"),
        "pool_mb": first.get("pool_mb"),
        "chunk_s": chunk_times,
        "chunks_on_kept_runner": [bool(r["record"].get("cached"))
                                  for r in runs],
        "render_s": render_s,
        "render_workers": args.workers,
        "build_s": build_s,
        "upload_s": upload_s,
        "nvidia_smi": card,
    }
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
