"""Write the JAX reference poses that ``chip_smoke.py`` holds the PyTorch
port to on the card (which has no JAX).

Renders the bench scene with the port's numpy sim (``sim.bench_scene``:
the ``bench.py:make_data`` scene, 50 scans of 128 x 1024), runs the JAX
package's ``lio.run_sequence`` on the CPU with the XLA forms of the kernels
(``predict_batch="unroll"``, ``update_form="xla"``, ``gn_backend="jnp"``),
and writes one row of 12 floats (the 3 x 4 top of each pose, row-major) per
scan, after a header with the configuration and the JAX ATE RMSE.

    JAX_PLATFORMS=cpu python tools/make_torch_reference.py \
        [--config NAME ...] [--path PATH]

Each ``--config`` NAME is written to ``tests/data/<NAME>_jax_poses.txt``
(``--path`` overrides that for a single NAME):

- ``bench`` (default): ``bench.py:bench_config``.
- ``bench_fused``: the same with ``fused_gather=True``, run through the
  fused gather and the fused loop kernels in interpret mode
  (``gn_backend="fused"``).
- ``cli``: the flagship command's configuration
  (``ptudes_tpu/cli/main.py:441-452`` with ``--use-imu-prediction``; the
  port's ``config.cli_config(128, 1024)``).
- ``cli_kiss``: the same command with no guess flag (``guess="kiss"``,
  ``cli/main.py:428-429``) and the predict form it picks off the TPU,
  ``predict_batch="assoc"`` (``:448-449``); the port's
  ``config.cli_config(128, 1024, guess="kiss")``. It runs the first
  ``KISS_SCANS`` scans of the 50-scan scene only: from scan 15 on, the JAX
  run with the constant-velocity guess leaves the track on this scene (0.17
  m off at scan 16, non-finite poses from scan 25; as with ``bench.py``'s
  configuration or KISS's own deskew, while the EKF and ground-truth guesses
  track).
- ``cli_point``: ``cli`` with ``loss="point"`` (``ekf-bench ouster
  --use-imu-prediction --loss point``).
- ``bench_point``, ``bench_dec2``, ``bench_nn4``: ``bench`` with
  ``loss="point"``, ``col_decimation=2`` and ``nn_neighborhood=4``.
- ``bench_frozen``: ``bench`` maps scans 0-24, ``utils.checkpoint.save_state``
  writes the state with ``time_origin`` and ``end_scan_ts`` (as ``ekf-bench
  ouster --save-state`` does), ``load_state`` restores it into a fresh
  state, and scans 25-49 run with ``map_frozen=True`` on batches built on
  the checkpoint's clock with ``prev_scan_ts`` (``--resume-state
  --frozen-map``, ``cli/main.py:469-481``); all 50 poses are written.
- ``kiss_every``: ``kiss.register_scan`` alone, scan after scan, at
  ``KissConfig()``'s defaults with ``nn_mode="every"`` and ``loss="point"``
  (kiss-icp's own registration: a map query every GN iteration), no range
  image grid (``grid_hw=None``: the scatter-table first-in-voxel front end),
  the constant-velocity guess and deskew, at ``Capacity(max_points=128 *
  1024)``. It runs the first ``KISS_EVERY_SCANS`` scans only: the JAX run
  leaves the track on this scene from scan 13 (0.04 m or less from the
  exact poses up to scan 12, 0.08 m at 13, 0.23 m at 14, 49 m at 20,
  non-finite poses from 24), where the sparse source (about 800 points
  beyond the 5 m minimum range, at 1 m voxels) and the constant-velocity
  guess meet the part of the circle where ``cli_kiss`` leaves it too.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
KISS_SCANS = 15   # scans of the cli_kiss reference (see above)
KISS_EVERY_SCANS = 13  # scans of the kiss_every reference (see above)
FROZEN_SPLIT = 25  # bench_frozen: scans mapped before the checkpoint
CONFIGS = ("bench", "bench_fused", "cli", "cli_kiss", "cli_point",
           "bench_point", "bench_dec2", "bench_nn4", "bench_frozen",
           "kiss_every")
WHERE = {
    "bench": "bench.py:bench_config",
    "bench_fused": "bench.py:bench_config with fused_gather=True",
    "cli": "ptudes_tpu/cli/main.py:441-452 (ekf-bench ouster "
           "--use-imu-prediction, 128x1024)",
    "cli_kiss": "ptudes_tpu/cli/main.py:428-452 (ekf-bench ouster with no "
                "guess flag, 128x1024)",
    "cli_point": "ptudes_tpu/cli/main.py:441-452 (ekf-bench ouster "
                 "--use-imu-prediction --loss point, 128x1024)",
    "bench_point": "bench.py:bench_config with loss='point'",
    "bench_dec2": "bench.py:bench_config with col_decimation=2",
    "bench_nn4": "bench.py:bench_config with nn_neighborhood=4",
    "bench_frozen": f"bench.py:bench_config on scans 0-{FROZEN_SPLIT - 1}, "
                    "save_state / load_state, then map_frozen=True on "
                    f"scans {FROZEN_SPLIT}-49 (ekf-bench ouster "
                    "--save-state, then --resume-state --frozen-map)",
}


def jax_config(which: str):
    """The JAX configuration of ``which`` with the kernels' XLA forms
    (``cli_kiss``: the associative-scan predict the command runs off the
    TPU)."""
    from ptudes_tpu.config import Capacity, KissConfig, PipelineConfig

    if which.startswith("bench"):
        import bench
        base = bench.bench_config()
    else:
        h, w = 128, 1024
        base = PipelineConfig(
            kiss=KissConfig(max_range=70.0, min_range=1.0, deskew=True,
                            loss="plane"),
            cap=Capacity(max_points=h * w),
            guess="kiss" if which == "cli_kiss" else "ekf")
    kiss = (dict(gn_backend="fused", fused_gather=True)
            if which == "bench_fused" else dict(gn_backend="jnp"))
    if which in ("cli_point", "bench_point"):
        kiss["loss"] = "point"
    if which == "bench_nn4":
        kiss["nn_neighborhood"] = 4
    return dataclasses.replace(
        base,
        ekf=dataclasses.replace(
            base.ekf, update_form="xla",
            predict_batch="assoc" if which == "cli_kiss" else "unroll"),
        kiss=dataclasses.replace(base.kiss, **kiss),
        col_decimation=2 if which == "bench_dec2" else 1,
        scan_unroll=1)


def run_lio(which: str, scene, lut):
    """``lio.run_sequence`` at ``which``'s configuration; returns (kiss
    poses [N, 4, 4] f64, the configuration, the scans run)."""
    import jax

    from ptudes_tpu.models import lio
    from ptudes_tpu.utils import checkpoint

    sensor, scans, scan_ts, gt_mid, imu = scene
    cfg = jax_config(which)
    n = KISS_SCANS if which == "cli_kiss" else len(scans)
    if which != "bench_frozen":
        batches = lio.build_batches(cfg, scans[:n], scan_ts[:n], imu.lacc,
                                    imu.avel, imu.ts)
        _, out = lio.run_sequence(lio.init_state(cfg), batches, lut, cfg=cfg)
        return np.asarray(out.kiss_pose, np.float64), cfg, n
    k = FROZEN_SPLIT
    origin = lio.time_origin(scan_ts[:k], imu.ts)
    batches = lio.build_batches(cfg, scans[:k], scan_ts[:k], imu.lacc,
                                imu.avel, imu.ts, time_origin=origin)
    fin, out = lio.run_sequence(lio.init_state(cfg), batches, lut, cfg=cfg)
    frozen = dataclasses.replace(cfg, map_frozen=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_state(path, fin, extra={
            "end_scan_ts": float(scan_ts[k - 1]),
            "time_origin": float(origin)})
        state = checkpoint.load_state(path, lio.init_state(frozen))
        extra = checkpoint.checkpoint_extra(path)
    batches = lio.build_batches(
        frozen, scans[k:], scan_ts[k:], imu.lacc, imu.avel, imu.ts,
        time_origin=extra["time_origin"],
        prev_scan_ts=extra["end_scan_ts"])
    _, out2 = lio.run_sequence(state, batches, lut, cfg=frozen)
    poses = np.concatenate([np.asarray(out.kiss_pose, np.float64),
                            np.asarray(out2.kiss_pose, np.float64)])
    jax.block_until_ready(out2.kiss_pose)
    return poses, frozen, len(scans)


def kiss_every_config():
    """``kiss_every``'s (KissConfig, Capacity) in the JAX package."""
    from ptudes_tpu.config import Capacity, KissConfig

    return (KissConfig(nn_mode="every", loss="point"),
            Capacity(max_points=128 * 1024))


def run_kiss_every(scene, lut):
    """``kiss.register_scan`` scan after scan (see the module docstring);
    returns the poses [N, 4, 4] f64."""
    import jax.numpy as jnp

    from ptudes_tpu.models import kiss
    from ptudes_tpu.ops.projection import scan_to_points

    kcfg, cap = kiss_every_config()
    state = kiss.init_state(kcfg, cap)
    poses = []
    for rng in scene[1][:KISS_EVERY_SCANS]:
        pts, mask, ts01 = scan_to_points(lut, jnp.asarray(rng, jnp.float32))
        state, pose, _ = kiss.register_scan(state, pts, mask, ts01,
                                            cfg=kcfg, cap=cap)
        poses.append(np.asarray(pose, np.float64))
    return np.stack(poses)


def main(which: str, path: str, scene) -> None:
    import jax
    import jax.numpy as jnp

    from ptudes_tpu.ops.projection import XyzLut
    from ptudes_tpu.utils.metrics import align_first_pose, calc_ate_rmse

    sensor, scans, scan_ts, gt_mid, imu = scene
    lut = XyzLut(jnp.asarray(sensor.lut.direction),
                 jnp.asarray(sensor.lut.offset))
    t0 = time.monotonic()
    if which == "kiss_every":
        poses = run_kiss_every(scene, lut)
        kcfg, cap = kiss_every_config()
        setup = [
            "ptudes_tpu kiss.register_scan scan after scan on "
            f"{jax.devices()[0].platform}: KissConfig() defaults with "
            "nn_mode='every', loss='point'; grid_hw=None, the "
            "constant-velocity guess and deskew, update_ok=None, the first "
            f"{KISS_EVERY_SCANS} scans",
            f"kiss={kcfg}", f"cap={cap}"]
    else:
        poses, cfg, n = run_lio(which, scene, lut)
        where = WHERE[which] + (f", the first {KISS_SCANS} scans"
                                if which == "cli_kiss" else "")
        setup = [
            f"ptudes_tpu lio.run_sequence on {jax.devices()[0].platform} at "
            f"{where} with predict_batch={cfg.ekf.predict_batch!r}, "
            f"update_form='xla', gn_backend={cfg.kiss.gn_backend!r}, "
            "scan_unroll=1",
            f"kiss={cfg.kiss}", f"cap={cfg.cap}", f"ekf={cfg.ekf}",
            f"max_imu_per_scan={cfg.max_imu_per_scan} guess={cfg.guess} "
            f"bootstrap_scans={cfg.bootstrap_scans} "
            f"steady_insert_mode={cfg.steady_insert_mode} "
            f"col_decimation={cfg.col_decimation} "
            f"map_frozen={cfg.map_frozen}"]
    gt = gt_mid[:len(poses)]
    _, ate = calc_ate_rmse(poses, gt)
    err = np.linalg.norm(
        poses[:, :3, 3] - align_first_pose(poses, gt)[:, :3, 3], axis=1)
    header = "\n".join([
        "JAX reference poses of the bench scene (ptudes_tpu_torch.models."
        "sim.bench_scene: 50 scans, 128x1024, bench.py:make_data)",
        *setup,
        f"JAX ATE RMSE vs exact mid-sweep poses: {ate:.6f} m",
        "largest |position - exact mid-sweep position| (first poses "
        "aligned) a block of 10 scans: " + " ".join(f"{e:.4f}" for e in
                          [err[i:i + 10].max() for i in
                           range(0, len(err), 10)]),
        "one row per scan: the 3x4 top of kiss_pose, row-major"])
    np.savetxt(path, poses[:, :3, :].reshape(len(poses), 12), fmt="%.9g",
               header=header)
    print(f"wrote {path}: {len(poses)} poses, JAX ATE RMSE {ate:.4f} m, "
          f"{time.monotonic() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=CONFIGS, nargs="+",
                    default=["bench"])
    ap.add_argument("--path", help="output file for a single --config "
                    "(default tests/data/<config>_jax_poses.txt)")
    args = ap.parse_args()
    if args.path and len(args.config) != 1:
        ap.error("--path takes a single --config")
    from ptudes_tpu_torch.models import sim
    scene = sim.bench_scene()
    for name in args.config:
        main(name, args.path or os.path.join(
            ROOT, "tests", "data", f"{name}_jax_poses.txt"), scene)
