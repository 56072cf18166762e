"""Write the JAX reference poses that ``chip_smoke.py`` holds the PyTorch
port to on the card (which has no JAX).

Renders the bench scene with the port's numpy sim (``sim.bench_scene``:
the ``bench.py:make_data`` scene, 50 scans of 128 x 1024), runs the JAX
package's ``lio.run_sequence`` on the CPU with the XLA forms of the kernels
(``predict_batch="unroll"``, ``update_form="xla"``, ``gn_backend="jnp"``),
and writes one row of 12 floats (the 3 x 4 top of each pose, row-major) per
scan, after a header with the configuration and the JAX ATE RMSE.

    JAX_PLATFORMS=cpu python tools/make_torch_reference.py \
        [--config bench|bench_fused|cli|cli_kiss] [PATH]

``--config bench`` (default): ``bench.py:bench_config``, written to
``tests/data/bench_jax_poses.txt``. ``--config bench_fused``: the same with
``fused_gather=True``, run through the fused gather and the fused loop
kernels in interpret mode (``gn_backend="fused"``), written to
``tests/data/bench_fused_jax_poses.txt``. ``--config cli``: the flagship
command's configuration (``ptudes_tpu/cli/main.py:441-452`` with
``--use-imu-prediction``; the port's ``config.cli_config(128, 1024)``),
written to ``tests/data/cli_jax_poses.txt``. ``--config cli_kiss``: the same
command with no guess flag (``guess="kiss"``, ``cli/main.py:428-429``) and
the predict form it picks off the TPU, ``predict_batch="assoc"``
(``:448-449``), written to ``tests/data/cli_kiss_jax_poses.txt``; the
port's ``config.cli_config(128, 1024, guess="kiss")``. It runs the first
``KISS_SCANS`` scans of the 50-scan scene only: from scan 15 on, the JAX
run with the constant-velocity guess leaves the track on this scene (0.17
m off at scan 16, non-finite poses from scan 25; as with ``bench.py``'s
configuration or KISS's own deskew, while the EKF and ground-truth guesses
track).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
KISS_SCANS = 15   # scans of the cli_kiss reference (see above)


def jax_config(which: str):
    """The JAX configuration of ``which`` with the kernels' XLA forms
    (``cli_kiss``: the associative-scan predict the command runs off the
    TPU)."""
    from ptudes_tpu.config import Capacity, KissConfig, PipelineConfig

    if which in ("bench", "bench_fused"):
        import bench
        base = bench.bench_config()
    else:
        h, w = 128, 1024
        base = PipelineConfig(
            kiss=KissConfig(max_range=70.0, min_range=1.0, deskew=True,
                            loss="plane"),
            cap=Capacity(max_points=h * w),
            guess="kiss" if which == "cli_kiss" else "ekf")
    return dataclasses.replace(
        base,
        ekf=dataclasses.replace(
            base.ekf, update_form="xla",
            predict_batch="assoc" if which == "cli_kiss" else "unroll"),
        kiss=dataclasses.replace(
            base.kiss, **(dict(gn_backend="fused", fused_gather=True)
                          if which == "bench_fused" else
                          dict(gn_backend="jnp"))),
        scan_unroll=1)


def main(which: str, path: str) -> None:
    import jax
    import jax.numpy as jnp

    from ptudes_tpu.models import lio
    from ptudes_tpu.ops.projection import XyzLut
    from ptudes_tpu.utils.metrics import calc_ate_rmse
    from ptudes_tpu_torch.models import sim

    sensor, scans, scan_ts, gt_mid, imu = sim.bench_scene()
    cfg = jax_config(which)
    where = {"bench": "bench.py:bench_config",
             "bench_fused": "bench.py:bench_config with fused_gather=True",
             "cli": "ptudes_tpu/cli/main.py:441-452 (ekf-bench ouster "
                    "--use-imu-prediction, 128x1024)",
             "cli_kiss": "ptudes_tpu/cli/main.py:428-452 (ekf-bench ouster "
                         "with no guess flag, 128x1024)"}[which]
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu.ts)
    if which == "cli_kiss":
        batches = jax.tree.map(lambda x: x[:KISS_SCANS], batches)
        gt_mid = gt_mid[:KISS_SCANS]
        where += f", the first {KISS_SCANS} scans"
    lut = XyzLut(jnp.asarray(sensor.lut.direction),
                 jnp.asarray(sensor.lut.offset))
    t0 = time.monotonic()
    _, out = lio.run_sequence(lio.init_state(cfg), batches, lut, cfg=cfg)
    poses = np.asarray(out.kiss_pose, np.float64)
    _, ate = calc_ate_rmse(poses, gt_mid)
    header = "\n".join([
        "JAX reference poses of the bench scene (ptudes_tpu_torch.models."
        "sim.bench_scene: 50 scans, 128x1024, bench.py:make_data)",
        f"ptudes_tpu lio.run_sequence on {jax.devices()[0].platform} at "
        f"{where} with predict_batch={cfg.ekf.predict_batch!r}, "
        f"update_form='xla', gn_backend={cfg.kiss.gn_backend!r}, "
        "scan_unroll=1",
        f"kiss={cfg.kiss}", f"cap={cfg.cap}", f"ekf={cfg.ekf}",
        f"max_imu_per_scan={cfg.max_imu_per_scan} guess={cfg.guess} "
        f"bootstrap_scans={cfg.bootstrap_scans} "
        f"steady_insert_mode={cfg.steady_insert_mode}",
        f"JAX ATE RMSE vs exact mid-sweep poses: {ate:.6f} m",
        "one row per scan: the 3x4 top of kiss_pose, row-major"])
    np.savetxt(path, poses[:, :3, :].reshape(len(poses), 12), fmt="%.9g",
               header=header)
    print(f"wrote {path}: {len(poses)} poses, JAX ATE RMSE {ate:.4f} m, "
          f"{time.monotonic() - t0:.0f} s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config",
                    choices=("bench", "bench_fused", "cli", "cli_kiss"),
                    default="bench")
    ap.add_argument("path", nargs="?", help="output file (default "
                    "tests/data/<config>_jax_poses.txt)")
    args = ap.parse_args()
    main(args.config, args.path or os.path.join(
        ROOT, "tests", "data", f"{args.config}_jax_poses.txt"))
