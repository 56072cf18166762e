"""The independent float64 filter (``reference/filter.py``) against the
plain reference's float32 EKF, on the circle's exact IMU samples with the
true poses as the measurements: the same filter, up to float32 rounding,
and a filter that skips its pose updates is far from it."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.harness import spec
from benchmark.reference import filter as ref_filter
from benchmark.reference import step
from benchmark.reference.plainlio.models import esekf, lio


def _inputs(n_scans: int = 40):
    kin = dict(radius=8.0, speed=2.0, ramp=1.0)
    imu_ts = np.arange(1, n_scans * 10 + 2) * 0.01
    lacc, avel = scene.imu_for_circle(imu_ts, **kin)
    scan_ts = (np.arange(n_scans) + 1) * 0.1
    poses = scene.circle_poses_at(scan_ts - 0.05, **kin)
    return scan_ts, lacc, avel, imu_ts, poses


@pytest.mark.parametrize("config", ["ouster128_cli", "ouster128_bench"])
def test_filter_follows_the_plain_ekf(config):
    d = spec.load_json(f"{spec.HERE}/configs/{config}.json")["pipeline"]
    cfg = step.pipeline_config(d)
    scan_ts, lacc, avel, imu_ts, poses = _inputs()
    batches = lio.build_batches(cfg, np.zeros((len(scan_ts), 2, 2)),
                                scan_ts, lacc, avel, imu_ts, time_origin=0.0,
                                device="cpu")
    s = esekf.init_state(cfg.ekf, "cpu")
    pos, vel, cov = [], [], []
    with torch.no_grad():
        for i in range(len(scan_ts)):
            b = lio.scan_at(batches, i)
            s, _ = esekf.process_imu_batch(s, b.imu, b.imu_valid, cfg=cfg.ekf)
            s = esekf.process_pose(
                s, torch.as_tensor(poses[i], dtype=torch.float32),
                cfg=cfg.ekf)
            pos.append(s.pos.double().numpy())
            vel.append(s.vel.double().numpy())
            cov.append(torch.diagonal(s.cov).double().numpy())
    want = ref_filter.follow(d["ekf"], d["max_imu_per_scan"], scan_ts, lacc,
                             avel, imu_ts, 0.0, poses)
    assert np.abs(np.array(pos) - want["pos"]).max() < 1e-5
    assert np.abs(np.array(vel) - want["vel"]).max() < 1e-4
    assert (np.abs(np.array(cov) - want["cov_diag"])
            / want["cov_diag"]).max() < 1e-3
    # the true poses hold the filter on the circle
    assert np.abs(want["pos"] - poses[:, :3, 3]).max() < 0.05
    # without its pose updates the filter is not the same filter
    drift = dataclasses.replace(cfg.ekf, meas_pos_std=1e3, meas_att_std=1e3)
    s = esekf.init_state(drift, "cpu")
    with torch.no_grad():
        for i in range(len(scan_ts)):
            b = lio.scan_at(batches, i)
            s, _ = esekf.process_imu_batch(s, b.imu, b.imu_valid, cfg=drift)
            s = esekf.process_pose(
                s, torch.as_tensor(poses[i], dtype=torch.float32), cfg=drift)
    assert (np.abs(torch.diagonal(s.cov).double().numpy()
                   - want["cov_diag"][-1]) / want["cov_diag"][-1]).max() > 1.0


def test_scan_windows_take_the_last_samples_of_a_full_window():
    imu_ts = np.arange(1, 41) * 0.01
    win = ref_filter.scan_windows(np.array([0.1, 0.4]), imu_ts, 16)
    assert list(win[0]) == list(range(10))
    assert list(win[1]) == list(range(24, 40))
