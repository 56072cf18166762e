"""PyTorch port: the streaming ``models.online.LioOnline`` against
the JAX package's, and against the port's own batch run.

tests/test_torch_lio.py's 12-scan 32 x 256 scene at its configuration
(``bench_config``'s structure cut to the scan size), replayed with
epoch-scale timestamps and the IMU samples pushed between the scans as a
live sensor delivers them. Against JAX's ``LioOnline`` (the XLA forms of
the kernels; the port's twins on the CPU), every pose within 0.02 m:

- scans 0-5 from a fresh state, the clock's origin fixed by the first
  pushed sample, with scan 4's window over-full (three extra samples past
  ``max_imu_per_scan``, ``n_dropped_imu`` equal);
- scans 6-11 resumed from that state with ``time_origin`` and
  ``prev_scan_ts`` (every IMU sample pushed again: those at or before the
  seam must be ignored), localising on the frozen map.

The port's ``LioOnline`` also equals its ``lio.run_sequence`` bit for bit where
the JAX ``LioOnline``'s step rule gives the same steps: the whole sequence, the
frozen map, and a resume (its first scans boot again, as
``run_sequence`` from a state does).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.models import lio as jlio
from ptudes_tpu.models.online import LioOnline as JLioOnline
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch.models import lio, sim
from ptudes_tpu_torch.models.online import LioOnline
from ptudes_tpu_torch.utils import convert

from test_torch_lio import N_SCANS, POSE_BAR_M, jax_config, port_config, \
    render_scene

torch.set_num_threads(2)

EPOCH = 1.7e9
SPLIT = 6            # scans before the resume
FULL_SCAN = 4        # the scan whose IMU window is over-full
EXTRA = 3            # samples past max_imu_per_scan in that window


@pytest.fixture(scope="module")
def scene():
    sensor, scans, scan_ts, imu_ts, imu, gt_mid = render_scene()
    lacc, avel = np.asarray(imu.lacc), np.asarray(imu.avel)
    # scan 4's window holds 10 samples; add EXTRA + 2 more at odd times so
    # that it holds max_imu_per_scan (12) + EXTRA
    k = port_config().max_imu_per_scan
    n_add = k + EXTRA - 10
    t_add = scan_ts[FULL_SCAN - 1] + 0.0025 + np.arange(n_add) * 0.01
    add = sim.imu_for_circle(t_add, radius=8.0, speed=2.0, ramp=1.0)
    order = np.argsort(np.concatenate([imu_ts, t_add]), kind="stable")
    imu_full = (np.concatenate([imu_ts, t_add])[order],
                np.concatenate([lacc, add.lacc])[order],
                np.concatenate([avel, add.avel])[order])
    return dict(sensor=sensor, scans=scans, scan_ts=scan_ts,
                imu=(imu_ts, lacc, avel), imu_full=imu_full,
                jlut=JXyzLut(jnp.asarray(sensor.lut.direction),
                             jnp.asarray(sensor.lut.offset)),
                lut=convert.lut_from_numpy(sensor.lut, "cpu"))


def replay(odo, scans, scan_ts, imu, idx):
    """Push the IMU samples and the scans ``idx`` in time order (a sample
    before the scan it shares a timestamp with) at epoch scale; returns
    the per-scan outputs."""
    imu_ts, lacc, avel = imu
    events = sorted([(t, 0, j) for j, t in enumerate(imu_ts)]
                    + [(scan_ts[i], 1, i) for i in idx])
    outs = []
    for t, kind, j in events:
        if kind == 0:
            odo.push_imu(lacc[j], avel[j], EPOCH + t)
        else:
            outs.append(odo.push_scan(scans[j], EPOCH + t))
    return outs


def poses(outs, key="kiss_pose"):
    """[N, 4, 4] f64 of either package's per-scan outputs."""
    def f64(x):
        return x.double().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float64)
    return np.stack([f64(getattr(o, key)) for o in outs])


def assert_close(outs, jouts):
    for key in ("kiss_pose", "ekf_pose"):
        p, j = poses(outs, key), poses(jouts, key)
        assert p.shape == j.shape and np.isfinite(p).all()
        err = np.linalg.norm(p[:, :3, 3] - j[:, :3, 3], axis=1)
        assert err.max() <= POSE_BAR_M, (key, err)


def test_online_matches_jax(scene):
    """Fresh start, self-rebased epoch clock, an over-full IMU window;
    then a resume onto the frozen map with ``time_origin`` and
    ``prev_scan_ts``."""
    s = scene
    jcfg, cfg = jax_config(), port_config()
    head = range(SPLIT)
    jodo = JLioOnline(jcfg, s["jlut"])
    odo = LioOnline(cfg, s["lut"])
    jouts = replay(jodo, s["scans"], s["scan_ts"], s["imu_full"], head)
    outs = replay(odo, s["scans"], s["scan_ts"], s["imu_full"], head)
    assert odo.n_dropped_imu == jodo.n_dropped_imu == EXTRA
    assert odo.time_origin == jodo.time_origin == EPOCH + s["imu"][0][0]
    assert_close(outs, jouts)
    assert odo.state.kiss.pose.device.type == "cpu"

    # resume onto the frozen map: every IMU sample pushed again, those at
    # or before the seam ignored
    frozen_j = dataclasses.replace(jcfg, map_frozen=True)
    frozen = dataclasses.replace(cfg, map_frozen=True)
    seam = dict(time_origin=odo.time_origin,
                prev_scan_ts=EPOCH + s["scan_ts"][SPLIT - 1])
    jodo2 = JLioOnline(frozen_j, s["jlut"], state=jodo.state, **seam)
    odo2 = LioOnline(frozen, s["lut"], state=odo.state, **seam)
    tail = range(SPLIT, N_SCANS)
    jouts2 = replay(jodo2, s["scans"], s["scan_ts"], s["imu"], tail)
    outs2 = replay(odo2, s["scans"], s["scan_ts"], s["imu"], tail)
    assert odo2.n_dropped_imu == jodo2.n_dropped_imu == 0
    assert_close(outs2, jouts2)
    for a, b in zip(odo2.state.kiss.local_map, odo.state.kiss.local_map):
        assert torch.equal(a, b)          # the frozen map is untouched
    jax.block_until_ready(jodo2.state)


def _batch_run(s, cfg, idx, state=None, **kw):
    imu_ts, lacc, avel = s["imu"]
    batches = lio.build_batches(cfg, s["scans"][idx],
                                EPOCH + s["scan_ts"][idx], lacc, avel,
                                EPOCH + imu_ts, device="cpu", **kw)
    state = lio.init_state(cfg, "cpu") if state is None else state
    return lio.run_sequence(state, batches, s["lut"], cfg=cfg)


def _same(outs, out):
    for key in ("kiss_pose", "ekf_pose", "ekf_cov_diag", "ekf_vel"):
        assert torch.equal(torch.stack([getattr(o, key) for o in outs]),
                           getattr(out, key)), key


@pytest.mark.parametrize("frozen", [False, True])
def test_online_equals_run_sequence(scene, frozen):
    """Bit for bit against the port's batch run on its clock origin: all
    12 scans from a fresh state (and the final state), then scans 6-11
    resumed after scan 5 with ``prev_scan_ts`` against ``run_sequence``
    from the same state, mapping or (``frozen``) on the frozen map."""
    s = scene
    cfg = port_config()
    origin = EPOCH + lio.time_origin(s["scan_ts"], s["imu"][0])
    idx = np.arange(N_SCANS)
    if not frozen:
        fin, out = _batch_run(s, cfg, idx)
        odo = LioOnline(cfg, s["lut"], time_origin=origin)
        _same(replay(odo, s["scans"], s["scan_ts"], s["imu"], idx), out)
        for a, b in zip(convert.lio_state_leaves(odo.state),
                        convert.lio_state_leaves(fin)):
            assert torch.equal(a, b)
    head, tail = idx[:SPLIT], idx[SPLIT:]
    mid, _ = _batch_run(s, cfg, head, time_origin=origin)
    c2 = dataclasses.replace(cfg, map_frozen=frozen)
    seam = EPOCH + s["scan_ts"][SPLIT - 1]
    _, out = _batch_run(s, c2, tail, state=mid, time_origin=origin,
                        prev_scan_ts=seam)
    odo = LioOnline(c2, s["lut"], state=mid, time_origin=origin,
                    prev_scan_ts=seam)
    _same(replay(odo, s["scans"], s["scan_ts"], s["imu"], tail), out)


def test_prev_scan_ts_needs_time_origin(scene):
    with pytest.raises(ValueError, match="time_origin"):
        LioOnline(port_config(), scene["lut"], prev_scan_ts=EPOCH)
