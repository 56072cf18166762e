"""PyTorch port: the repo's two top-level runs, ``bench_torch.py`` (the
port of ``bench.py``) and ``bench_long_torch.py`` (of ``bench_long.py``).

- ``config.long_config()`` against a JAX ``PipelineConfig`` built from
  ``bench_long.py:82-106``'s values, written out here;
- ``sim.long_scene``'s first frames rendered over a process pool, bit for
  bit against a serial render and the JAX package's sim;
- a chunked endurance run at ``long_config``'s structure, cut to 32 x 256
  and 3 chunks of 8 scans on a world and clip that evict: the port's
  chunks against JAX's chunked ``lio.run_sequence`` (poses within 0.02 m,
  each scan's map points), and the kept graph runner's code (``capture=
  False``) over the chunks bit for bit against the eager chunks;
- ``bench_torch.py --device cpu`` on 3 scans against the JAX reference
  poses of the bench scene;
- both scripts import with ``jax`` and ``ptudes_tpu`` blocked.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.config import Capacity, EkfConfig, KissConfig, PipelineConfig
from ptudes_tpu.models import lio as jlio
from ptudes_tpu.models import sim as jsim
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.models import graph, lio, sim
from ptudes_tpu_torch.utils import convert

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
POSE_BAR_M = 0.02
H, W, CHUNK, N_CHUNKS = 32, 256, 8, 3


def jax_long_config() -> PipelineConfig:
    """bench_long.py:82-106's configuration, written out."""
    h, w = 64, 512
    return PipelineConfig(
        kiss=KissConfig(max_range=25.0, min_range=1.0,
                        max_points_per_voxel=8, max_iterations=20,
                        deskew=True, loss="plane", voxel_size=0.3,
                        plane_fit_radius=0.6, nn_mode="cached",
                        nn_voxels=4, nn_neighborhood=7,
                        nn_refresh_drift=0.0),
        cap=Capacity(max_points=h * w, max_frame=16384, max_source=2048,
                     map_capacity=1 << 19, dedup_table=1 << 17,
                     max_new_per_scan=1024, max_probes=1),
        ekf=EkfConfig(predict_batch="pallas", update_form="pallas"),
        max_imu_per_scan=16,
        guess="ekf",
        bootstrap_scans=3,
        steady_insert_mode=False,
        scan_unroll=4,
    )


def test_long_config_matches_bench_long_py():
    """Field by field; only the JAX-only knobs are dropped and the kernel
    forms renamed (the ICP kernels are the port's own form flag)."""
    p, j = config.long_config(), jax_long_config()
    config.check_supported(p)
    forms = {"icp_form": ("cuda", None), "predict_batch": ("cuda", "pallas"),
             "update_form": ("cuda", "pallas")}
    for part in ("kiss", "cap", "ekf"):
        a, b = dataclasses.asdict(getattr(p, part)), \
            dataclasses.asdict(getattr(j, part))
        for k in ("gn_backend", "gn_unroll"):
            b.pop(k, None)
        for k, (pv, jv) in forms.items():
            if k in a:
                assert a.pop(k) == pv
                assert b.pop(k, None) == jv
        assert a == b, part
    a = {k: v for k, v in dataclasses.asdict(p).items()
         if k not in ("kiss", "cap", "ekf")}
    b = {k: v for k, v in dataclasses.asdict(j).items()
         if k not in ("kiss", "cap", "ekf", "scan_unroll")}
    assert a == b


def test_long_scene_pool_render_is_the_serial_and_jax_render(tmp_path):
    """The first 2 frames over a pool of 2 processes: the bytes of the
    serial render and of ``bench_long.py:make_data``'s (the JAX sim's
    world, trajectory and sensor)."""
    _, pooled, scan_ts, gt_mid, imu = sim.long_scene(
        2, cache_dir=str(tmp_path / "pool"), workers=2)
    _, serial, *_ = sim.long_scene(2, cache_dir=str(tmp_path / "serial"),
                                   workers=1)
    _, cached, *_ = sim.long_scene(2, cache_dir=str(tmp_path / "pool"))
    assert pooled.shape == (2, 64, 512) and pooled.dtype == np.float32
    assert pooled.tobytes() == serial.tobytes() == cached.tobytes()

    ts = np.arange(1000 + 1) * 0.1
    sweep = jsim.circle_poses_at(ts, radius=30.0, speed=2.0, ramp=1.0)
    world = jsim.make_sim_world(seed=0, extent=70.0, n_boxes=300,
                                keepout_points=sweep[:, :3, 3])
    sensor = jsim.make_sim_sensor(h=64, w=512, fov_deg=45.0)
    ref = np.stack([jsim.render_range_image(
        world, sweep[i], sensor, max_range=60.0, noise_std=0.01, seed=i,
        end_pose=sweep[i + 1]) for i in range(2)])
    assert pooled.tobytes() == ref.astype(np.float32).tobytes()
    assert (pooled > 0).mean() > 0.5
    np.testing.assert_array_equal(scan_ts, ts[:2] + 0.1)
    np.testing.assert_array_equal(gt_mid, jsim.circle_poses_at(
        ts[:2] + 0.05, radius=30.0, speed=2.0, ramp=1.0))
    jimu = jsim.imu_for_circle(np.arange(1, 2 * 10 + 2) * 0.01, radius=30.0,
                               speed=2.0, ramp=1.0)
    np.testing.assert_array_equal(imu.lacc, np.asarray(jimu.lacc))
    with pytest.raises(ValueError):
        sim.long_scene(1001)


def _cut(cfg):
    """``long_config``'s structure at 32 x 256: a 10 m clip (and eviction
    radius) and a 64-point steady insert budget, so the map churns within
    24 scans."""
    return dataclasses.replace(
        cfg, kiss=dataclasses.replace(cfg.kiss, max_range=10.0),
        cap=dataclasses.replace(cfg.cap, max_points=H * W, max_frame=4096,
                                map_capacity=1 << 16, dedup_table=1 << 14,
                                max_new_per_scan=64))


@pytest.fixture(scope="module")
def chunked():
    """The scene (a 30 m circle at 4 m/s through a 30 m world of 80
    boxes, seeds as the endurance scene's), its chunks for both packages,
    JAX's chunked run and the port's eager chunked run."""
    n = CHUNK * N_CHUNKS
    ts = np.arange(n + 1) * 0.1
    kin = dict(radius=30.0, speed=4.0, ramp=1.0)
    sweep = sim.circle_poses_at(ts, **kin)
    world = sim.make_sim_world(seed=0, extent=30.0, n_boxes=80,
                               keepout_points=sweep[:, :3, 3])
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=45.0)
    scans = sim.render_frames(world, sweep, sensor, n, 60.0)
    scan_ts = ts[:n] + 0.1
    imu_ts = np.arange(1, n * 10 + 2) * 0.01
    imu = sim.imu_for_circle(imu_ts, **kin)

    def chunks(build, cfg, **kw):
        return [build(cfg, scans[lo:lo + CHUNK], scan_ts[lo:lo + CHUNK],
                      imu.lacc, imu.avel, imu_ts,
                      prev_scan_ts=scan_ts[lo - 1] if lo else None, **kw)
                for lo in range(0, n, CHUNK)]

    base = _cut(jax_long_config())
    jcfg = dataclasses.replace(
        base, kiss=dataclasses.replace(base.kiss, gn_backend="jnp"),
        ekf=dataclasses.replace(base.ekf, predict_batch="unroll",
                                update_form="xla"), scan_unroll=1)
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    jstate, jouts = jlio.init_state(jcfg), []
    for jb in chunks(jlio.build_batches, jcfg):
        jstate, jout = jlio.run_sequence(jstate, jb, jlut, cfg=jcfg)
        jouts.append(jout)

    cfg = _cut(config.long_config())
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    batches = chunks(lio.build_batches, cfg, device="cpu")
    kernels.reset_launches()
    state, outs = lio.init_state(cfg, "cpu"), []
    for b in batches:
        state, out = lio.run_sequence(state, b, lut, cfg=cfg)
        outs.append(out)
    assert sum(kernels.LAUNCHES.values()) == 0      # the twins ran
    return dict(
        cfg=cfg, lut=lut, batches=batches, outs=outs, state=state,
        jposes=np.concatenate([np.asarray(o.kiss_pose, np.float64)
                               for o in jouts]),
        jmap=np.concatenate([np.asarray(o.aux.map_points, np.int64)
                             for o in jouts]),
        gt_mid=sim.circle_poses_at(ts[:n] + 0.05, **kin))


def test_chunked_run_matches_jax(chunked):
    kp = np.concatenate([o.kiss_pose.double().numpy()
                         for o in chunked["outs"]])
    mp = np.concatenate([o.aux.map_points.numpy().astype(np.int64)
                         for o in chunked["outs"]])
    assert kp.shape == (CHUNK * N_CHUNKS, 4, 4) and np.isfinite(kp).all()
    err = np.linalg.norm(kp[:, :3, 3] - chunked["jposes"][:, :3, 3], axis=1)
    assert err.max() <= POSE_BAR_M, err
    # the map shrinks after some scans: voxels evicted beyond the clip
    assert int(np.sum(np.diff(mp) < 0)) >= 1, mp
    assert int(np.sum(np.diff(chunked["jmap"]) < 0)) >= 1
    jm = chunked["jmap"]
    parted = np.flatnonzero(mp != jm)
    if parted.size:
        i = int(parted[0])
        assert np.all(np.abs(mp - jm) <= 0.005 * jm + 1), (
            f"map points part from JAX's at scan {i}: {mp[i]} vs {jm[i]}")
    # each chunk re-bootstraps: its first scan inserts the whole frame
    assert all(mp[c * CHUNK] > mp[c * CHUNK - 1] for c in (1, 2))
    gt = chunked["gt_mid"]
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(kp[-1, :3, 3] - rel[-1, :3, 3]) < 0.5


def test_kept_runner_over_chunks_is_the_eager_run(chunked):
    """``lio.graph_run(..., capture=False)`` (the graph runner's buffers,
    counter and copies, no capture) over the 3 chunks with the state
    carried: the first chunk builds the runner, the later two load it; the
    same bits as the eager chunks."""
    cfg, lut = chunked["cfg"], chunked["lut"]
    state = lio.init_state(cfg, "cpu")
    for c, (b, ref) in enumerate(zip(chunked["batches"], chunked["outs"])):
        state, out = lio.graph_run(state, b, lut, cfg=cfg, capture=False)
        assert graph.LAST_RUN["form"] == "static"
        assert graph.LAST_RUN["cached"] == (c > 0)
        assert graph.LAST_RUN["replays"] == {"boot": 3, "steady": CHUNK - 3}
        for x, y in zip(graph.leaves(out), graph.leaves(ref)):
            assert torch.equal(x, y)
    for x, y in zip(graph.leaves(state), graph.leaves(chunked["state"])):
        assert torch.equal(x, y)


BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline", "quality",
    "replica_aggregate_scans_per_sec", "replica_note", "compile_s", "device"}
QUALITY_KEYS = {"ate_rmse_m", "vs_oracle_ate", "gate_rel", "gate_rel_pass",
                "gate_abs", "gate_abs_pass", "gate_pass"}


def test_bench_torch_cpu_rehearsal(tmp_path):
    """``bench_torch.py --device cpu --scans 3 --replicas 2``: one JSON
    line with bench.py's keys; the 3 poses within 0.02 m of the JAX
    reference's first rows (the run is causal); exit code 0 only when
    every gate passes."""
    poses = tmp_path / "poses.txt"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--device",
         "cpu", "--scans", "3", "--replicas", "2", "--runs", "1",
         "--workers", "1", "--cache-dir", str(tmp_path),
         "--poses-out", str(poses)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode in (0, 1), r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert BENCH_KEYS <= set(res) and QUALITY_KEYS <= set(res["quality"])
    assert {"cpu_scans_per_sec", "cpu_ate_rmse_m"} <= set(res["baseline"])
    assert set(res["replica_aggregate_scans_per_sec"]) == {"x2"}
    assert res["device"] == "cpu" and res["form"] == "eager"
    assert res["kernels"] == [] and res["power_limit"] is None
    assert r.returncode == (0 if res["quality"]["gate_pass"] else 1)
    got = np.loadtxt(poses).reshape(-1, 3, 4)
    ref = np.loadtxt(os.path.join(HERE, "data", "bench_jax_poses.txt")
                     ).reshape(-1, 3, 4)[:3]
    assert got.shape == (3, 3, 4)
    err = np.linalg.norm(got[:, :, 3] - ref[:, :, 3], axis=1)
    assert err.max() <= POSE_BAR_M, err
    assert res["quality"]["gate_pose_pass"]
    assert res["quality"]["max_pose_err_m"] == pytest.approx(err.max())


def test_scripts_import_without_jax():
    """Both scripts and the oracle they feed import with ``jax`` and
    ``ptudes_tpu`` blocked, as on the card's machine."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ptudes_tpu'] = None\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tools')!r}]\n"
        "for name in ('bench_torch', 'bench_long_torch'):\n"
        f"    spec = importlib.util.spec_from_file_location(name, "
        f"{ROOT!r} + '/' + name + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main)\n"
        "import oracle_kiss\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'ptudes_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
