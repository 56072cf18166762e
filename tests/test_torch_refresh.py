"""PyTorch port: the flagship command's path against the JAX package.

What ``config.cli_config`` adds to the bench path, each held to JAX:
- the candidate gather at its shapes (27-neighbourhood, two probes, 20
  points per voxel), bit for bit under ``jax.jit``;
- the exact chunked map insert (``overflow=True`` and ``"cond"`` over
  several chunks), tables bit for bit;
- the candidate-refresh ICP loop against ``gn_backend="jnp"`` and
  ``"pallas"`` (interpret mode), at tests/test_pallas_icp.py's bars
  (log-pose < 5e-4, n_corr within max(3, 1 %), iterations within 2);
- a 12-scan 32 x 256 sequence at ``cli_config``'s structure with the
  capacities cut so that steady scans overflow the insert budget: every
  pose within 0.02 m of JAX, also after carrying the JAX state over after
  the bootstrap scan.
"""
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu import config as jconfig
from ptudes_tpu.geom import se3 as jse3
from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops import hashmap as jhashmap
from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops import voxel as jvoxel
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.models import lio
from ptudes_tpu_torch.ops import hashmap, icp
from ptudes_tpu_torch.utils import convert
from test_pallas_icp import _setup
from test_torch_lio import N_SCANS, POSE_BAR_M, render_scene

torch.set_num_threads(2)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_gather_27_neighbourhood_two_probes_20_per_voxel_bit_exact():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-12, 12, (60000, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    frame, keep = jax.jit(jvoxel.first_in_voxel_sorted,
                          static_argnums=(2, 3))(
        pts, np.ones(len(pts), bool), 0.35, len(pts))
    jm = jax.jit(partial(jhashmap.insert_deduped, voxel_size=0.7,
                         max_probes=2, new_capacity=len(pts)))(
        jhashmap.create(1 << 14, 20), frame, keep)
    pm = hashmap.VoxelHashMap(_t(jm.meta), _t(jm.points))
    # one point per voxel octant: the deduped insert fills at most 8 of
    # the 20 columns, the rest stay invalid candidates
    assert int(jm.meta[:, 1].max()) == 8
    q = rng.uniform(-11, 11, (2048, 3)).astype(np.float32)
    q[:, 2] *= 0.1
    kw = dict(voxel_size=0.7, max_probes=2, neighborhood=27, n_voxels=4,
              fit_planes=True)
    cj = jax.jit(partial(jicp.gather_candidates, **kw))(jm, q)
    cp = icp.gather_candidates(pm, torch.from_numpy(q), **kw)
    assert cp.pts.shape == (2048, 80, 3)
    _eq(cp.valid, cj.valid)
    assert int(cp.valid.sum()) > 2048 * 10
    _eq(cp.pts, cj.pts)
    ok = np.asarray(cj.quality) > 0.3
    assert ok.sum() > 500
    dots = np.abs(np.sum(cp.normal.numpy()[ok] * np.asarray(cj.normal)[ok],
                         1))
    assert np.quantile(dots, 0.01) > 0.999
    np.testing.assert_allclose(cp.centroid.numpy(), np.asarray(cj.centroid),
                               atol=2e-3)
    np.testing.assert_allclose(cp.quality.numpy()[ok],
                               np.asarray(cj.quality)[ok], atol=2e-2)


@pytest.mark.parametrize("overflow", [True, "cond"])
def test_chunked_insert_tables_bit_exact(overflow):
    """A whole frame into an empty map and then shifted, turned frames,
    each in chunks of 1024 of 8192 points (8 chunks, most of them full on
    the first insert, fewer later), with the fused eviction."""
    cap, ppv, vs, frame, budget = 1 << 14, 20, 0.3, 8192, 1024
    jins = jax.jit(jhashmap.insert_deduped,
                   static_argnames=("voxel_size", "max_probes",
                                    "new_capacity", "overflow"))
    jm = jhashmap.create(cap, ppv)
    pm = hashmap.create(cap, ppv, "cpu")
    rng = np.random.default_rng(12)
    before = 0
    for step in range(4):
        origin = np.array([2.0 * step, 0.5 * step, 0.0], np.float32)
        raw = rng.uniform(-12, 12, (20000, 3)).astype(np.float32)
        pts, keep = jax.jit(jvoxel.first_in_voxel_sorted,
                            static_argnums=(2, 3))(
            raw, np.ones(len(raw), bool), 0.5 * vs, frame)
        a = 0.3 * step
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], np.float32)
        pts, keep = np.asarray(pts) @ rot.T + origin, np.array(keep)
        kw = dict(voxel_size=vs, max_probes=2, new_capacity=budget,
                  overflow=overflow)
        r2 = np.float32(225.0)
        jm = jins(jm, pts, keep, evict_origin=jnp.asarray(origin),
                  evict_r2=jnp.asarray(r2), **kw)
        pm = hashmap.insert_deduped(
            pm, torch.from_numpy(pts), torch.from_numpy(keep),
            evict_origin=torch.from_numpy(origin),
            evict_r2=torch.tensor(r2), **kw)
        _eq(pm.meta, jm.meta)
        _eq(pm.points, jm.points)
        now = int(hashmap.num_points(pm))
        if step == 0:
            assert now > 3 * budget            # at least 4 chunks ran
        before = now
    assert before > 1000


@pytest.fixture(scope="module")
def icp_scene():
    m, src, mask, guess = _setup()
    return (m, src, mask, guess), (
        hashmap.VoxelHashMap(_t(m.meta), _t(m.points)), _t(src), _t(mask),
        _t(guess))


ICP_KW = dict(voxel_size=0.3, max_probes=2, max_iterations=30,
              convergence=1e-5, plane_min_quality=0.2,
              prior_rot_weight=0.01, prior_trans_weight=0.01,
              neighborhood=27, n_voxels=4, plane_radius=0.6,
              refresh_drift=0.5)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_refresh_loop_matches_jax(icp_scene, backend):
    (m, src, mask, guess), (pm, tsrc, tmask, tguess) = icp_scene
    ref = jicp.register_frame_cached(
        src, mask, m, guess, jnp.float32(0.5), jnp.float32(0.1667),
        loss="plane", gn_backend=backend, **ICP_KW)
    kernels.reset_launches()
    icp.reset_refresh_counts()
    got = icp.register_frame_cached(
        tsrc, tmask, pm, tguess, torch.tensor(0.5), torch.tensor(0.1667),
        form="cuda", **ICP_KW)
    assert kernels.LAUNCHES["gn_iter"] == 0      # CPU tensors: the twin
    counts = dict(icp.REFRESH_COUNTS)
    # the guess is ~0.2 m and 0.45 degrees off: the candidates gathered
    # there go stale (0.15 m of drift) on the way to the solution
    assert counts["regathers"] >= 1
    assert counts["host_reads"] <= int(got.iterations)
    d = np.asarray(jse3.log_pose(jse3.inv(ref.pose)
                                 @ jnp.asarray(got.pose.numpy())))
    assert np.linalg.norm(d) < 5e-4, d
    n0, n1 = int(ref.num_corr), int(got.num_corr)
    assert abs(n0 - n1) <= max(3, int(0.01 * n0)) and n0 > 1000
    assert abs(int(ref.iterations) - int(got.iterations)) <= 2
    # the model deviation, as kiss.py computes it from the JAX result
    dev = np.asarray(jse3.inv(guess) @ ref.pose)
    np.testing.assert_allclose(float(got.dev_t),
                               np.linalg.norm(dev[:3, 3]), atol=1e-4)
    # the twin form on the same tensors is the same computation
    twin = icp.register_frame_cached(
        tsrc, tmask, pm, tguess, torch.tensor(0.5), torch.tensor(0.1667),
        form="torch", **ICP_KW)
    assert torch.equal(twin.pose, got.pose)


def test_refresh_loop_empty_map_returns_guess(icp_scene):
    (_, _, _, _), (_, tsrc, tmask, tguess) = icp_scene
    icp.reset_refresh_counts()
    res = icp.register_frame_cached(
        tsrc, tmask, hashmap.create(1 << 14, 8, "cpu"), tguess,
        torch.tensor(0.5), torch.tensor(0.1667), form="cuda", **ICP_KW)
    np.testing.assert_allclose(res.pose.numpy(), tguess.numpy(), atol=1e-6)
    assert int(res.num_corr) == 0 and int(res.iterations) == 1
    assert icp.REFRESH_COUNTS == {"host_reads": 1, "regathers": 0,
                                  "allreduces": 0}


# ---------------------------------------------------------------- sequence

def _cut(cfg, **kiss):
    """cli_config's structure at 32 x 256: the voxel of a 30 m clip, and
    an insert budget small enough that steady scans need several chunks."""
    return dataclasses.replace(
        cfg, kiss=dataclasses.replace(cfg.kiss, max_range=30.0, **kiss),
        cap=dataclasses.replace(cfg.cap, max_points=32 * 256,
                                max_frame=8192, max_source=2048,
                                map_capacity=1 << 16, dedup_table=1 << 16,
                                max_new_per_scan=256))


def jax_cli_config(**kw):
    base = jconfig.PipelineConfig(
        kiss=jconfig.KissConfig(max_range=70.0, min_range=1.0, deskew=True,
                                loss="plane"),
        cap=jconfig.Capacity(max_points=32 * 256), guess="ekf")
    cfg = _cut(base, gn_backend="jnp")
    return dataclasses.replace(
        cfg, ekf=dataclasses.replace(cfg.ekf, predict_batch="unroll"), **kw)


@pytest.fixture(scope="module")
def run():
    sensor, scans, scan_ts, imu_ts, imu, _ = render_scene()
    jcfg = jax_cli_config()
    jb = jlio.build_batches(jcfg, scans, scan_ts, imu.lacc, imu.avel,
                            imu_ts)
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    _, jout = jlio.run_sequence(jlio.init_state(jcfg), jb, jlut, cfg=jcfg)
    jboot, _ = jlio.run_sequence(jlio.init_state(jcfg),
                                 jax.tree.map(lambda x: x[:1], jb), jlut,
                                 cfg=jcfg)

    cfg = _cut(config.cli_config(32, 256))
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu_ts, device="cpu")
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    kernels.reset_launches()
    icp.reset_refresh_counts()
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches, lut,
                              cfg=cfg)
    return dict(jposes=np.asarray(jout.kiss_pose, np.float64), out=out,
                jout=jout, jboot=jboot, batches=batches, lut=lut, cfg=cfg,
                launches=dict(kernels.LAUNCHES),
                counts=dict(icp.REFRESH_COUNTS))


def _pose_err(a, b):
    return np.linalg.norm(np.asarray(a)[:, :3, 3] - np.asarray(b)[:, :3, 3],
                          axis=1)


def test_cli_sequence_matches_jax(run):
    out, cfg = run["out"], run["cfg"]
    kp = out.kiss_pose.double().numpy()
    assert kp.shape == (N_SCANS, 4, 4) and np.isfinite(kp).all()
    assert bool(out.scan_valid.all())
    err = _pose_err(kp, run["jposes"])
    assert err.max() <= POSE_BAR_M, err
    # steady scans overflow the insert budget: the chunk loop ran
    grown = np.diff(out.aux.map_points.numpy())
    assert grown.max() > cfg.cap.max_new_per_scan, grown
    # the map follows JAX's exact insert (inserted at poses that differ
    # by f32 roundoff, so a cell at a voxel border may land elsewhere)
    np.testing.assert_allclose(out.aux.map_points.numpy(),
                               np.asarray(run["jout"].aux.map_points),
                               rtol=1e-3)
    iters = out.aux.iterations.numpy()
    assert np.abs(iters - np.asarray(run["jout"].aux.iterations)).max() <= 2
    assert run["counts"]["host_reads"] <= int(iters.sum())
    assert sum(run["launches"].values()) == 0


def test_cli_state_carry_over_from_jax(run):
    leaves = [np.asarray(x) for x in jax.tree.leaves(run["jboot"])]
    state = convert.lio_state_from_numpy(leaves, "cpu")
    assert state.kiss.local_map.points.shape == (1 << 16, 20)
    assert int(hashmap.num_points(state.kiss.local_map)) > 1000
    cfg = dataclasses.replace(run["cfg"], bootstrap_scans=0)
    _, out = lio.run_sequence(state, lio.scan_at(run["batches"],
                                                 slice(1, N_SCANS)),
                              run["lut"], cfg=cfg)
    err = _pose_err(out.kiss_pose.double().numpy(), run["jposes"][1:])
    assert err.max() <= POSE_BAR_M, err
