"""PyTorch port: the replica-fused batched driver (``parallel.batched``)
against the JAX package.

- The flat B-map table: ``create_batched``, ``insert_deduped_batched`` in
  the three overflow modes and ``remove_far_batched`` on
  tests/test_batched.py's seeded frames (B = 3, C = 2^12), tables bit for
  bit against JAX's (integer stages, as every map table in the port).
- ``icp.gather_candidates`` with a slot base into that table against
  JAX's: integer rows bit for bit, floats exactly (the same f32 ops on the
  same values).
- Each replica-axis stage against per-replica calls of the same stage: the
  front end (projection, deskew, range clip, window pre-dedup, compaction,
  the sorted first-in-voxel passes), ``process_pose``, the K1-K4 twins.
- ``run_sequence_batched`` with the twins on tests/test_batched.py's two
  different bags (32 x 256, 8 scans): within 0.02 m of JAX's
  ``run_sequence`` per bag (the sequence bar), within 1e-4 m of the port's
  own ``run_sequence`` per bag with ``map_points`` equal at every scan
  (JAX's own bars between its batched and single runs,
  tests/test_batched.py:156-162); ``log=True`` shapes and knots; the
  candidate-refresh loop, the ``"assoc"`` predict, the constant-velocity
  guess and KISS's deskew against the single runs at the same bars; the
  ``ValueError`` of the two configurations the driver, like JAX's, does
  not run.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops import hashmap as jhashmap
from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.config import EkfConfig
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.models import esekf, lio
from ptudes_tpu_torch.ops import cuda_ekf, deskew, hashmap, icp, voxel
from ptudes_tpu_torch.ops.projection import scan_to_points
from ptudes_tpu_torch.parallel import batched, replay
from ptudes_tpu_torch.utils import convert, replicas

torch.set_num_threads(2)

R = dataclasses.replace
N_SCANS = 8
CAP = 1 << 12
PPV = 8
POSE_BAR_M = 0.02     # a sequence against JAX's
SELF_BAR_M = 1e-4     # batched against the port's single runs


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _rand_frames(seed, b, n):
    """tests/test_batched.py's frames: uniform points, each replica's row
    unique at 0.15 m (half the 0.3 m voxel), 90 % of them masked in."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, size=(b, n, 3)).astype(np.float32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        cells = np.floor(pts[i] / 0.15).astype(np.int64)
        _, first = np.unique(
            cells[:, 0] * 73856093 + cells[:, 1] * 19349663
            + cells[:, 2] * 83492791, return_index=True)
        mask[i, first] = True
    mask &= rng.random((b, n)) < 0.9
    return pts, mask


def _insert_both(pts, mask, b, **kw):
    j = jhashmap.insert_deduped_batched(
        jhashmap.create_batched(b, CAP, PPV), jnp.asarray(pts),
        jnp.asarray(mask), logical_capacity=CAP, **kw)
    t = hashmap.insert_deduped_batched(
        hashmap.create_batched(b, CAP, PPV, "cpu"), torch.from_numpy(pts),
        torch.from_numpy(mask), logical_capacity=CAP, **kw)
    return j, t


@pytest.mark.parametrize("overflow", [True, "cond", False])
def test_insert_batched_matches_jax(overflow):
    """Bit for bit: meta and points of the flat table after a first and a
    second insert (the second meets existing voxels and free octants), and
    each replica's view against the port's own single insert (budget and
    decimation per replica: chunk 1024 of 2048 points, so the exact modes
    run an overflow chunk and False decimates)."""
    b, n = 3, 2048
    pts, mask = _rand_frames(0, b, n)
    kw = dict(voxel_size=0.3, max_probes=2, new_capacity=1024,
              overflow=overflow)
    j, t = _insert_both(pts, mask, b, **kw)
    _eq(t.meta, j.meta)
    _eq(t.points, j.points)
    pts2, mask2 = _rand_frames(7, b, n)
    j2 = jhashmap.insert_deduped_batched(
        j, jnp.asarray(pts2), jnp.asarray(mask2), logical_capacity=CAP,
        **kw)
    t2 = hashmap.insert_deduped_batched(
        t, torch.from_numpy(pts2), torch.from_numpy(mask2),
        logical_capacity=CAP, **kw)
    _eq(t2.meta, j2.meta)
    _eq(t2.points, j2.points)
    if overflow is not False:
        for i in range(b):
            single = hashmap.insert_deduped(
                hashmap.create(CAP, PPV, "cpu"), torch.from_numpy(pts[i]),
                torch.from_numpy(mask[i]), **kw)
            _eq(t.meta[i * CAP:(i + 1) * CAP], single.meta)
    _eq(hashmap.replica_points(t2, b),
        torch.stack([t2.meta[i * CAP:(i + 1) * CAP, 1].sum()
                     for i in range(b)]))


def test_remove_far_batched_matches_jax():
    """Bit for bit against JAX's and against ``remove_far`` per replica."""
    b, n = 3, 2048
    pts, mask = _rand_frames(1, b, n)
    j, t = _insert_both(pts, mask, b, voxel_size=0.3, max_probes=2,
                        new_capacity=4096, overflow=True)
    origins = np.asarray([[0, 0, 0], [3, -2, 1], [-1, 4, 0]], np.float32)
    r2 = np.asarray([9.0, 4.0, 16.0], np.float32)
    jr = jhashmap.remove_far_batched(j, jnp.asarray(origins),
                                     jnp.asarray(r2), logical_capacity=CAP)
    tr = hashmap.remove_far_batched(t, torch.from_numpy(origins),
                                    torch.from_numpy(r2),
                                    logical_capacity=CAP)
    _eq(tr.meta, jr.meta)
    _eq(tr.points, jr.points)
    for i in range(b):
        view = hashmap.VoxelHashMap(t.meta[i * CAP:(i + 1) * CAP],
                                    t.points[i * CAP:(i + 1) * CAP])
        want = hashmap.remove_far(view, torch.from_numpy(origins[i]),
                                  torch.tensor(r2[i]))
        _eq(tr.meta[i * CAP:(i + 1) * CAP], want.meta)


def _dedup(pts, keep):
    """``keep`` and the first point of each 0.15 m cell, per replica."""
    for i in range(pts.shape[0]):
        cells = np.floor(pts[i] / 0.15).astype(np.int64)
        _, first = np.unique(
            cells[:, 0] * 73856093 + cells[:, 1] * 19349663
            + cells[:, 2] * 83492791, return_index=True)
        m = np.zeros(pts.shape[1], bool)
        m[first] = True
        keep[i] &= m
    return keep


def _flat_map(b, seed=2, n=6000):
    """A flat table of B replicas built by both packages, each replica's
    points on three tilted planes (a different offset each) over 6 x 6 m,
    unique at 0.15 m, so the patch fits find planes; also the points."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, 3, (b, n, 2))
    off = rng.choice([-1.0, 0.5, 2.0], (b, n)) + np.arange(b)[:, None] * 0.1
    z = 0.2 * xy[..., 0] - 0.1 * xy[..., 1] + off \
        + rng.normal(0, 0.005, (b, n))
    pts = np.concatenate([xy, z[..., None]], -1).astype(np.float32)
    mask = _dedup(pts, np.ones((b, n), bool))
    return _insert_both(pts, mask, b, voxel_size=0.3, max_probes=2,
                        new_capacity=4096, overflow=True), pts


@pytest.mark.parametrize("neighborhood", [7, 27, 4])
def test_gather_with_slot_base_matches_jax(neighborhood):
    """Each replica's candidates from the flat table against JAX's
    ``gather_candidates(slot_base=, logical_capacity=)``: validity (the
    probed slots and counts) bit for bit and the decoded points exactly
    (the same f32 ops on the same integers), as the batched driver gathers
    them (no fit); with the patch fit (the refresh path's) its normals,
    centroids and quality at tests/test_torch_icp.py's bars (a different
    eigen solve). A per-point slot base (the batched driver's one gather of
    all replicas) gives each replica's rows."""
    b = 3
    (jm, tm), pts = _flat_map(b)
    rng = np.random.default_rng(3)
    q = (pts[:, :256] + rng.normal(0, 0.02, (b, 256, 3))).astype(np.float32)
    kw = dict(voxel_size=0.3, max_probes=2, neighborhood=neighborhood,
              n_voxels=4, plane_radius=0.6)
    per = []
    for i in range(b):
        for fit in (False, True):
            j = jicp.gather_candidates(
                jm, jnp.asarray(q[i]), slot_base=jnp.int32(i * CAP),
                logical_capacity=CAP, fit_planes=fit, **kw)
            t = icp.gather_candidates(
                tm, torch.from_numpy(q[i]),
                slot_base=torch.tensor(i * CAP, dtype=torch.int32),
                logical_capacity=CAP, fit_planes=fit, **kw)
            _eq(t.valid, j.valid)
            assert int(t.valid.sum()) > 256 * 6
            _eq(t.pts, j.pts)
        ok = np.asarray(j.quality) > 0.3
        assert ok.sum() > 100
        dots = np.abs(np.sum(t.normal.numpy()[ok]
                             * np.asarray(j.normal)[ok], 1))
        assert np.quantile(dots, 0.01) > 0.999
        np.testing.assert_allclose(t.centroid.numpy()[ok],
                                   np.asarray(j.centroid)[ok], atol=2e-3)
        np.testing.assert_allclose(t.quality.numpy()[ok],
                                   np.asarray(j.quality)[ok], atol=2e-2)
        per.append(t)
    allq = icp.gather_candidates(
        tm, torch.from_numpy(q.reshape(-1, 3)),
        slot_base=torch.arange(b, dtype=torch.int32).repeat_interleave(256)
        * CAP, logical_capacity=CAP, **kw)
    for name in ("pts", "valid", "normal", "quality"):
        _eq(getattr(allq, name).reshape((b, 256) + getattr(
            per[0], name).shape[1:]), torch.stack([getattr(p, name)
                                                   for p in per]))


def test_registration_replica_axis_matches_per_replica():
    """The batched frozen registration (one gather, K3's and K4's twins
    with the replica axis) equals ``register_frame_cached`` with each
    replica's slot base, bit for bit, and ``fused_gather`` with a slot base
    takes the gather and K3 (K6 would probe the whole table)."""
    b = 3
    (_, tm), pts = _flat_map(b)
    rng = np.random.default_rng(4)
    src = torch.from_numpy(
        (pts[:, :512] + rng.normal(0, 0.03, (b, 512, 3))).astype(np.float32))
    smask = torch.ones((b, 512), dtype=torch.bool)
    smask[1, 400:] = False
    guess = torch.eye(4).repeat(b, 1, 1)
    guess[:, 0, 3] = torch.tensor([0.02, -0.03, 0.01])
    max_d = torch.tensor([1.0, 0.8, 1.2])
    kern = torch.tensor([0.3, 0.25, 0.35])
    kw = dict(voxel_size=0.3, max_probes=2, max_iterations=10,
              convergence=1e-4, loss="plane", plane_min_quality=0.2,
              prior_rot_weight=0.01, prior_trans_weight=0.01,
              neighborhood=7, n_voxels=4, plane_radius=0.6)
    kernels.reset_launches()
    res = icp.register_frames_cached_batched(
        src, smask, tm, guess, max_d, kern, form="torch",
        slot_base=torch.arange(b, dtype=torch.int32) * CAP,
        logical_capacity=CAP, **kw)
    for i in range(b):
        one = icp.register_frame_cached(
            src[i], smask[i], tm, guess[i], max_d[i], kern[i],
            fused_gather=True, form="cuda",
            slot_base=torch.tensor(i * CAP, dtype=torch.int32),
            logical_capacity=CAP, **kw)
        for x, y in zip(res, one):
            _eq(x[i], y)
        assert int(one.num_corr) > 100
    assert sum(kernels.LAUNCHES.values()) == 0


def _ekf_states(b, seed):
    """B distinct filter states from seeded numpy draws."""
    rng = np.random.default_rng(seed)
    cfg = EkfConfig()
    sts = []
    for _ in range(b):
        st = esekf.init_state(cfg, "cpu",
                              init_bacc=rng.normal(0, 0.1, 3),
                              init_bgyr=rng.normal(0, 0.01, 3))
        a = rng.normal(0, 0.02, (18, 18)).astype(np.float32)
        st = st._replace(
            pos=torch.from_numpy(rng.normal(0, 1, 3).astype(np.float32)),
            vel=torch.from_numpy(rng.normal(0, 1, 3).astype(np.float32)),
            cov=st.cov + torch.from_numpy(a @ a.T),
            imu_ts=torch.tensor(0.1, dtype=torch.float32),
            initialized=torch.tensor(True))
        sts.append(st)
    return sts


def test_ekf_replica_axis_matches_per_replica():
    """K1's and K2's wrappers on CPU tensors with a replica axis (their
    twins, with and without the twist and the history, a replica with no
    valid sample) and ``masked_update`` per replica equal the single calls
    bit for bit."""
    b, k = 3, 12
    sts = _ekf_states(b, 5)
    st = replicas.stack(sts)
    rng = np.random.default_rng(6)
    imu = esekf.Imu(
        torch.from_numpy((rng.normal(0, 1, (b, k, 3)) + [0, 0, 9.8])
                         .astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.2, (b, k, 3)).astype(np.float32)),
        torch.from_numpy((0.1 + np.arange(1, k + 1) * 0.01)[None].repeat(
            b, 0).astype(np.float32)))
    valid = torch.ones((b, k), dtype=torch.bool)
    valid[1] = False
    valid[2, 9:] = False
    cfg = config.bench_config().ekf
    for want_twist, log in ((False, False), (True, False), (True, True)):
        got = cuda_ekf.predict_block(st, imu, valid, cfg=cfg,
                                     want_twist=want_twist, log=log)
        for i in range(b):
            one = cuda_ekf.predict_block(
                sts[i], replicas.take(imu, i), valid[i], cfg=cfg,
                want_twist=want_twist, log=log)
            for x, y in zip(replicas.take(got, i), one):
                for u, v in zip(x if isinstance(x, tuple) else (x,),
                                y if isinstance(y, tuple) else (y,)):
                    _eq(u, v)
    meas = se3.exp_twist(torch.from_numpy(
        rng.normal(0, 0.05, (b, 6)).astype(np.float32)))
    mc = esekf.default_meas_cov(cfg, "cpu")
    upd = cuda_ekf.update_pose(st, meas, mc)
    apply = torch.tensor([True, False, True])
    sel = esekf.masked_update(st, upd, apply)
    for i in range(b):
        one = cuda_ekf.update_pose(sts[i], meas[i], mc)
        for x, y in zip(replicas.take(upd, i), one):
            _eq(x, y)
        want = one if bool(apply[i]) else sts[i]
        for x, y in zip(replicas.take(sel, i), want):
            _eq(x, y)


def _render_bags():
    """tests/test_batched.py's two different bags (seeds 0 and 5, circles
    of 8 and 6 m) at 32 x 256, rendered with the port's numpy sim."""
    from ptudes_tpu_torch.models import sim
    sensor = sim.make_sim_sensor(h=32, w=256, fov_deg=45.0)
    ts, _ = sim.circle_trajectory(N_SCANS, radius=8.0, speed=2.0,
                                  scan_dt=0.1)
    imu_ts = np.arange(1, N_SCANS * 10 + 1) * 0.01
    bags = []
    for seed, radius in ((0, 8.0), (5, 6.0)):
        poses = sim.circle_poses_at(
            np.concatenate([ts, [ts[-1] + 0.1]]), radius=radius, speed=2.0)
        world = sim.make_sim_world(seed=seed, extent=25.0, n_boxes=40,
                                   keepout_points=poses[:, :3, 3])
        scans = np.stack([
            sim.render_range_image(world, poses[i], sensor, max_range=60.0,
                                   noise_std=0.01, seed=seed * 100 + i)
            for i in range(N_SCANS)])
        imu = sim.imu_for_circle(imu_ts, radius=radius, speed=2.0)
        bags.append((scans, ts + 1e-9, np.asarray(imu.lacc),
                     np.asarray(imu.avel), imu_ts))
    return sensor, bags


def _cut(cfg, **kiss):
    """bench_config at the 32 x 256 scene's size (tests/test_torch_lio.py's
    cut): 30 m range, 8192-point frame, 2^14-slot maps."""
    return R(cfg, kiss=R(cfg.kiss, max_range=30.0, **kiss),
             cap=R(cfg.cap, max_points=32 * 256, max_frame=8192,
                   map_capacity=1 << 14))


def port_config(**kw):
    return R(config.twin_config(_cut(config.bench_config())), **kw)


@pytest.fixture(scope="module")
def bags_run():
    """The port's batched run, its single runs per bag, and JAX's
    ``run_sequence`` per bag at the same configuration."""
    import bench
    sensor, raw = _render_bags()
    cfg = port_config()
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    batches = [lio.build_batches(cfg, *r, device="cpu") for r in raw]
    singles = [lio.run_sequence(lio.init_state(cfg, "cpu"), bt, lut,
                                cfg=cfg) for bt in batches]
    states = replay.stack_bags([lio.init_state(cfg, "cpu")] * 2)
    stacked = replay.stack_bags(batches)
    fin, out = batched.run_sequence_batched(states, stacked, lut, cfg=cfg)

    base = bench.bench_config()
    jcfg = R(_cut(base, gn_backend="jnp", fused_gather=False),
             ekf=R(base.ekf, predict_batch="unroll", update_form="xla"),
             scan_unroll=1)
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    jposes = []
    for r in raw:
        jb = jlio.build_batches(jcfg, *r)
        _, jout = jlio.run_sequence(jlio.init_state(jcfg), jb, jlut,
                                    cfg=jcfg)
        jposes.append(np.asarray(jout.kiss_pose, np.float64))
    return dict(cfg=cfg, lut=lut, states=states, stacked=stacked, fin=fin,
                out=out, singles=singles, jposes=jposes)


def _pose_err(a, b):
    return np.linalg.norm(np.asarray(a)[..., :3, 3]
                          - np.asarray(b)[..., :3, 3], axis=-1)


def test_batched_matches_single_runs_and_jax(bags_run):
    """Each replica of the batched run (twins) within 1e-4 m of the port's
    own ``run_sequence`` of its bag with ``map_points`` equal at every scan
    (JAX's bars between its batched and single runs), and within 0.02 m of
    JAX's ``run_sequence`` of the bag; the final maps are the single
    runs' maps."""
    out, fin = bags_run["out"], bags_run["fin"]
    assert out.kiss_pose.shape == (2, N_SCANS, 4, 4)
    assert fin.kiss.local_map.meta.shape == (2, 1 << 14, 8)
    for i, (sfin, sout) in enumerate(bags_run["singles"]):
        d = _pose_err(out.kiss_pose[i].double(), sout.kiss_pose.double())
        print(f"replica {i}: {d.max():.3g} m from its single run")
        assert d.max() <= SELF_BAR_M, d
        np.testing.assert_allclose(out.ekf_pose[i].numpy(),
                                   sout.ekf_pose.numpy(), atol=SELF_BAR_M)
        _eq(out.aux.map_points[i], sout.aux.map_points)
        _eq(out.aux.iterations[i], sout.aux.iterations)
        _eq(out.scan_valid[i], sout.scan_valid)
        assert bool(out.scan_valid[i, 1:].all())   # scan 0 has no IMU
        dj = _pose_err(out.kiss_pose[i].double(), bags_run["jposes"][i])
        print(f"replica {i}: {dj.max():.3g} m from JAX")
        assert dj.max() <= POSE_BAR_M, dj
        assert int(out.aux.map_points[i, -1]) > int(
            out.aux.map_points[i, 1]) > 0
        # same map population as the single run's (voxels, stored points)
        fm, sm = fin.kiss.local_map.meta[i], sfin.kiss.local_map.meta
        assert int((fm[:, 1] > 0).sum()) == int((sm[:, 1] > 0).sum())
        assert int(fm[:, 1].sum()) == int(sm[:, 1].sum())
    assert not torch.equal(out.kiss_pose[0], out.kiss_pose[1])


def test_batched_log_shapes_and_knots(bags_run):
    """``log=True``: histories [B, N, K] whose knots (``updated``) and
    timestamps are each bag's single logged run's, and carried poses
    bit-equal to the unlogged batched run."""
    cfg, lut = bags_run["cfg"], bags_run["lut"]
    _, out = batched.run_sequence_batched(
        bags_run["states"], bags_run["stacked"], lut, cfg=cfg, log=True)
    k = cfg.max_imu_per_scan
    assert out.flog.pos.shape == (2, N_SCANS, k, 3)
    assert out.flog.cov_diag.shape == (2, N_SCANS, k, 18)
    _eq(out.kiss_pose, bags_run["out"].kiss_pose)
    _eq(out.ekf_pose, bags_run["out"].ekf_pose)
    for i in range(2):
        _, sout = lio.run_sequence(
            lio.init_state(cfg, "cpu"), replicas.take(bags_run["stacked"], i),
            lut, cfg=cfg, log=True)
        _eq(out.flog.updated[i], sout.flog.updated)
        _eq(out.flog.ts[i], sout.flog.ts)
        assert int(out.flog.updated[i].sum()) == N_SCANS - 1  # not scan 0
        np.testing.assert_allclose(out.flog.pos[i].numpy(),
                                   sout.flog.pos.numpy(), atol=SELF_BAR_M)


def _with(cfg, kw):
    """``cfg`` with the fields of ``kw``, ``kiss`` and ``ekf`` given as
    dicts of their own fields."""
    kw = dict(kw)
    sub = {name: R(getattr(cfg, name), **kw.pop(name))
           for name in ("kiss", "ekf") if name in kw}
    return R(cfg, **sub, **kw)


@pytest.mark.parametrize("kw,what", [
    pytest.param(dict(kiss=dict(nn_mode="every")), "every",
                 id="kw2-every"),
    pytest.param(dict(map_frozen=True), "map_frozen", id="kw3-map_frozen"),
])
def test_unported_configurations_raise(bags_run, kw, what):
    """The two configurations the JAX package's batched driver refuses
    raise ValueError naming what is refused and citing JAX's own refusal
    (``ptudes_tpu/models/kiss.py:160-167``,
    ``ptudes_tpu/parallel/batched.py:69-74``)."""
    bad = _with(bags_run["cfg"], kw)
    with pytest.raises(ValueError, match=what) as e:
        batched.run_sequence_batched(bags_run["states"], bags_run["stacked"],
                                     bags_run["lut"], cfg=bad)
    assert "ptudes_tpu/" in str(e.value)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(kiss=dict(nn_refresh_drift=0.5, nn_neighborhood=27)),
                 id="candidate-refresh"),
    pytest.param(dict(ekf=dict(predict_batch="assoc")), id="assoc"),
    pytest.param(dict(guess="kiss"), id="guess"),
    pytest.param(dict(deskew_mode="kiss"), id="deskew_mode"),
])
def test_batched_runs_configuration(bags_run, kw):
    """The configurations the driver now runs beside the bench
    configuration's twins (the candidate-refresh loop at half a voxel with
    the 27-neighbourhood, both ``KissConfig``'s defaults; the ``"assoc"``
    predict; the constant-velocity guess; KISS's deskew): each replica
    within 1e-4 m of the port's own ``run_sequence`` of its bag, with
    ``map_points`` and the GN iteration counts equal at every scan (JAX's
    bars between its batched and single runs). The comparisons with JAX
    are tests/test_torch_batched_refresh.py's and
    test_torch_batched_guess.py's.

    The refresh loop with bench's 7-neighbourhood is not held here: on this
    scene replica 0's ICP stops at its 20-iteration cap unconverged at
    scans 3 and 5 (in the single run too), and there the batched loop's
    [B, 4, 4] products, which the CPU rounds differently from 4 x 4 ones,
    grow to 1.5 mm by scan 6. The frozen path's twins run replica by
    replica and show no difference."""
    cfg = _with(bags_run["cfg"], kw)
    lut, stacked = bags_run["lut"], bags_run["stacked"]
    _, out = batched.run_sequence_batched(
        replay.stack_bags([lio.init_state(cfg, "cpu")] * 2), stacked, lut,
        cfg=cfg)
    for i in range(2):
        _, sout = lio.run_sequence(lio.init_state(cfg, "cpu"),
                                   replicas.take(stacked, i), lut, cfg=cfg)
        d = _pose_err(out.kiss_pose[i].double(), sout.kiss_pose.double())
        print(f"{kw} replica {i}: {d.max():.3g} m from its single run")
        assert d.max() <= SELF_BAR_M, d
        _eq(out.aux.map_points[i], sout.aux.map_points)
        _eq(out.aux.iterations[i], sout.aux.iterations)
        _eq(out.scan_valid[i], sout.scan_valid)
    assert not torch.equal(out.kiss_pose[0], out.kiss_pose[1])


def test_bench_variants_are_accepted():
    """The bench configuration's variants the driver runs pass its check:
    the fused-gather flag, the point loss, column decimation, the 4-, 7-
    and 27-neighbourhoods, every steady insert mode, and their twins."""
    base = config.bench_config()
    for cfg in [base, R(base, kiss=R(base.kiss, fused_gather=True)),
                R(base, kiss=R(base.kiss, loss="point")),
                R(base, col_decimation=2),
                *[R(base, kiss=R(base.kiss, nn_neighborhood=j))
                  for j in (4, 7, 27)],
                *[R(base, steady_insert_mode=m) for m in (False, True,
                                                          "cond")]]:
        batched.check_config(cfg)
        batched.check_config(config.twin_config(cfg))


def test_front_end_replica_axis_matches_per_replica(bags_run):
    """The front end with a leading replica axis on two bags' different
    scans (projection at column decimation 1 and 2, deskew by two
    different twists, range clip, window pre-dedup, compaction with and
    without the even decimation, the sorted first-in-voxel passes at and
    above capacity) equals each replica's own call bit for bit."""
    lut = bags_run["lut"]
    rm = bags_run["stacked"].range_m[:, 3]                    # [2, H, W]
    twist = torch.tensor([[0.01, -0.02, 0.15, 0.2, 0.01, -0.03],
                          [-0.03, 0.01, -0.1, 0.15, -0.02, 0.0]])
    grid = rm.shape[1:]
    for d in (1, 2):
        pts, mask, ts = scan_to_points(lut, rm, decimate=d)
        for i in range(2):
            for x, y in zip((pts[i], mask[i], ts[i]),
                            scan_to_points(lut, rm[i], decimate=d)):
                _eq(x, y)
    pts, mask, ts = scan_to_points(lut, rm)
    dsk = deskew.deskew_by_twist(pts, ts - 0.5, twist)
    clip = voxel.range_clip_mask(dsk, mask, 1.0, 30.0)
    pre = voxel.window_prededup_mask(dsk, clip, 0.15, grid)
    assert 100 < int(pre[0].sum()) < int(clip[0].sum())
    cp, cm = voxel.compact(dsk, pre, 4096)
    f1, k1 = voxel.first_in_voxel_sorted(cp, cm, 0.15, 4096)
    f2, k2 = voxel.first_in_voxel_sorted(cp, cm, 0.45, 1024)
    src, sm = voxel.compact(f2, k2, 256, decimate_overflow=True)
    assert int(k2[0].sum()) > 256 and int(sm[0].sum()) == 256
    for i in range(2):
        d1 = deskew.deskew_by_twist(pts[i], ts[i] - 0.5, twist[i])
        _eq(dsk[i], d1)
        c1 = voxel.range_clip_mask(d1, mask[i], 1.0, 30.0)
        _eq(clip[i], c1)
        p1 = voxel.window_prededup_mask(d1, c1, 0.15, grid)
        _eq(pre[i], p1)
        cp1, cm1 = voxel.compact(d1, p1, 4096)
        _eq(cp[i], cp1)
        _eq(cm[i], cm1)
        g1, j1 = voxel.first_in_voxel_sorted(cp1, cm1, 0.15, 4096)
        _eq(f1[i], g1)
        _eq(k1[i], j1)
        g2, j2 = voxel.first_in_voxel_sorted(cp1, cm1, 0.45, 1024)
        _eq(f2[i], g2)
        _eq(k2[i], j2)
        s1, m1 = voxel.compact(g2, j2, 256, decimate_overflow=True)
        _eq(src[i], s1)
        _eq(sm[i], m1)


def test_deferred_single_steps_are_the_batched_run(bags_run):
    """The JAX driver's formulation on the port's single step: each
    replica's ``lio.make_scan_step(defer_insert=True,
    map_logical_capacity=C)`` on the shared flat table at its slot base,
    then one ``insert_deduped_batched`` and ``remove_far_batched`` of the
    deferred inserts a scan, gives the batched run's outputs bit for bit;
    ``defer_insert`` with a frozen map raises."""
    cfg, lut = bags_run["cfg"], bags_run["lut"]
    stacked, out = bags_run["stacked"], bags_run["out"]
    c = cfg.cap.map_capacity
    vs = cfg.kiss.resolved_voxel_size
    flat = hashmap.create_batched(2, c, cfg.kiss.max_points_per_voxel,
                                  "cpu")
    states = [lio.init_state(cfg, "cpu") for _ in range(2)]
    rows = []
    for i in range(N_SCANS):
        steady = i >= cfg.bootstrap_scans
        step = lio.make_scan_step(
            lut, cfg, insert_overflow=cfg.steady_insert_mode if steady
            else True, defer_insert=True, map_logical_capacity=c)
        res = []
        for b in range(2):
            st = states[b]._replace(kiss=states[b].kiss._replace(
                local_map=flat))
            res.append(step(st, replicas.take(batched.scan_of(
                stacked, i), b), torch.tensor(b * c, dtype=torch.int32)))
        dfr = replicas.stack([r[2] for r in res])
        flat = hashmap.insert_deduped_batched(
            flat, dfr.frame_w, dfr.mask, voxel_size=vs,
            max_probes=cfg.cap.max_probes,
            new_capacity=cfg.cap.max_new_per_scan if steady
            else cfg.cap.max_frame,
            overflow=cfg.steady_insert_mode if steady else True,
            logical_capacity=c)
        flat = hashmap.remove_far_batched(flat, dfr.origin, dfr.evict_r2,
                                          logical_capacity=c)
        row = torch.stack([r[1] for r in res])
        row[:, lio._PK_AUX + 6] = hashmap.replica_points(flat, 2).float()
        rows.append(row)
        states = [r[0] for r in res]
    got = lio.unpack_out(torch.stack(rows, 1))
    for name in ("kiss_pose", "ekf_pose", "scan_valid"):
        _eq(getattr(got, name), getattr(out, name))
    for a, b in zip(got.aux, out.aux):
        _eq(a, b)
    _eq(flat.meta.reshape(2, c, 8), bags_run["fin"].kiss.local_map.meta)
    with pytest.raises(ValueError, match="frozen"):
        lio.make_scan_step(lut, R(cfg, map_frozen=True),
                           defer_insert=True)(
            states[0], replicas.take(batched.scan_of(stacked, 0), 0))
