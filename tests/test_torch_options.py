"""PyTorch port: the pipeline's remaining options against the JAX package.

Column decimation, the scatter-table first-in-voxel downsample, the hash
map's AddPoints insert, ``remove_far``, its decoded views and ``query``,
the octant candidate gather, ``register_frame`` (a map query every GN
iteration, point and plane loss), K3's twin in point mode, KISS's front end
without a range-image grid; then tests/test_torch_lio.py's 12-scan 32 x 256
sequence with ``col_decimation=2``, ``nn_neighborhood=4``, ``loss="point"``
(frozen, fused and refresh candidates) and ``nn_mode="every"``, every pose
within 0.02 m of JAX's (the bar of ``__graft_entry__.py``'s parity checks).
Integer stages (masks, slots, map tables, candidates) are bit for bit, with
the JAX side under ``jax.jit`` as in its pipeline. Each test prints the gap
it measured.
"""
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.config import Capacity as JCapacity
from ptudes_tpu.config import KissConfig as JKissConfig
from ptudes_tpu.geom import se3 as jse3
from ptudes_tpu.models import kiss as jkiss
from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops import hashmap as jhashmap
from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops import projection as jprojection
from ptudes_tpu.ops import voxel as jvoxel
from ptudes_tpu.ops.pallas_gn import prep_with_plane_pallas
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.config import Capacity, KissConfig
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.models import kiss, lio
from ptudes_tpu_torch.ops import cuda_gather, cuda_gn, hashmap, icp, voxel
from ptudes_tpu_torch.ops.projection import scan_to_points
from ptudes_tpu_torch.utils import convert
from test_pallas_icp import _setup
from test_torch_lio import N_SCANS, POSE_BAR_M, jax_config, port_config, \
    render_scene

torch.set_num_threads(2)

R = dataclasses.replace


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pmap(m):
    return hashmap.VoxelHashMap(_t(m.meta), _t(m.points))


def _pose_gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64))[..., :3, 3].max())


# ------------------------------------------------------------- front end

@pytest.mark.parametrize("d", [2, 4])
def test_scan_to_points_decimated_bit_exact(d):
    """First valid return of each group of d columns, with holes (whole
    groups empty, groups whose first columns are empty)."""
    sensor, scans, *_ = render_scene()
    rng_m = scans[0].copy()
    rng = np.random.default_rng(d)
    rng_m[rng.uniform(size=rng_m.shape) < 0.3] = 0.0
    rng_m[:, :2 * d] = 0.0                            # empty groups
    lut = JXyzLut(jnp.asarray(sensor.lut.direction),
                  jnp.asarray(sensor.lut.offset))
    want = jax.jit(partial(jprojection.scan_to_points, decimate=d))(
        lut, jnp.asarray(rng_m))
    got = scan_to_points(convert.lut_from_numpy(sensor.lut, "cpu"),
                         torch.from_numpy(rng_m), decimate=d)
    h, w = rng_m.shape
    assert got[0].shape == (h * w // d, 3)
    for a, b in zip(got, want):
        _eq(a, b)
    assert 0 < int(got[1].sum()) < h * w // d


@pytest.mark.parametrize("table", [1 << 6, 1 << 12])
def test_first_in_voxel_mask_bit_exact(table):
    """A 64-slot table forces voxel collisions (the later voxel loses its
    points); the downsample compacts the survivors in scan order."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (5000, 3)).astype(np.float32)
    mask = rng.uniform(size=5000) < 0.9
    got = voxel.first_in_voxel_mask(_t(pts), _t(mask), 0.5, table)
    want = jax.jit(jvoxel.first_in_voxel_mask, static_argnums=(2, 3))(
        pts, mask, 0.5, table)
    _eq(got, want)
    n_vox = len(np.unique(np.floor(pts[mask] / 0.5), axis=0))
    assert 0 < int(got.sum()) <= min(n_vox, table)
    got_ds = voxel.voxel_downsample(_t(pts), _t(mask), 0.5, 2048, table)
    want_ds = jax.jit(jvoxel.voxel_downsample, static_argnums=(2, 3, 4))(
        pts, mask, 0.5, 2048, table)
    for a, b in zip(got_ds, want_ds):
        _eq(a, b)


# ------------------------------------------------------------- hash map

@pytest.mark.parametrize("max_probes", [1, 2])
def test_insert_remove_far_bit_exact(max_probes):
    """Three AddPoints inserts into a 2^9-slot map of 6 points a voxel
    (full voxels, claim contention, unresolved chains), then remove_far;
    the tables and the decoded views against JAX's."""
    rng = np.random.default_rng(4)
    jm, pm = jhashmap.create(1 << 9, 6), hashmap.create(1 << 9, 6, "cpu")
    jins = jax.jit(partial(jhashmap.insert, voxel_size=0.5,
                           max_probes=max_probes))
    for k in range(3):
        pts = (rng.uniform(-6, 6, (3000, 3)) + k).astype(np.float32)
        mask = rng.uniform(size=3000) < 0.8
        jm = jins(jm, pts, mask)
        pm = hashmap.insert(pm, _t(pts), _t(mask), voxel_size=0.5,
                            max_probes=max_probes)
        _eq(pm.meta, jm.meta)
        _eq(pm.points, jm.points)
    assert int(hashmap.num_voxels(pm)) > 300
    _eq(hashmap.num_voxels(pm), jhashmap.num_voxels(jm))
    _eq(hashmap.num_points(pm).to(torch.int32), jhashmap.num_points(jm))
    _eq(hashmap.is_empty(pm), jhashmap.is_empty(jm))
    assert bool(hashmap.is_empty(hashmap.create(8, 8, "cpu")))
    _eq(hashmap.stored_points(pm, 0.5),
        jax.jit(jhashmap.stored_points, static_argnums=1)(jm, 0.5))
    origin = np.array([1.0, -0.5, 0.25], np.float32)
    r2 = np.float32(5.0 ** 2)
    jfar = jhashmap.remove_far(jm, jnp.asarray(origin), jnp.asarray(r2))
    pfar = hashmap.remove_far(pm, _t(origin), _t(r2))
    _eq(pfar.meta, jfar.meta)
    _eq(pfar.points, jfar.points)
    assert 0 < int(hashmap.num_voxels(pfar)) < int(hashmap.num_voxels(pm))


@pytest.fixture(scope="module")
def icp_scene():
    """tests/test_pallas_icp.py's scene: a floor and a wall in a 2^14-slot
    map at 0.3 m voxels, 2048 noisy source points, a perturbed guess."""
    m, src, mask, guess = _setup()
    return (m, src, mask, guess), (_pmap(m), _t(src), _t(mask), _t(guess))


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("neighborhood", [7, 27])
def test_query_matches_jax(icp_scene, approx, neighborhood):
    (m, src, _, guess), (pm, tsrc, _, tguess) = icp_scene
    q = jse3.transform(guess, src) + 0.07
    kw = dict(voxel_size=0.3, max_probes=2, approx=approx,
              neighborhood=neighborhood)
    want = jhashmap.query(m, q, **kw)
    got = hashmap.query(pm, _t(q), **kw)
    _eq(got.found, want.found)
    _eq(got.slot, want.slot)
    ok = np.asarray(want.found)
    assert ok.sum() > 1500
    gap = float(np.abs(got.d2.numpy()[ok] - np.asarray(want.d2)[ok]).max())
    assert gap <= 1e-6, gap
    assert np.isinf(got.d2.numpy()[~ok]).all()
    np.testing.assert_allclose(got.nn.numpy(), np.asarray(want.nn),
                               atol=1e-6)
    print(f"query approx={approx} J={neighborhood}: slots exact, d2 gap "
          f"{gap:.2e}")


def test_octant_candidates_bit_exact(icp_scene):
    """neighborhood=4: the centre plus the three face neighbours on the
    query's side of its voxel."""
    (m, src, _, guess), (pm, tsrc, _, tguess) = icp_scene
    kw = dict(voxel_size=0.3, max_probes=2, neighborhood=4, n_voxels=3)
    q = jse3.transform(guess, src)
    want = jax.jit(partial(jicp.gather_candidates, fit_planes=False,
                           **kw))(m, q)
    got = icp.gather_candidates(pm, se3.transform(tguess, tsrc),
                                fit_planes=False, **kw)
    _eq(got.valid, want.valid)
    assert int(got.valid.sum()) > 5000
    _eq(got.pts, want.pts)


@pytest.mark.parametrize("loss", ["point", "plane"])
def test_register_frame_matches_jax(icp_scene, loss):
    (m, src, mask, guess), (pm, tsrc, tmask, tguess) = icp_scene
    kw = dict(voxel_size=0.3, max_probes=2, max_iterations=30,
              convergence=1e-5, loss=loss, prior_rot_weight=0.01,
              prior_trans_weight=0.01)
    want = jicp.register_frame(src, mask, m, guess, jnp.float32(0.5),
                               jnp.float32(0.1667), **kw)
    icp.reset_refresh_counts()
    got = icp.register_frame(tsrc, tmask, pm, tguess, torch.tensor(0.5),
                             torch.tensor(0.1667), **kw)
    gap = _pose_gap(got.pose.numpy(), want.pose)
    assert gap <= 1e-5, gap
    assert np.abs(got.pose.numpy() - np.asarray(want.pose)).max() <= 1e-5
    assert int(got.iterations) == int(want.iterations)
    assert abs(int(got.num_corr) - int(want.num_corr)) <= 2
    assert got.num_corr.dtype == torch.int32
    # one host read an iteration after the first
    assert icp.REFRESH_COUNTS["host_reads"] == int(got.iterations) - (
        int(got.iterations) == 30)
    print(f"register_frame loss={loss}: |dt| {gap:.2e} m, "
          f"{int(got.iterations)} iterations")


def test_prep_point_mode_matches_pallas(icp_scene):
    """K3's twin with ``loss="point"`` against ``prep_with_plane_pallas``:
    no fit, feat zeros / -1 / mask, the lane-major rows, all bit for bit
    (at a ragged N too: the point branch has no block constraint)."""
    (m, src, mask, guess), (pm, tsrc, tmask, tguess) = icp_scene
    kw = dict(voxel_size=0.3, max_probes=2, neighborhood=7, n_voxels=4)
    q = jse3.transform(guess, src)
    cj = jax.jit(partial(jicp.gather_candidates, fit_planes=False, **kw))(
        m, q)
    cand = icp.gather_candidates(pm, se3.transform(tguess, tsrc),
                                 fit_planes=False, **kw)
    for n in (2048, 2046):
        want = prep_with_plane_pallas(
            jicp.CandidateSet(*(x[:n] for x in cj)), mask[:n], q[:n],
            jnp.float32(0.6), loss="point")
        cut = icp.CandidateSet(*(x[:n] for x in cand))
        for prep in (cuda_gn.prep_with_plane, cuda_gn.prep_with_plane_torch):
            got = prep(cut, tmask[:n], se3.transform(tguess, tsrc)[:n], 0.6,
                       loss="point")
            for a, b in zip(got, want):
                _eq(a, b)
    assert (got.feat[6] == -1).all()


# ------------------------------------------------------------- KISS

@pytest.fixture(scope="module")
def scene():
    sensor, scans, scan_ts, imu_ts, imu, gt_mid = render_scene()
    return dict(sensor=sensor, scans=scans, gt_mid=gt_mid,
                args=(scans, scan_ts, imu.lacc, imu.avel, imu_ts),
                jlut=JXyzLut(jnp.asarray(sensor.lut.direction),
                             jnp.asarray(sensor.lut.offset)),
                lut=convert.lut_from_numpy(sensor.lut, "cpu"))


KISS_NO_GRID = dict(max_range=30.0, min_range=1.0, max_points_per_voxel=16,
                    max_iterations=40, deskew=True, loss="point",
                    nn_mode="every")
CAP_NO_GRID = dict(max_points=32 * 256, max_frame=8192, max_source=8192,
                   map_capacity=1 << 16, dedup_table=1 << 17)


def test_register_scan_without_grid_matches_jax(scene):
    """``grid_hw=None`` (the scatter-table front end) with a map query each
    GN iteration and the constant-velocity guess and deskew, 6 scans: the
    poses within 0.02 m of JAX's, the source counts equal, the first scan's
    map tables bit for bit (later inserts happen at poses that differ in
    the last bits, so a point near a voxel face may land in the next
    voxel: the map counts within 0.1 %); and
    against the port's own grid path (tests/test_kiss_odometry.py:125's
    bounds: as good a track, at least as many stored points, within 5 %)."""
    jcfg, jcap = JKissConfig(**KISS_NO_GRID), JCapacity(**CAP_NO_GRID)
    cfg, cap = KissConfig(**KISS_NO_GRID), Capacity(**CAP_NO_GRID)
    js = jkiss.init_state(jcfg, jcap)
    ps, pg = (kiss.init_state(cfg, cap, "cpu") for _ in range(2))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(scene["gt_mid"][0]),
                   scene["gt_mid"])
    gaps = []
    for i in range(6):
        rng_m = scene["scans"][i]
        jp = jprojection.scan_to_points(scene["jlut"], jnp.asarray(rng_m))
        js, jpose, jaux = jkiss.register_scan(js, *jp, cfg=jcfg, cap=jcap)
        pts = scan_to_points(scene["lut"], torch.from_numpy(rng_m))
        ps, pose, aux = kiss.register_scan(ps, *pts, cfg=cfg, cap=cap)
        pg, pose_g, _ = kiss.register_scan(pg, *pts, cfg=cfg, cap=cap,
                                           grid_hw=(32, 256))
        gaps.append(_pose_gap(pose.numpy(), jpose))
        assert int(aux.source_count) == int(jaux.source_count)
        if i == 0:
            _eq(ps.local_map.meta, js.local_map.meta)
            _eq(ps.local_map.points, js.local_map.points)
        assert abs(int(aux.map_points) - int(jaux.map_points)) \
            <= 1e-3 * int(jaux.map_points)
        err_a = np.linalg.norm(pose.numpy()[:3, 3] - gt[i, :3, 3])
        err_b = np.linalg.norm(pose_g.numpy()[:3, 3] - gt[i, :3, 3])
        assert err_b <= err_a + 0.05, (i, err_a, err_b)
        na = int(hashmap.num_points(ps.local_map))
        nb = int(hashmap.num_points(pg.local_map))
        assert na <= nb <= na * 1.05, (na, nb)
    assert max(gaps) <= POSE_BAR_M, gaps
    print(f"register_scan without grid: max pose gap {max(gaps):.2e} m")
    v = kiss.velocity(ps, torch.tensor(0.1))
    np.testing.assert_allclose(
        v.numpy(), np.asarray(jkiss.velocity(js, jnp.float32(0.1))),
        atol=1e-4)


# ------------------------------------------------------------- sequences

# case -> PipelineConfig changes for both packages (kiss: KissConfig fields)
SEQ_CASES = {
    "col_decimation_2": dict(col_decimation=2),
    "nn_neighborhood_4": dict(kiss=dict(nn_neighborhood=4)),
    "loss_point_frozen": dict(kiss=dict(loss="point")),
    "loss_point_fused": dict(kiss=dict(loss="point", fused_gather=True)),
    "loss_point_refresh": dict(kiss=dict(loss="point",
                                         nn_refresh_drift=0.5)),
    "nn_mode_every": dict(kiss=dict(nn_mode="every", loss="point",
                                    max_iterations=30)),
}


def _apply(cfg, change, jax_side=False):
    change = dict(change)
    if "kiss" in change:
        kw = dict(change["kiss"])
        if jax_side and kw.get("fused_gather"):
            kw["gn_backend"] = "fused"          # JAX's fused gather + loop
        change["kiss"] = R(cfg.kiss, **kw)
    return R(cfg, **change)


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_option_matches_jax(scene, case):
    change = SEQ_CASES[case]
    jcfg = _apply(jax_config(), change, jax_side=True)
    cfg = _apply(port_config(), change)
    config.check_supported(cfg)
    jb = jlio.build_batches(jcfg, *scene["args"])
    _, jout = jlio.run_sequence(jlio.init_state(jcfg), jb, scene["jlut"],
                                cfg=jcfg)
    batches = lio.build_batches(cfg, *scene["args"], device="cpu")
    kernels.reset_launches()
    icp.reset_refresh_counts()
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches,
                              scene["lut"], cfg=cfg)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert bool(out.scan_valid.all())
    gaps = {}
    for key in ("kiss_pose", "ekf_pose"):
        kp = getattr(out, key).double().numpy()
        assert np.isfinite(kp).all() and kp.shape == (N_SCANS, 4, 4)
        gaps[key] = _pose_gap(kp, getattr(jout, key))
    assert max(gaps.values()) <= POSE_BAR_M, gaps
    np.testing.assert_array_equal(out.aux.source_count.numpy(),
                                  np.asarray(jout.aux.source_count))
    if case == "nn_mode_every":
        assert icp.REFRESH_COUNTS["host_reads"] > 0
    print(f"{case}: max |kiss pose - JAX| {gaps['kiss_pose']:.2e} m, "
          f"ekf {gaps['ekf_pose']:.2e} m")


def test_octant_fused_gather_takes_the_gather_path(scene, monkeypatch):
    """``fused_gather=True`` with ``nn_neighborhood=4`` runs the gather and
    K3 (as JAX routes it), never K6: the run is bit-equal to the run
    without ``fused_gather``, and K6's twin is never called."""
    def no_k6(*a, **kw):
        raise AssertionError("K6 ran on the octant path")

    monkeypatch.setattr(cuda_gather, "gather_prep_fused_torch", no_k6)
    monkeypatch.setattr(cuda_gather, "gather_prep_fused", no_k6)
    batches = lio.scan_at(lio.build_batches(
        port_config(), *scene["args"], device="cpu"), slice(0, 5))
    outs = []
    for fused in (False, True):
        cfg = _apply(port_config(), dict(kiss=dict(nn_neighborhood=4,
                                                   fused_gather=fused)))
        outs.append(lio.run_sequence(lio.init_state(cfg, "cpu"), batches,
                                     scene["lut"], cfg=cfg)[1])
    assert torch.equal(outs[0].kiss_pose, outs[1].kiss_pose)


@pytest.mark.parametrize("change", [
    dict(col_decimation=2), dict(map_frozen=True),
    dict(kiss=dict(nn_mode="every")), dict(kiss=dict(loss="point")),
    dict(kiss=dict(nn_neighborhood=4)),
])
def test_options_are_supported(change):
    config.check_supported(_apply(port_config(), change))


@pytest.mark.parametrize("change", [
    dict(col_decimation=0), dict(kiss=dict(nn_mode="sometimes")),
    dict(kiss=dict(loss="huber")), dict(kiss=dict(nn_neighborhood=9)),
    dict(kiss=dict(nn_mode="every", nn_neighborhood=4)),
])
def test_unknown_option_values_raise(change):
    with pytest.raises(ValueError):
        config.check_supported(_apply(port_config(), change))
