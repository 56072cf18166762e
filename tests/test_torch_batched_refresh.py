"""PyTorch port: the batched driver's candidate-refresh loop and
associative predict (``parallel.batched`` at the JAX package's default
``PipelineConfig`` structure) against per-replica calls and against JAX.

- K5's twin with a replica axis (``cuda_gn.gn_prepped`` on CPU tensors)
  and an ``active`` mask, and the batched ``prep_candidates``: each
  replica bit for bit against its own call, an inactive replica's output
  row untouched.
- ``icp.register_frames_refresh_batched`` against ``_register_refresh`` per
  replica on tests/test_torch_batched.py's B = 3 flat table, where two
  replicas re-gather and one does not: iteration counts, re-gathers and
  correspondence counts equal, poses within 1e-4 m.
- The ``"assoc"`` predict and KISS's ``deskew_scan`` over [B] against
  per-replica calls.
- The fused-gather guard: a ``logical_capacity`` without a slot base
  raises where K6 would run.
- ``run_sequence_batched`` (twins) at tests/test_batched.py's own
  configuration (refresh 0.5, the ``"assoc"`` predict) on that file's two
  bags (32 x 256, 8 scans): within 0.02 m of JAX's
  ``run_sequence_batched`` and within 1e-4 m of the port's own
  ``run_sequence`` per bag, ``map_points`` equal at every scan.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.config import Capacity as JCapacity
from ptudes_tpu.config import EkfConfig as JEkfConfig
from ptudes_tpu.config import KissConfig as JKissConfig
from ptudes_tpu.config import PipelineConfig as JPipelineConfig
from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu.parallel import batched as jbatched
from ptudes_tpu.parallel import replay as jreplay
from ptudes_tpu_torch.config import (Capacity, EkfConfig, KissConfig,
                                     PipelineConfig)
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.models import esekf, lio
from ptudes_tpu_torch.ops import cuda_gn, deskew, icp
from ptudes_tpu_torch.parallel import batched, replay
from ptudes_tpu_torch.utils import convert, replicas
from test_torch_batched import (CAP, N_SCANS, _ekf_states, _eq, _flat_map,
                                _pose_err, _render_bags)

torch.set_num_threads(2)

POSE_BAR_M = 0.02     # a sequence against JAX's
SELF_BAR_M = 1e-4     # batched against the port's single runs
ICP_KW = dict(voxel_size=0.3, max_probes=2, max_iterations=20,
              convergence=1e-4, plane_min_quality=0.2, prior_rot_weight=0.01,
              prior_trans_weight=0.01, neighborhood=27, n_voxels=4,
              plane_radius=0.6)


def _refresh_inputs(b=3):
    """tests/test_torch_batched.py's B = 3 flat table and 512 noisy points
    of each replica (replica 1 with 112 masked out); replica 0's and 2's
    guesses are far enough off to re-gather on the way, replica 1's is
    not."""
    (_, tm), pts = _flat_map(b)
    rng = np.random.default_rng(4)
    src = torch.from_numpy((pts[:, :512] + rng.normal(0, 0.01, (b, 512, 3)))
                           .astype(np.float32))
    smask = torch.ones((b, 512), dtype=torch.bool)
    smask[1, 400:] = False
    guess = torch.eye(4).repeat(b, 1, 1)
    guess[:, 0, 3] = torch.tensor([0.3, 0.01, -0.2])
    guess[:, 1, 3] = torch.tensor([0.1, 0.0, 0.05])
    return (tm, src, smask, guess, torch.tensor([1.0, 0.8, 1.2]),
            torch.tensor([0.3, 0.25, 0.35]),
            torch.arange(b, dtype=torch.int32) * CAP)


@pytest.mark.parametrize("loss", ["plane", "point"])
def test_gn_prepped_replica_axis_matches_per_replica(loss):
    """K5's twin with a replica axis, bit for bit: every replica's system
    is its single call's; with ``active`` = [1, 0, 1] replica 1's output
    row keeps what it held. The batched ``prep_candidates`` writes each
    replica's rows as its single call does, into one [B, 8 + 4C, N]
    buffer (one replica stride for all five fields)."""
    tm, src, smask, guess, max_d, kern, base = _refresh_inputs()
    b, m = smask.shape
    cands = [icp.gather_candidates(
        tm, se3.transform(guess[i], src[i]), voxel_size=0.3, max_probes=2,
        neighborhood=27, n_voxels=4, fit_planes=loss == "plane",
        plane_radius=0.6, slot_base=base[i], logical_capacity=CAP)
        for i in range(b)]
    single = [cuda_gn.prep_candidates(c, smask[i], loss=loss)
              for i, c in enumerate(cands)]
    prepped = cuda_gn.prep_candidates(replicas.stack(cands), smask,
                                      loss=loss)
    stride = prepped.feat.stride(0)
    assert all(x.stride(0) == stride for x in prepped)
    for i in range(b):
        for x, y in zip(replicas.take(prepped, i), single[i]):
            _eq(x, y)
    t_cur = guess @ se3.exp_twist(torch.tensor(
        [[0.001, 0.0, -0.002, 0.01, 0.02, 0.0]] * b))
    ones = [cuda_gn.gn_prepped(t_cur[i], src[i], single[i], kern[i],
                               max_d[i] ** 2, plane_min_quality=0.2)
            for i in range(b)]
    got = cuda_gn.gn_prepped(t_cur, src, prepped, kern, max_d ** 2,
                             plane_min_quality=0.2)
    for i in range(b):
        for x, y in zip(got, ones[i]):
            _eq(x[i], y)
        assert int(ones[i][2]) > 100
    out = torch.full((b, cuda_gn.GN_OUT), 7.0)
    got = cuda_gn.gn_prepped(t_cur, src, prepped, kern, max_d ** 2,
                             plane_min_quality=0.2,
                             active=torch.tensor([True, False, True]),
                             out=out)
    _eq(out[1], torch.full((cuda_gn.GN_OUT,), 7.0))
    for i in (0, 2):
        for x, y in zip(got, ones[i]):
            _eq(x[i], y)


@pytest.mark.parametrize("loss", ["plane", "point"])
def test_refresh_batched_matches_single_loops(loss):
    """``register_frames_refresh_batched`` against ``_register_refresh``
    (``register_frame_cached`` with the replica's slot base) per replica:
    the same iteration count, re-gathers (replicas 0 and 2 re-gather,
    replica 1 does not) and correspondence count, the pose within 1e-4 m;
    one host read a GN iteration from the second on, whatever B is."""
    tm, src, smask, guess, max_d, kern, base = _refresh_inputs()
    b = smask.shape[0]
    kw = dict(ICP_KW, loss=loss, refresh_drift=0.5, form="cuda")
    icp.reset_refresh_counts()
    res = icp.register_frames_refresh_batched(
        src, smask, tm, guess, max_d, kern, slot_base=base,
        logical_capacity=CAP, **kw)
    counts = dict(icp.REFRESH_COUNTS)
    regathers = []
    for i in range(b):
        icp.reset_refresh_counts()
        one = icp.register_frame_cached(
            src[i], smask[i], tm, guess[i], max_d[i], kern[i],
            slot_base=base[i], logical_capacity=CAP, **kw)
        regathers.append(icp.REFRESH_COUNTS["regathers"])
        _eq(res.iterations[i], one.iterations)
        _eq(res.num_corr[i], one.num_corr)
        d = float((res.pose[i] - one.pose)[:3, 3].abs().max())
        print(f"{loss} replica {i}: {int(one.iterations)} iterations, "
              f"{regathers[-1]} re-gathers, pose {d:.3g} m from its loop")
        assert d <= SELF_BAR_M
        np.testing.assert_allclose(res.dev_t[i], one.dev_t, atol=SELF_BAR_M)
    assert regathers[0] > 0 and regathers[1] == 0 and regathers[2] > 0
    assert counts["regathers"] == sum(regathers)
    assert 0 < counts["host_reads"] <= int(res.iterations.max())


def test_assoc_and_kiss_deskew_replica_axis_match_per_replica():
    """The ``"assoc"`` predict over [B] (three filter states, a replica
    with no valid sample, one with a gap) with its deskew twist against
    each replica's own call: positions, velocities, quaternions and the
    twist within 1e-6, the covariance within 1e-6 of its largest entry
    (the same f32 ops, batched products); ``deskew_scan`` over [B] (one
    replica before its third scan) against each replica's call within
    1e-6 m."""
    b, k = 3, 16
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
    valid[2, 5:9] = False
    cfg = EkfConfig(predict_batch="assoc")
    got, tw = esekf.process_imu_batch(st, imu, valid, cfg=cfg,
                                      want_twist=True)
    for i in range(b):
        one, tw1 = esekf.process_imu_batch(sts[i], replicas.take(imu, i),
                                           valid[i], cfg=cfg,
                                           want_twist=True)
        g = replicas.take(got, i)
        for name in ("pos", "vel", "quat", "imu_ts"):
            np.testing.assert_allclose(getattr(g, name),
                                       getattr(one, name), atol=1e-6)
        _eq(g.initialized, one.initialized)
        np.testing.assert_allclose(
            g.cov, one.cov, atol=1e-6 * float(one.cov.abs().max()))
        np.testing.assert_allclose(tw[i], tw1, atol=1e-6)
    assert not torch.equal(got.pos[0], st.pos[0])
    _eq(got.pos[1], st.pos[1])

    pts = torch.from_numpy(rng.uniform(-20, 20, (b, 500, 3))
                           .astype(np.float32))
    ts01 = torch.from_numpy(rng.uniform(0, 1, (b, 500)).astype(np.float32))
    prev2 = se3.exp_twist(torch.from_numpy(
        rng.normal(0, 0.1, (b, 6)).astype(np.float32)))
    prev1 = prev2 @ se3.exp_twist(torch.from_numpy(
        rng.normal(0, 0.1, (b, 6)).astype(np.float32)))
    enabled = torch.tensor([True, False, True])
    dsk = deskew.deskew_scan(pts, ts01, prev2, prev1, enabled)
    for i in range(b):
        one = deskew.deskew_scan(pts[i], ts01[i], prev2[i], prev1[i],
                                 enabled[i])
        np.testing.assert_allclose(dsk[i], one, atol=1e-6)
    _eq(dsk[1], pts[1])
    assert float((dsk[0] - pts[0]).abs().max()) > 0.01


def test_fused_gather_with_logical_capacity_raises():
    """The fused-gather guard: with ``fused_gather=True``, a
    ``logical_capacity`` and no slot base, ``register_frame_cached`` raises
    ``ValueError`` instead of taking K6, whose hash uses the physical
    capacity (on this input: 502 correspondences and a pose 0.056 m off).
    Replica 0's 512 points of the B = 3 flat table, a guess 0.03 m off:
    the gather (``fused_gather=False``, or a slot base of 0) finds all
    512, the same result both ways."""
    (_, tm), pts = _flat_map(3)
    src = torch.from_numpy(pts[0, :512])
    smask = torch.ones(512, dtype=torch.bool)
    guess = torch.eye(4)
    guess[0, 3] = 0.03
    kw = dict(ICP_KW, neighborhood=7, max_iterations=10, form="torch",
              logical_capacity=CAP)
    args = (src, smask, tm, guess, torch.tensor(1.0), torch.tensor(0.3))
    with pytest.raises(ValueError, match="logical_capacity"):
        icp.register_frame_cached(*args, fused_gather=True, **kw)
    plain = icp.register_frame_cached(*args, fused_gather=False, **kw)
    based = icp.register_frame_cached(
        *args, fused_gather=True, slot_base=torch.tensor(0), **kw)
    assert int(plain.num_corr) == 512
    for x, y in zip(plain, based):
        _eq(x, y)
    assert float(plain.pose[0, 3].abs()) < 0.01


def port_default_config(**kw):
    """tests/test_batched.py's ``make_cfg`` in the port: the library
    defaults (the candidate-refresh loop at half a voxel, the ``"assoc"``
    predict) at the 32 x 256 bags' size, the twins (the defaults)."""
    return PipelineConfig(
        kiss=KissConfig(max_range=30.0, min_range=1.0,
                        max_points_per_voxel=8, max_iterations=20,
                        deskew=True, loss="plane", voxel_size=0.3,
                        plane_fit_radius=0.6),
        cap=Capacity(max_points=32 * 256, max_frame=8192, max_source=4096,
                     map_capacity=1 << 15, dedup_table=1 << 16,
                     max_new_per_scan=4096),
        ekf=EkfConfig(), **{"max_imu_per_scan": 16, "guess": "ekf", **kw})


def jax_default_config(**kw):
    """tests/test_batched.py's ``make_cfg`` itself."""
    return JPipelineConfig(
        kiss=JKissConfig(max_range=30.0, min_range=1.0,
                         max_points_per_voxel=8, max_iterations=20,
                         deskew=True, loss="plane", voxel_size=0.3,
                         plane_fit_radius=0.6),
        cap=JCapacity(max_points=32 * 256, max_frame=8192, max_source=4096,
                      map_capacity=1 << 15, dedup_table=1 << 16,
                      max_new_per_scan=4096),
        ekf=JEkfConfig(), **{"max_imu_per_scan": 16, "guess": "ekf", **kw})


def gt_guesses(n=N_SCANS):
    """Each bag's ground-truth poses at its scan times, relative to its
    first (``batch.guess_pose`` for ``guess="gt"``)."""
    from ptudes_tpu_torch.models import sim
    ts, _ = sim.circle_trajectory(n, radius=8.0, speed=2.0, scan_dt=0.1)
    out = []
    for radius in (8.0, 6.0):
        poses = sim.circle_poses_at(ts, radius=radius, speed=2.0)
        out.append((np.linalg.inv(poses[0]) @ poses).astype(np.float32))
    return out


def run_both(pkw=None, jkw=None, gt=False):
    """The port's ``run_sequence_batched`` and its ``run_sequence`` per bag
    at :func:`port_default_config` (``pkw``), and JAX's
    ``run_sequence_batched`` at :func:`jax_default_config` (``jkw``), on
    tests/test_batched.py's two bags (with the ground-truth guesses when
    ``gt``)."""
    sensor, raw = _render_bags()
    guesses = gt_guesses() if gt else [None, None]
    cfg = port_default_config(**(pkw or {}))
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    bts = [lio.build_batches(cfg, *r, guess_poses=g, device="cpu")
           for r, g in zip(raw, guesses)]
    singles = [lio.run_sequence(lio.init_state(cfg, "cpu"), bt, lut,
                                cfg=cfg)[1] for bt in bts]
    icp.reset_refresh_counts()
    _, out = batched.run_sequence_batched(
        replay.stack_bags([lio.init_state(cfg, "cpu")] * 2),
        replay.stack_bags(bts), lut, cfg=cfg)
    counts = dict(icp.REFRESH_COUNTS)
    jcfg = jax_default_config(**(jkw or {}))
    jbags = [jlio.build_batches(jcfg, *r, guess_poses=g)
             for r, g in zip(raw, guesses)]
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    _, jout = jbatched.run_sequence_batched(
        jreplay.stack_bags([jlio.init_state(jcfg)] * 2),
        jax.tree.map(lambda *xs: jnp.stack(xs), *jbags), jlut, cfg=jcfg)
    return out, singles, np.asarray(jout.kiss_pose, np.float64), counts


def check_against(out, singles, jposes, counts, what):
    """Each replica within 1e-4 m of its single run with ``map_points``,
    the iteration counts and the skipped scans equal (JAX's bars between
    its batched and single runs, tests/test_batched.py:156-162), and within
    0.02 m of JAX's batched run; at most one host read a GN iteration."""
    assert out.kiss_pose.shape == (2, N_SCANS, 4, 4)
    for i, sout in enumerate(singles):
        d = _pose_err(out.kiss_pose[i].double(), sout.kiss_pose.double())
        dj = _pose_err(out.kiss_pose[i].double(), jposes[i])
        print(f"{what} replica {i}: {d.max():.3g} m from its single run, "
              f"{dj.max():.3g} m from JAX's batched run")
        assert d.max() <= SELF_BAR_M, d
        assert dj.max() <= POSE_BAR_M, dj
        np.testing.assert_allclose(out.ekf_pose[i].numpy(),
                                   sout.ekf_pose.numpy(), atol=SELF_BAR_M)
        _eq(out.aux.map_points[i], sout.aux.map_points)
        _eq(out.aux.iterations[i], sout.aux.iterations)
        _eq(out.scan_valid[i], sout.scan_valid)
        assert int(out.aux.map_points[i, -1]) > int(out.aux.map_points[i, 1])
    assert not torch.equal(out.kiss_pose[0], out.kiss_pose[1])
    assert counts["host_reads"] <= int(out.aux.iterations.max(0)[0].sum())


def test_batched_at_jax_default_config():
    """``run_sequence_batched`` at JAX's own batched test configuration
    (refresh 0.5, the ``"assoc"`` predict; tests/test_batched.py:100-114):
    within 0.02 m of JAX's ``run_sequence_batched``, within 1e-4 m of the
    port's ``run_sequence`` per bag with ``map_points`` equal at every
    scan; ``check_config`` accepts it."""
    cfg = port_default_config()
    assert cfg.kiss.nn_refresh_drift == 0.5
    assert cfg.ekf.predict_batch == "assoc"
    batched.check_config(cfg)
    out, singles, jposes, counts = run_both()
    check_against(out, singles, jposes, counts, "refresh + assoc")
    assert counts["regathers"] > 0
