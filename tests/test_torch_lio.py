"""PyTorch port: the LIO main path against the JAX package.

tests/test_lio.py's scene (a speed-ramped circle through a 25 m box world,
rotosweep, end-of-sweep timestamps) at 32 x 256 for 12 scans, rendered by
the port's numpy sim for both packages. The configuration is
``bench_config``'s structure at these values: max_source 2048, 8 points
per voxel, 7-neighbourhood over 4 voxels, one probe, 3 bootstrap scans
then the decimated steady insert, with the capacities cut to the scan size
and tests/test_lio.py's 30 m range clip. The JAX reference runs the XLA
forms of the four kernels (their parity is pinned by test_torch_ekf.py and
test_torch_icp.py). Every pose must agree within 0.02 m, the bar of
``__graft_entry__.py``'s multichip parity check; so must the variants with
an IMU gap (a scan without samples, its update masked),
``bootstrap_scans=-1`` and ``steady_insert_mode=True``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.models import lio, sim
from ptudes_tpu_torch.utils import convert

torch.set_num_threads(2)

N_SCANS = 12
POSE_BAR_M = 0.02


def _cut(cfg, **kiss):
    return dataclasses.replace(
        cfg, kiss=dataclasses.replace(cfg.kiss, max_range=30.0, **kiss),
        cap=dataclasses.replace(cfg.cap, max_points=32 * 256,
                                max_frame=8192, map_capacity=1 << 16))


def port_config(**kw):
    return dataclasses.replace(_cut(config.bench_config()), **kw)


def jax_config(gn_backend="jnp", fused_gather=False, **kw):
    base = bench.bench_config()
    cfg = _cut(base, gn_backend=gn_backend, fused_gather=fused_gather)
    return dataclasses.replace(
        cfg, ekf=dataclasses.replace(base.ekf, predict_batch="unroll",
                                     update_form="xla"),
        scan_unroll=1, **kw)


def render_scene():
    """(sensor, scans, scan_ts, imu_ts, imu, gt_mid) of the 32 x 256
    scene, from seeds."""
    ts = np.arange(N_SCANS + 1) * 0.1
    sweep = sim.circle_poses_at(ts, radius=8.0, speed=2.0, ramp=1.0)
    world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=40,
                               keepout_points=sweep[:, :3, 3])
    sensor = sim.make_sim_sensor(h=32, w=256, fov_deg=45.0)
    scans = np.stack([
        sim.render_range_image(world, sweep[i], sensor, max_range=60.0,
                               noise_std=0.01, seed=i, end_pose=sweep[i + 1])
        for i in range(N_SCANS)])
    imu_ts = np.arange(1, N_SCANS * 10 + 2) * 0.01
    imu = sim.imu_for_circle(imu_ts, radius=8.0, speed=2.0, ramp=1.0)
    scan_ts = ts[:N_SCANS] + 0.1
    gt_mid = sim.circle_poses_at(ts[:N_SCANS] + 0.05, radius=8.0, speed=2.0,
                                 ramp=1.0)
    return sensor, scans, scan_ts, imu_ts, imu, gt_mid


@pytest.fixture(scope="module")
def run():
    sensor, scans, scan_ts, imu_ts, imu, gt_mid = render_scene()
    jcfg = jax_config()
    jb = jlio.build_batches(jcfg, scans, scan_ts, imu.lacc, imu.avel,
                            imu_ts)
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    _, jout = jlio.run_sequence(jlio.init_state(jcfg), jb, jlut, cfg=jcfg)
    jboot, _ = jlio.run_sequence(jlio.init_state(jcfg),
                                 jax.tree.map(lambda x: x[:3], jb), jlut,
                                 cfg=jcfg)

    cfg = port_config()
    batches = lio.build_batches(cfg, scans, scan_ts, imu.lacc, imu.avel,
                                imu_ts, device="cpu")
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    kernels.reset_launches()
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches, lut,
                              cfg=cfg)
    return dict(jposes=np.asarray(jout.kiss_pose, np.float64), out=out,
                jboot=jboot, batches=batches, lut=lut, gt_mid=gt_mid,
                launches=dict(kernels.LAUNCHES), jb=jb, jlut=jlut,
                scene=(scans, scan_ts, imu_ts, imu))


def _pose_err(a, b):
    return np.linalg.norm(np.asarray(a)[:, :3, 3] - np.asarray(b)[:, :3, 3],
                          axis=1)


def test_sequence_matches_jax(run):
    out = run["out"]
    kp = out.kiss_pose.double().numpy()
    assert kp.shape == (N_SCANS, 4, 4) and np.isfinite(kp).all()
    assert bool(out.scan_valid.all())
    err = _pose_err(kp, run["jposes"])
    assert err.max() <= POSE_BAR_M, err
    # tests/test_lio.py:113's tracking bound, on poses relative to the
    # first ground-truth pose
    gt = run["gt_mid"]
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.mean(_pose_err(kp, rel) ** 2) < 0.05
    assert int(out.aux.map_points[-1]) > int(out.aux.map_points[0]) > 0
    # CPU tensors: every kernel form ran as its twin
    assert sum(run["launches"].values()) == 0


def test_fused_gather_sequence_matches_jax(run):
    """The same sequence with ``fused_gather=True`` (K6's twin in place of
    the gather and K3's twin) against JAX's fused gather and fused loop
    kernels in interpret mode (``gn_backend="fused"``)."""
    jcfg = jax_config(gn_backend="fused", fused_gather=True)
    _, jout = jlio.run_sequence(jlio.init_state(jcfg), run["jb"], run["jlut"],
                                cfg=jcfg)
    cfg = _cut(config.bench_config(), fused_gather=True)
    kernels.reset_launches()
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), run["batches"],
                              run["lut"], cfg=cfg)
    assert sum(kernels.LAUNCHES.values()) == 0
    kp = out.kiss_pose.double().numpy()
    assert np.isfinite(kp).all() and bool(out.scan_valid.all())
    err = _pose_err(kp, np.asarray(jout.kiss_pose, np.float64))
    assert err.max() <= POSE_BAR_M, err
    # and the fused gather tracks the unfused run of the same port
    assert _pose_err(kp, run["out"].kiss_pose.double().numpy()).max() \
        <= POSE_BAR_M


GAP_SCAN = 5


@pytest.mark.parametrize("case", ["imu_gap", "bootstrap_all",
                                  "steady_insert_exact"])
def test_sequence_variants_match_jax(run, case):
    """The same sequence, port twins against JAX, in three variants no
    other port test runs: scan 5 without IMU samples (its EKF update is
    masked out after the pose update), ``bootstrap_scans=-1`` (every scan
    inserts its whole frame) and ``steady_insert_mode=True`` (the exact
    chunked steady insert); every pose within 0.02 m."""
    kw = {"imu_gap": {}, "bootstrap_all": dict(bootstrap_scans=-1),
          "steady_insert_exact": dict(steady_insert_mode=True)}[case]
    jcfg, cfg = jax_config(**kw), port_config(**kw)
    jb, batches = run["jb"], run["batches"]
    if case == "imu_gap":
        scans, scan_ts, imu_ts, imu = run["scene"]
        keep = ~((imu_ts > scan_ts[GAP_SCAN - 1])
                 & (imu_ts <= scan_ts[GAP_SCAN]))
        args = (scans, scan_ts, imu.lacc[keep], imu.avel[keep], imu_ts[keep])
        jb = jlio.build_batches(jcfg, *args)
        batches = lio.build_batches(cfg, *args, device="cpu")
        assert not bool(batches.imu_valid[GAP_SCAN].any())
    _, jout = jlio.run_sequence(jlio.init_state(jcfg), jb, run["jlut"],
                                cfg=jcfg)
    kernels.reset_launches()
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches,
                              run["lut"], cfg=cfg)
    assert sum(kernels.LAUNCHES.values()) == 0
    valid = out.scan_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jout.scan_valid))
    assert valid.sum() == N_SCANS - (case == "imu_gap")
    for key in ("kiss_pose", "ekf_pose"):
        kp = getattr(out, key).double().numpy()
        assert np.isfinite(kp).all()
        err = _pose_err(kp, np.asarray(getattr(jout, key), np.float64))
        assert err.max() <= POSE_BAR_M, (key, err)
    if case == "imu_gap":
        # the masked update carries the EKF state through the gap scan
        ekf = out.ekf_pose.double().numpy()
        np.testing.assert_array_equal(ekf[GAP_SCAN], ekf[GAP_SCAN - 1])


def test_state_carry_over_from_jax(run):
    leaves = [np.asarray(x) for x in jax.tree.leaves(run["jboot"])]
    state = convert.lio_state_from_numpy(leaves, "cpu")
    back = convert.lio_state_to_numpy(state)
    assert len(back) == len(leaves) == len(convert.LEAVES)
    for i, x in enumerate(leaves):
        np.testing.assert_array_equal(back[convert.leaf_key(i)], x)
        assert back[convert.leaf_key(i)].dtype == x.dtype
    # ... and the same mapping form a checkpoint's np.load gives
    again = convert.lio_state_from_numpy(back, "cpu")
    assert torch.equal(again.kiss.local_map.meta, state.kiss.local_map.meta)

    cfg = port_config(bootstrap_scans=0)
    _, out = lio.run_sequence(state, lio.scan_at(run["batches"],
                                                 slice(3, N_SCANS)),
                              run["lut"], cfg=cfg)
    err = _pose_err(out.kiss_pose.double().numpy(), run["jposes"][3:])
    assert err.max() <= POSE_BAR_M, err


@pytest.mark.parametrize("case", ["default", "log", "bootstrap_all",
                                  "resume", "batched"])
def test_graph_runner_matches_jax(run, case):
    """The sequence drivers' graph form (``models.graph``) without the
    capture, which the CPU cannot make: the same static buffers, scan
    counter and in-graph copies as on a card, against this module's JAX
    run, every pose within 0.02 m. The default schedule (3 boot scans, 9
    steady), with ``log``, ``bootstrap_scans=-1`` on the first 3 scans, the
    steady step alone from JAX's state after them, and the batched driver
    at B = 2; the default schedule bit for bit the eager loop."""
    from ptudes_tpu_torch.models import graph
    from ptudes_tpu_torch.parallel import batched, replay

    cfg, lut, batches = port_config(), run["lut"], run["batches"]
    state, rows = lio.init_state(cfg, "cpu"), slice(0, N_SCANS)
    if case == "bootstrap_all":
        cfg, rows = port_config(bootstrap_scans=-1), slice(0, 3)
    elif case == "resume":
        cfg, rows = port_config(bootstrap_scans=0), slice(3, N_SCANS)
        state = convert.lio_state_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(run["jboot"])], "cpu")
    batches = lio.scan_at(batches, rows)
    if case == "batched":
        _, out = batched.graph_run(
            replay.stack_bags([state] * 2), replay.stack_bags([batches] * 2),
            lut, cfg=cfg, capture=False)
        poses = out.kiss_pose.double().numpy()
    else:
        _, out = lio.graph_run(state, batches, lut, cfg=cfg,
                               log=case == "log", capture=False)
        poses = out.kiss_pose.double().numpy()[None]
    assert graph.LAST_RUN["form"] == "static"
    assert (out.flog is not None) == (case == "log")
    assert np.isfinite(poses).all() and bool(out.scan_valid.all())
    for p in poses:
        err = _pose_err(p, run["jposes"][rows])
        assert err.max() <= POSE_BAR_M, err
    if case == "default":
        for x, y in zip(graph.leaves(out), graph.leaves(run["out"])):
            assert torch.equal(x, y)


def test_cuda_device_is_not_a_fallback():
    """On a machine without a card, asking for CUDA raises, and so do the
    entry points given no device: they default to the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_config()
    with pytest.raises((RuntimeError, AssertionError)):
        lio.init_state(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        lio.init_state(cfg)
    scan_ts, imu_ts = np.array([0.1, 0.2]), np.array([0.05, 0.15])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        lio.build_batches(cfg, np.zeros((2, 4, 8)), scan_ts,
                          np.zeros((2, 3)), np.zeros((2, 3)), imu_ts)
    with pytest.raises((RuntimeError, AssertionError)):
        convert.lut_from_numpy(sim.make_sim_sensor(4, 8).lut, "cuda")


def test_bench_config_matches_bench_py():
    """The port's bench_config carries bench.py's values; only the JAX-only
    knobs are dropped and the kernel forms renamed."""
    p, j = config.bench_config(), bench.bench_config()
    for part in ("kiss", "cap", "ekf"):
        a, b = dataclasses.asdict(getattr(p, part)), \
            dataclasses.asdict(getattr(j, part))
        for k in ("gn_backend", "gn_unroll"):
            b.pop(k, None)
        forms = {"icp_form": "cuda", "predict_batch": "cuda",
                 "update_form": "cuda"}
        for k, v in forms.items():
            if k in a:
                assert a.pop(k) == v
                b.pop(k, None)
        assert a == b, part
    a = {k: v for k, v in dataclasses.asdict(p).items()
         if k not in ("kiss", "cap", "ekf")}
    b = {k: v for k, v in dataclasses.asdict(j).items()
         if k not in ("kiss", "cap", "ekf", "scan_unroll")}
    assert a == b


@pytest.mark.parametrize("flag,guess", [
    ("--use-imu-prediction", "ekf"), ("--use-gt-guess", "gt"), (None, "kiss")])
def test_cli_config_matches_the_cli(flag, guess):
    """The port's cli_config carries the configuration that ``ekf-bench
    ouster`` builds with each guess flag and no other
    (ptudes_tpu/cli/main.py:428-452, rebuilt here); only the JAX-only knobs
    are dropped and the kernel forms renamed (the command's TPU branch picks
    the predict kernel; the ICP kernels are the refresh path's)."""
    from ptudes_tpu.config import Capacity, EkfConfig, KissConfig, \
        PipelineConfig
    h, w = 128, 1024
    use_imu_prediction, use_gt_guess = (flag == "--use-imu-prediction",
                                        flag == "--use-gt-guess")
    j = PipelineConfig(
        kiss=KissConfig(max_range=70.0, min_range=1.0, deskew=True,
                        loss="plane", voxel_size=None),
        cap=Capacity(max_points=h * w),
        ekf=EkfConfig(predict_batch="pallas"),
        guess=("ekf" if use_imu_prediction
               else "gt" if use_gt_guess else "kiss"), map_frozen=False)
    assert j.guess == guess
    p = config.cli_config(h, w, guess=guess)
    forms = {"icp_form": ("cuda", None), "predict_batch": ("cuda", "pallas"),
             "update_form": ("xla", "xla")}
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
    config.check_supported(p)
    twin = config.twin_config(p)
    assert (twin.kiss.icp_form, twin.ekf.predict_batch,
            twin.ekf.update_form) == ("torch", "unroll", "xla")

