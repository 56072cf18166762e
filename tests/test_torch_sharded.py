"""PyTorch port: point-sharded LIO across ranks (``parallel.sharded``)
against the JAX package's ``sharded_run_sequence`` and ``lio.run_sequence``.

The scene and configuration are ``__graft_entry__._tiny_setup``'s (32 x
256, ``max_source`` 2048, 27-neighbourhood, the candidate-refresh loop)
over 6 scans, rendered by the port's numpy sim here and by the JAX
package's in the reference processes (the range images must be equal). The
port's launcher (``run_sharded``) runs the ranks as processes with the
gloo backend on the CPU, each with one thread.

The JAX reference runs in fresh subprocesses on a two-device CPU mesh, as
``__graft_entry__.dryrun_multichip`` does (tests/conftest.py records that
the CPU compiler can crash on shard_map programs in a process that has
compiled many others), started when the scene is built so the port's runs
overlap their compiles: its 1 x 2 sharded run and its single-device run of
the refresh configuration, and its 1 x 2 sharded runs of the frozen-
candidate form (``nn_refresh_drift=0``) with and without ``fused_gather``
through its prepped kernels (``gn_backend="pallas"``, interpret mode),
K3's or K6's counterpart once a scan and K5's a GN iteration. Those
kernels take a shard a multiple of 2048 points, so the frozen runs, the
port's too, have ``max_source`` 4096.

- world sizes 2 and 4: every pose within 0.02 m of both JAX runs (the bar
  of tests/test_parallel.py and ``__graft_entry__``), the correspondence
  counts within 0.5 % of JAX's, every rank's outputs and state bit-equal;
- world size 1 against the port's own ``run_sequence`` (0.02 m; the
  maximum is printed);
- the frozen-candidate form (K3's twin, then K5's twin and one all-reduce
  a GN iteration) and ``fused_gather=True`` (K6's twin) at world size 2
  against JAX's sharded runs of the same configurations and the port's
  single runs (K4's twin), at the same two bars;
- ``log=True``: the filter history, and the carried poses equal to the
  unlogged run's;
- the graph form (``models.graph``'s runner without the capture,
  ``capture=False``: the GN loop's WHILE body, with the all-reduce in it,
  and the re-gather's IF body as host loops) of the refresh, frozen and
  fused forms at world size 2: rows, final state, GN iterations,
  all-reduces (counted as the card counts them) and re-gathers equal to
  the eager sharded run's, no host read, within 0.02 m of JAX's sharded
  run;
- ``ValueError`` for ``max_source % n_pt != 0``, ``nn_mode="every"``, a
  backend that does not fit the devices and ``graph=True`` with gloo;
  ``TimeoutError`` once the ranks outlast ``run_sharded``'s wall-clock
  limit (they are killed); ``make_mesh(2, 2)``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptudes_tpu_torch import config
from ptudes_tpu_torch.models import lio, sim
from ptudes_tpu_torch.parallel import mesh, sharded
from ptudes_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCANS, H, W = 6, 32, 256
POSE_BAR_M = 0.02
CORR_FRAC = 0.005   # correspondence counts against JAX's

FROZEN_SOURCE = 4096   # max_source of the frozen-candidate runs
# the JAX reference runs, one subprocess each: the refresh configuration
# (sharded and single-device), the frozen form, the frozen form fused
JAX_FORMS = ("refresh", "frozen", "fused")

JAX_REFERENCE = """
import dataclasses
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
from ptudes_tpu.models import lio
from ptudes_tpu.parallel import mesh as mesh_lib, sharded
n_scans, path, form, frozen_source = sys.argv[1:]
cfg, sensor, batches = g._tiny_setup(n_scans=int(n_scans))
grid = mesh_lib.make_mesh(n_bags=1, n_pt=2, devices=jax.devices()[:2])
res = dict(range_m=np.asarray(batches.range_m))
if form == "refresh":
    _, single = lio.run_sequence(lio.init_state(cfg), batches, sensor.lut,
                                 cfg=cfg)
    res.update(single=np.asarray(single.kiss_pose),
               single_corr=np.asarray(single.aux.num_corr))
else:
    cfg = dataclasses.replace(
        cfg, cap=dataclasses.replace(cfg.cap, max_source=int(frozen_source)),
        kiss=dataclasses.replace(cfg.kiss, nn_refresh_drift=0.0,
                                 gn_backend="pallas",
                                 fused_gather=form == "fused"))
_, shard = sharded.sharded_run_sequence(lio.init_state(cfg), batches,
                                        sensor.lut, cfg, grid)
res.update(sharded=np.asarray(shard.kiss_pose),
           sharded_corr=np.asarray(shard.aux.num_corr))
np.savez(path, **res)
"""


def tiny_config(max_source: int = 2048, **kiss) -> config.PipelineConfig:
    """``_tiny_setup``'s configuration, the ICP kernels' wrappers (their
    twins on the CPU)."""
    return config.PipelineConfig(
        kiss=config.KissConfig(max_range=30.0, min_range=1.0,
                               max_points_per_voxel=8, max_iterations=10,
                               deskew=True, loss="plane", icp_form="cuda",
                               **kiss),
        cap=config.Capacity(max_points=H * W, max_frame=4096,
                            max_source=max_source, map_capacity=1 << 14,
                            dedup_table=1 << 15),
        ekf=config.EkfConfig(), max_imu_per_scan=16, guess="ekf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's in-process runs, as each rank
    child has (``sharded._rank_main``), and the count before it put back
    after: set at import, it held for every test collected after this
    file in the same process (under ``-n 4 --dist loadfile`` each worker
    collects every file, so a batched refresh test elsewhere ran on one
    thread and its rounding moved)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(batches, lut, {form: (JAX process, its output file)}): the scene on
    the CPU; the JAX references start here and run while the port's runs
    do."""
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = {}
    for form in JAX_FORMS:
        ref = str(tmp / f"jax_{form}.npz")
        procs[form] = (subprocess.Popen(
            [sys.executable, "-c", JAX_REFERENCE, str(N_SCANS), ref, form,
             str(FROZEN_SOURCE)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), ref)
    ts, poses = sim.circle_trajectory(N_SCANS, radius=8.0, speed=2.0,
                                      scan_dt=0.1)
    world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=10,
                               keepout_points=poses[:, :3, 3])
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=45.0)
    scans = np.stack([
        sim.render_range_image(world, poses[i], sensor, max_range=60.0,
                               noise_std=0.01, seed=i)
        for i in range(N_SCANS)])
    imu_ts = np.arange(1, N_SCANS * 10 + 1) * 0.01
    imu = sim.imu_for_circle(imu_ts, radius=8.0, speed=2.0)
    batches = lio.build_batches(tiny_config(), scans, ts + 1e-9,
                                np.asarray(imu.lacc), np.asarray(imu.avel),
                                imu_ts, device="cpu")
    yield batches, convert.lut_from_numpy(sensor.lut, "cpu"), procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def jax_ref(scene):
    """{form: the JAX run's arrays}, each run's range images checked equal
    to the port's."""
    batches, _, procs = scene
    refs = {}
    for form, (proc, path) in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, (form, out[-3000:])
        refs[form] = dict(np.load(path))
        assert np.array_equal(refs[form]["range_m"], batches.range_m.numpy())
    return refs


def single(cfg, scene, log=False):
    batches, lut = scene[:2]
    return lio.run_sequence(lio.init_state(cfg, "cpu"), batches, lut,
                            cfg=cfg, log=log)[1]


def sharded_run(cfg, scene, n_pt, log=False, capture=True):
    """``run_sharded`` on CPU ranks with gloo: eagerly, or with
    ``capture=False`` the graph form's code without the capture."""
    batches, lut = scene[:2]
    run = sharded.run_sharded(lio.init_state(cfg, "cpu"), batches, lut, cfg,
                              devices=["cpu"] * n_pt, backend="gloo",
                              log=log, capture=capture)
    assert (run.backend, run.world_size) == ("gloo", n_pt)
    assert run.ranks_equal
    st = run.rank_stats[0]
    assert all(s["form"] == ("eager" if capture else "static")
               for s in run.rank_stats)
    iters = run.out.aux.iterations
    # one all-reduce a GN build; eagerly one read of "not converged" after
    # each build but the one at the iteration cap, none in the graph form
    assert st["allreduces"] == int(iters.sum())
    assert st["host_reads"] == (int(iters.sum()) - int(
        (iters == cfg.kiss.max_iterations).sum()) if capture else 0)
    assert all(s["allreduces"] == st["allreduces"] for s in run.rank_stats)
    return run


def pose_err(a, b) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return np.linalg.norm(np.asarray(a, np.float64)[:, :3, 3]
                          - np.asarray(b, np.float64)[:, :3, 3], axis=1)


@pytest.fixture(scope="module")
def port_runs(scene):
    cfg = tiny_config()
    return {n: sharded_run(cfg, scene, n) for n in (1, 2, 4)}


def form_config(form: str) -> config.PipelineConfig:
    """The configuration of one of ``JAX_FORMS``."""
    if form == "refresh":
        return tiny_config()
    return tiny_config(max_source=FROZEN_SOURCE, nn_refresh_drift=0.0,
                       fused_gather=form == "fused")


@pytest.fixture(scope="module")
def frozen_runs(scene):
    """The eager sharded runs of the frozen forms at world size 2."""
    return {form: sharded_run(form_config(form), scene, 2)
            for form in ("frozen", "fused")}


def test_world_size_one_matches_run_sequence(scene, port_runs):
    ref = single(tiny_config(), scene)
    run = port_runs[1]
    err = pose_err(run.out.kiss_pose, ref.kiss_pose)
    print(f"world size 1 against run_sequence: max {err.max():.3e} m")
    assert err.max() <= POSE_BAR_M
    assert torch.equal(run.out.aux.iterations, ref.aux.iterations)
    assert torch.equal(run.out.aux.num_corr, ref.aux.num_corr)


def check_close(out, poses, corr, what: str) -> None:
    """Every pose of ``out`` within ``POSE_BAR_M`` of ``poses``, every
    correspondence count within ``CORR_FRAC`` (+1) of ``corr``."""
    err = pose_err(out.kiss_pose, poses)
    print(f"{what}: max {err.max():.3e} m")
    assert err.max() <= POSE_BAR_M, (what, err)
    got = out.aux.num_corr.numpy()
    want = np.asarray(corr)
    assert np.all(np.abs(got - want) <= CORR_FRAC * want + 1), (
        what, got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_frozen_and_fused_forms(scene, jax_ref, frozen_runs, fused):
    """The frozen form at world size 2 (K3's twin or K6's once a scan,
    then the K5 loop) against JAX's sharded run of the same configuration
    and the port's single run, where the whole loop is K4's twin."""
    form = "fused" if fused else "frozen"
    cfg = form_config(form)
    ref = single(cfg, scene)
    run = frozen_runs[form]
    jref = jax_ref[form]
    check_close(run.out, jref["sharded"], jref["sharded_corr"],
                f"frozen fused={fused} against JAX's sharded run")
    check_close(run.out, ref.kiss_pose, ref.aux.num_corr,
                f"frozen fused={fused} against the port's single run")
    assert np.isfinite(run.out.ekf_pose.numpy()).all()
    assert int(run.out.aux.map_points[-1]) > 0


@pytest.mark.parametrize("form", JAX_FORMS)
def test_graph_form_matches_eager(scene, jax_ref, port_runs, frozen_runs,
                                  form):
    """The graph form's code at world size 2 with gloo (``capture=False``:
    the WHILE body with K5's twin and the all-reduce, the re-gather's IF
    body, as host loops): rows and final state bit-equal to the eager
    sharded run, the same GN iterations, all-reduces and re-gathers, the
    all-reduces counted where the card counts them (``graph.count`` in the
    body, one an iteration), no host read; within 0.02 m of JAX's sharded
    run."""
    eager = port_runs[2] if form == "refresh" else frozen_runs[form]
    run = sharded_run(form_config(form), scene, 2, capture=False)
    assert sharded._same_bits((run.out, run.state), (eager.out, eager.state))
    total = int(run.out.aux.iterations.sum())
    for st, ref in zip(run.rank_stats, eager.rank_stats):
        assert st["host_reads"] == 0
        for name in ("allreduces", "regathers"):
            assert st[name] == ref[name], (name, st[name], ref[name])
        cond = st["graph"]["cond"]
        assert cond["gn_iter"] == cond["allreduces"] == total
        assert cond.get("regathers", 0) == st["regathers"]
    jref = jax_ref[form]
    check_close(run.out, jref["sharded"], jref["sharded_corr"],
                f"{form} graph form against JAX's sharded run")


def test_log_history(scene, port_runs):
    run = sharded_run(tiny_config(), scene, 2, log=True)
    flog = run.out.flog
    assert flog is not None and flog.pos.shape == (N_SCANS, 16, 3)
    assert torch.equal(run.out.kiss_pose, port_runs[2].out.kiss_pose)
    assert torch.equal(run.out.ekf_pose, port_runs[2].out.ekf_pose)
    # the knot of each scan is its post-update filter state
    last = scene[0].imu_valid.sum(-1) - 1
    knots = flog.pos[torch.arange(N_SCANS), last]
    assert torch.equal(knots, run.out.ekf_pose[:, :3, 3])


@pytest.mark.parametrize("n_pt", [2, 4])
def test_matches_jax(scene, jax_ref, port_runs, n_pt):
    ref = jax_ref["refresh"]
    for name in ("sharded", "single"):
        check_close(port_runs[n_pt].out, ref[name], ref[f"{name}_corr"],
                    f"world size {n_pt} against JAX's {name} run")


def test_refuses_what_cannot_shard(scene):
    batches, lut = scene[:2]
    cfg = tiny_config()
    with pytest.raises(ValueError, match="not divisible by pt=3"):
        sharded.run_sharded(lio.init_state(cfg, "cpu"), batches, lut, cfg,
                            devices=["cpu"] * 3, backend="gloo")
    every = tiny_config(nn_mode="every")
    with pytest.raises(ValueError, match="nn_mode='cached'"):
        sharded.run_sharded(lio.init_state(every, "cpu"), batches, lut,
                            every, devices=["cpu"] * 2, backend="gloo")
    with pytest.raises(ValueError, match="nccl needs one card a rank"):
        sharded.run_sharded(lio.init_state(cfg, "cpu"), batches, lut, cfg,
                            devices=["cpu"] * 2, backend="nccl")
    with pytest.raises(ValueError, match="gloo group's step cannot be"):
        sharded.run_sharded(lio.init_state(cfg, "cpu"), batches, lut, cfg,
                            devices=["cpu"] * 2, backend="gloo", graph=True)


def test_wall_clock_limit(scene):
    """The ranks outlasting ``timeout`` (here before they have even
    joined the group) are killed and ``run_sharded`` raises: a captured
    collective that hung would have no timeout of its own."""
    batches, lut = scene[:2]
    cfg = tiny_config()
    with pytest.raises(TimeoutError, match="did not finish within"):
        sharded.run_sharded(lio.init_state(cfg, "cpu"), batches, lut, cfg,
                            devices=["cpu"] * 2, backend="gloo",
                            timeout=0.5)


def test_make_mesh_pt_axis():
    cpu = torch.device("cpu")
    devs = [torch.device("cpu", i) for i in range(4)]
    g = mesh.make_mesh(2, 2, devices=devs)
    assert g.shape == (2, 2)
    assert list(g[1]) == devs[2:] and list(g[:, 0]) == [devs[0], devs[2]]
    assert mesh.make_mesh(1, 4, devices=[cpu] * 4).shape == (1, 4)
    with pytest.raises(ValueError, match="2x2 != 3 devices"):
        mesh.make_mesh(2, 2, devices=[cpu] * 3)
