"""PyTorch port: ``viz``, ``ops.projection.destagger`` and the command
paths that use them, against the JAX package.

- ``destagger`` bit for bit against JAX's on shifts past the width and
  negative ones;
- ``save_ply`` / ``load_ply`` bytes (with and without colours) and
  ``AccumCloud`` through its point cap;
- ``map_to_points`` of a port map carried to JAX through a checkpoint;
- ``Flyby.camera_at`` over a sampled trajectory; ``sample_covariance``;
- every ``graphs`` function under the Agg backend: the same lines;
- ``export_debug_scenes`` on tests/test_debug_scene.py's 6-scan scene
  (the port on the CPU, its kernels' twins): the same file list, knot
  poses within 0.02 m (the sequence bar), the same correspondence counts;
- the command with ``--device cpu`` against the JAX command on
  tests/test_torch_cli.py's recording (``make_fixture.generate(n_scans=8,
  h=16, w=128, seed=7)``): ``ekf-bench ouster --save-map-ply
  --save-debug-scene`` (the same printed lines, the map's point count
  within 1 %, the scene as above), ``flyby --kitti-poses`` (PLY and camera
  program byte for byte), ``viz --out-png``, ``--out-dir`` and
  ``--stream-dir`` (every file byte for byte), ``cmp -p graphs
  --use-gt-frame --xy-plot`` and ``ekf-bench sim -p graphs`` (the same
  plotted lines).
"""
import filecmp
import json
import os
import sys

import matplotlib
import numpy as np
import pytest
import torch
from click.testing import CliRunner

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from ptudes_tpu.cli.main import ptudes_cli  # noqa: E402
from ptudes_tpu.config import (Capacity as JCapacity,  # noqa: E402
                               EkfConfig as JEkfConfig,
                               KissConfig as JKissConfig,
                               PipelineConfig as JPipelineConfig)
from ptudes_tpu.models import lio as jlio  # noqa: E402
from ptudes_tpu.ops import projection as jprojection  # noqa: E402
from ptudes_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from ptudes_tpu.viz import cloud as jcloud  # noqa: E402
from ptudes_tpu.viz import debug_scene as jdebug  # noqa: E402
from ptudes_tpu.viz import fly as jfly  # noqa: E402
from ptudes_tpu.viz import graphs as jgraphs  # noqa: E402
from ptudes_tpu_torch import config  # noqa: E402
from ptudes_tpu_torch.cli import main as pcli  # noqa: E402
from ptudes_tpu_torch.models import lio, sim  # noqa: E402
from ptudes_tpu_torch.models.esekf import FilterLog  # noqa: E402
from ptudes_tpu_torch.ops import projection  # noqa: E402
from ptudes_tpu_torch.utils import checkpoint, convert  # noqa: E402
from ptudes_tpu_torch.viz import cloud, debug_scene, fly, graphs  # noqa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_BAR_M = 0.02
SMALL_CAPS = ["--map-capacity", str(1 << 14), "--max-source", "2048",
              "--max-frame", "4096", "--voxel-size", "0.4",
              "--kiss-max-range", "60"]


def lines_of(fig) -> list[np.ndarray]:
    """Every line a figure plots, as [K, 2] arrays, axis by axis."""
    return [np.asarray(ln.get_xydata()) for ax in fig.axes
            for ln in ax.get_lines()]


def same_lines(a, b, atol=0.0) -> None:
    la, lb = lines_of(a), lines_of(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=atol, rtol=0)


def test_destagger_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 100, (16, 64)).astype(np.float32)
    shifts = rng.integers(-70, 140, 16)
    got = projection.destagger(torch.from_numpy(img), shifts)
    want = jprojection.destagger(jnp.asarray(img), jnp.asarray(shifts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # trailing channels roll with their pixel
    img3 = rng.uniform(size=(16, 64, 3)).astype(np.float32)
    got3 = projection.destagger(torch.from_numpy(img3), shifts)
    for c in range(3):
        np.testing.assert_array_equal(got3[..., c].numpy(), np.asarray(
            jprojection.destagger(jnp.asarray(img3[..., c]),
                                  jnp.asarray(shifts))))


def test_ply_and_accum_cloud(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3))
    rgb = rng.integers(0, 255, (300, 3))
    for colors in (None, rgb):
        a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
        cloud.save_ply(a, pts, colors)
        jcloud.save_ply(b, pts, colors)
        assert filecmp.cmp(a, b, shallow=False)
        np.testing.assert_array_equal(cloud.load_ply(a), jcloud.load_ply(a))
    mine, theirs = cloud.AccumCloud(max_points=2500, seed=4), \
        jcloud.AccumCloud(max_points=2500, seed=4)
    for i in range(12):
        chunk = rng.normal(size=(400, 3)).astype(np.float32)
        keys = None if i % 2 else rng.uniform(size=400).astype(np.float32)
        mine.add(chunk, keys)
        theirs.add(chunk, keys)
    assert len(mine) == len(theirs) == 2500 and mine.ratio < 1.0
    assert mine.ratio == theirs.ratio
    np.testing.assert_array_equal(mine.points, theirs.points)
    np.testing.assert_array_equal(mine.keys, theirs.keys)


def test_flyby_camera_and_sample_covariance():
    ts = np.linspace(0.0, 6.0, 61)
    poses = sim.circle_poses_at(ts, radius=8.0, speed=2.0, ramp=1.0)
    traj = [(t, p) for t, p in zip(ts, poses)]
    bbox = np.array([[-20.0, 20.0], [-15.0, 18.0], [-2.0, 6.0]])
    mine, theirs = fly.Flyby(traj=traj, bbox=bbox), \
        jfly.Flyby(traj=traj, bbox=bbox)
    assert mine.total_duration == theirs.total_duration
    for t in np.linspace(0.0, 1.3 * mine.total_duration, 97):
        a, b = mine.camera_at(float(t)), theirs.camera_at(float(t))
        assert mine.phase_at(float(t)).name == theirs.phase_at(float(t)).name
        np.testing.assert_array_equal(a.target, b.target)
        assert (a.pitch, a.yaw, a.dolly) == (b.pitch, b.yaw, b.dolly)
    cov = np.diag(np.linspace(1e-4, 2e-2, 18))
    args = (np.array([1.0, -2.0, 0.5]), cov, poses[7][:3, :3])
    for got, want in zip(debug_scene.sample_covariance(*args, seed=5),
                         jdebug.sample_covariance(*args, seed=5)):
        np.testing.assert_array_equal(got, want)


def test_graphs_match_jax():
    rng = np.random.default_rng(1)
    n = 120
    q = rng.normal(size=(n, 4))
    log = FilterLog(
        ts=np.cumsum(np.full(n, 0.01)) + 3.0, pos=rng.normal(size=(n, 3)),
        vel=rng.normal(size=(n, 3)), att_q=q / np.linalg.norm(q, axis=1,
                                                               keepdims=True),
        bias_gyr=rng.normal(size=(n, 3)), bias_acc=rng.normal(size=(n, 3)),
        grav=rng.normal(size=(n, 3)), cov_diag=rng.uniform(size=(n, 18)),
        updated=rng.uniform(size=n) < 0.1)
    log_gt = log._replace(pos=log.pos + 0.01, att_q=log.att_q[::-1])
    lacc, avel = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    gt = (log.ts[::10], np.tile(np.eye(4), (12, 1, 1)))
    for xy in (False, True):
        kw = dict(imu_lacc=lacc, imu_avel=avel, gt=gt, gt2=gt, xy_plot=xy,
                  labels=["a", "b", "c"], show=False)
        same_lines(graphs.ekf_graphs(log, **kw),
                   jgraphs.ekf_graphs(log, **kw))
        sets = [[(t, p) for t, p in zip(*gt)]] * 2
        same_lines(graphs.gt_poses_graphs(sets, xy_plot=xy, show=False),
                   jgraphs.gt_poses_graphs(sets, xy_plot=xy, show=False))
    same_lines(graphs.ekf_error_graphs(log_gt, log, show=False),
               jgraphs.ekf_error_graphs(log_gt, log, show=False))
    same_lines(graphs.kiss_innovation_graph(log.ts, lacc[:, 0], lacc[:, 1],
                                            lacc[:, 2], show=False),
               jgraphs.kiss_innovation_graph(log.ts, lacc[:, 0], lacc[:, 1],
                                             lacc[:, 2], show=False))
    plt.close("all")


# ------------------------------------------- the debug scene and the map

N_DBG = 6


def debug_scene_inputs():
    """tests/test_debug_scene.py's scene and configuration (both
    packages'), rendered by the port's numpy sim."""
    ts, _ = sim.circle_trajectory(N_DBG + 1, radius=8.0, speed=2.0,
                                  scan_dt=0.1, ramp=1.0)
    sweep = sim.circle_poses_at(ts, radius=8.0, speed=2.0, ramp=1.0)
    world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=20,
                               keepout_points=sweep[:, :3, 3])
    sensor = sim.make_sim_sensor(h=32, w=128, fov_deg=45.0)
    scans = np.stack([
        sim.render_range_image(world, sweep[i], sensor, max_range=60.0,
                               noise_std=0.01, seed=i, end_pose=sweep[i + 1])
        for i in range(N_DBG)])
    imu_ts = np.arange(1, N_DBG * 10 + 2) * 0.01
    imu = sim.imu_for_circle(imu_ts, radius=8.0, speed=2.0, ramp=1.0)
    kiss = dict(max_range=30.0, min_range=1.0, max_points_per_voxel=8,
                max_iterations=20, deskew=True, loss="plane", voxel_size=0.3,
                plane_fit_radius=0.6)
    cap = dict(max_points=32 * 128, max_frame=4096, max_source=2048,
               map_capacity=1 << 15, dedup_table=1 << 16,
               max_new_per_scan=4096)
    jcfg = JPipelineConfig(kiss=JKissConfig(**kiss), cap=JCapacity(**cap),
                           ekf=JEkfConfig(), max_imu_per_scan=16,
                           guess="ekf")
    cfg = config.PipelineConfig(
        kiss=config.KissConfig(icp_form="cuda", **kiss),
        cap=config.Capacity(**cap), ekf=config.EkfConfig(),
        max_imu_per_scan=16, guess="ekf")
    args = (scans, ts[:N_DBG] + 0.1, np.asarray(imu.lacc),
            np.asarray(imu.avel), imu_ts)
    return sensor, cfg, jcfg, args


def same_scenes(mine: str, theirs: str) -> list[dict]:
    """The two scene directories hold the same files, the same index, knot
    poses within the bar and the same correspondence counts."""
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    with open(os.path.join(mine, "scene.json")) as f, \
            open(os.path.join(theirs, "scene.json")) as g:
        index = json.load(f)
        assert index == json.load(g)
    metas = []
    for k in index["knots"]:
        name = f"knot_{k:04d}.json"
        with open(os.path.join(mine, name)) as f, \
                open(os.path.join(theirs, name)) as g:
            a, b = json.load(f), json.load(g)
        for key in ("pred_pose", "icp_pose", "ekf_pose"):
            err = np.abs(np.asarray(a[key]) - np.asarray(b[key]))[:3, 3]
            assert err.max() <= POSE_BAR_M, (name, key, err)
        assert (a["num_corr"], a["iterations"], a["scan_valid"]) == (
            b["num_corr"], b["iterations"], b["scan_valid"]), (a, b)
        src = cloud.load_ply(os.path.join(mine, f"knot_{k:04d}_source.ply"))
        assert len(src) == a["num_corr"]
        metas.append(a)
    return metas


def test_debug_scene_and_map_match_jax(tmp_path):
    sensor, cfg, jcfg, args = debug_scene_inputs()
    batches = lio.build_batches(cfg, *args, device="cpu")
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(stride=2, map_stride=4, n_pos_samples=500, n_att_samples=20)
    idx = debug_scene.export_debug_scenes(mine, cfg, lut, batches, **kw)
    assert idx["knots"] == [0, 2, 4]
    jdebug.export_debug_scenes(theirs, jcfg, sensor.lut,
                               jlio.build_batches(jcfg, *args), **kw)
    metas = same_scenes(mine, theirs)
    assert metas[1]["num_corr"] > 100

    # map_to_points of the port's map, and of the same map carried to JAX
    fin, _ = lio.run_sequence(lio.init_state(cfg, "cpu"), batches, lut,
                              cfg=cfg)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, fin)
    jfin = jcheckpoint.load_state(path, jlio.init_state(jcfg))
    got = cloud.map_to_points(fin.kiss.local_map, 0.3)
    assert len(got) == int(fin.kiss.local_map.meta[:, 1].sum()) > 1000
    np.testing.assert_array_equal(
        got, jcloud.map_to_points(jfin.kiss.local_map, 0.3))


# ------------------------------------------------------- the command

@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_fixture import generate
    d = tmp_path_factory.mktemp("vizfix")
    pcap, meta, gt = generate(str(d), n_scans=8, h=16, w=128, seed=7)
    return d, pcap, meta, gt


def jax_cli(args) -> str:
    r = CliRunner().invoke(ptudes_cli, args, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def port_cli(capsys, args):
    capsys.readouterr()
    res = pcli.run(args)
    return res, capsys.readouterr().out


@pytest.fixture(scope="module")
def ouster_runs(rec, tmp_path_factory):
    """The JAX command's and the port's ``ekf-bench ouster`` with every
    export (one run each): (directory, JAX output, port output, port
    results)."""
    import contextlib
    import io
    d, pcap, meta, gt = rec
    out = tmp_path_factory.mktemp("ouster")
    runs = {}
    for who in ("jax", "port"):
        args = ["ekf-bench", "ouster", pcap, "-m", meta,
                "--use-imu-prediction", "-g", gt,
                "--save-kitti-poses", str(out / f"{who}_kitti.txt"),
                "--save-nc-gt-poses", str(out / f"{who}_nc.csv"),
                "--save-map-ply", str(out / f"{who}_map.ply"),
                "--save-debug-scene", str(out / f"{who}_scene"),
                "--debug-scene-stride", "3"] + SMALL_CAPS
        if who == "jax":
            runs[who] = (jax_cli(args), None)
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = pcli.run(args + ["--device", "cpu"])
            runs[who] = (buf.getvalue(), res)
    return out, runs


def test_ouster_exports_match_jax(ouster_runs):
    out, runs = ouster_runs
    (jout, _), (pout, res) = runs["jax"], runs["port"]

    keep = lambda s: [ln for ln in s.splitlines()  # noqa: E731
                      if not ln.startswith(("Timings", "  per scan"))]
    assert [ln.replace("port_", "jax_") for ln in keep(pout)] == keep(jout)
    assert "Local map saved to:" in pout and "Debug scenes (3 knots)" in pout
    jp = np.loadtxt(out / "jax_kitti.txt").reshape(-1, 3, 4)
    pp = np.loadtxt(out / "port_kitti.txt").reshape(-1, 3, 4)
    assert np.abs(jp[:, :, 3] - pp[:, :, 3]).max() <= POSE_BAR_M
    jm, pm = cloud.load_ply(out / "jax_map.ply"), \
        cloud.load_ply(out / "port_map.ply")
    assert len(pm) == int(res["state"].kiss.local_map.meta[:, 1].sum())
    assert abs(len(pm) - len(jm)) <= 0.01 * len(jm) and len(jm) > 1000
    np.testing.assert_array_equal(pm, cloud.map_to_points(
        res["state"].kiss.local_map, 0.4))
    assert res["debug_scene"]["knots"] == [0, 3, 6]
    same_scenes(str(out / "port_scene"), str(out / "jax_scene"))


def test_flyby_matches_jax(rec, ouster_runs, capsys):
    d, pcap, meta, gt = rec
    out, _ = ouster_runs
    files = {}
    for who in ("jax", "port"):
        args = ["flyby", pcap, "-m", meta, "--kitti-poses",
                str(out / "jax_kitti.txt"), "-o", str(out / f"fly_{who}.ply"),
                "--camera-json", str(out / f"cam_{who}.json"),
                "--map-points", "6000"]
        files[who] = (jax_cli(args) if who == "jax" else
                      port_cli(capsys, args + ["--device", "cpu"])[1])
    assert files["port"].replace("port", "jax") == files["jax"]
    assert filecmp.cmp(out / "fly_jax.ply", out / "fly_port.ply",
                       shallow=False)
    assert filecmp.cmp(out / "cam_jax.json", out / "cam_port.json",
                       shallow=False)
    pts = cloud.load_ply(out / "fly_port.ply")
    assert len(pts) > 1000 and np.isfinite(pts).all()


def _tree(d) -> dict[str, bytes]:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_viz_matches_jax(rec, tmp_path, capsys):
    d, pcap, meta, gt = rec
    printed = {}
    for who in ("jax", "port"):
        w = tmp_path / who
        w.mkdir()
        flag_sets = [["--out-png", str(w / "one.png"), "--scan", "3"],
                     ["--out-dir", str(w / "frames"), "--stride", "3",
                      "--field", "reflectivity"],
                     ["--stream-dir", str(w / "stream"), "-r", "0.5",
                      "--max-scans", "5"]]
        printed[who] = [
            (jax_cli(["viz", pcap, "-m", meta] + f) if who == "jax" else
             port_cli(capsys, ["viz", pcap, "-m", meta, "--device", "cpu"]
                      + f)[1]).replace(str(w), "W")
            for f in flag_sets]
        plt.close("all")
    assert printed["port"] == printed["jax"]
    assert "exported 3 frames" in printed["port"][1]
    jw, pw = tmp_path / "jax", tmp_path / "port"
    assert _tree(pw / "frames") == _tree(jw / "frames")
    assert _tree(pw / "stream") == _tree(jw / "stream")
    assert open(pw / "one.png", "rb").read() == \
        open(jw / "one.png", "rb").read()
    with open(pw / "stream" / "stream.json") as f:
        s = json.load(f)
    assert (s["n"], s["rate"]) == (5, 0.5) and "reflectivity" in s["fields"]


def test_cmp_and_sim_plots_match_jax(rec, ouster_runs, capsys):
    d, pcap, meta, gt = rec
    out, _ = ouster_runs
    args = ["ekf-bench", "cmp", gt, str(out / "jax_nc.csv"),
            str(out / "port_nc.csv"), "-p", "graphs", "--use-gt-frame",
            "--xy-plot"]
    plt.close("all")
    jout = jax_cli(args)
    jfig = plt.gcf()
    res, pout = port_cli(capsys, args)
    assert pout == jout
    same_lines(res[-1]["figure"], jfig)
    sets = res[-1]["pose_sets"]
    assert len(sets) == 3
    # with --use-gt-frame each compared trajectory starts on the ground
    # truth's first matched pose
    np.testing.assert_allclose(sets[1][0][1], sets[0][0][1], atol=1e-9)

    args = ["ekf-bench", "sim", "-t", "0.5", "-p", "graphs"]
    plt.close("all")
    jout = jax_cli(args)
    jfigs = [plt.figure(n) for n in plt.get_fignums()]
    res, pout = port_cli(capsys, args + ["--device", "cpu"])
    assert pout == jout
    assert len(res["figures"]) == len(jfigs) == 2
    for mine, theirs in zip(res["figures"], jfigs):
        same_lines(mine, theirs, atol=1e-3)
    plt.close("all")
