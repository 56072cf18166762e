"""PyTorch port: the command line (``ptudes_tpu_torch.cli.main``) with
``--device cpu`` against the JAX command (``ptudes_tpu.cli.main``) on the
same recording.

The recording is tests/test_cli.py's: ``tools/make_fixture.generate(
n_scans=8, h=16, w=128, seed=7)``, a LEGACY pcap with IP-fragmented lidar
packets, epoch timestamps, its metadata and a Newer College ground truth.
``ekf-bench ouster`` runs at tests/test_cli.py's small capacities. Each
JAX configuration runs once:

- ``stat``: the same printed statistics, with and without the scan window,
  duration and beam flags; ``--kiss-run`` runs the port's KISS loop;
- ``ekf-bench ouster --use-imu-prediction -g``: the saved KITTI poses
  within 0.02 m of JAX's and the printed ATE within 0.005 m; the port's
  ``--online`` run against the same JAX run, and bit-equal to the port's
  batch run; ``--loss point`` against JAX's;
- ``build_config`` field by field against the configuration the JAX
  command builds (captured by replacing ``ptudes_tpu.models.lio.
  run_sequence`` in the test), for seven flag sets, apart from the kernel
  forms;
- ``ekf-bench sim``, ``nc`` (on a ROS1 bag of the recording's IMU packets
  and its ground truth) and ``cmp``: the same printed numbers.

Save, resume and the frozen map are in tests/test_torch_cli_state.py.
"""
import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from ptudes_tpu.cli.main import ptudes_cli
from ptudes_tpu_torch.cli import main as pcli
from ptudes_tpu_torch.io import metadata

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCANS, H, W = 8, 16, 128
SMALL_CAPS = ["--map-capacity", str(1 << 14), "--max-source", "2048",
              "--max-frame", "4096", "--voxel-size", "0.4",
              "--kiss-max-range", "60"]
POSE_BAR_M = 0.02
ATE_BAR_M = 0.005
ATE = re.compile(r"ATE RMSE:\s+(\S+) deg / (\S+) m")


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_fixture import generate
    d = tmp_path_factory.mktemp("clifix")
    pcap, meta, gt = generate(str(d), n_scans=N_SCANS, h=H, w=W, seed=7)
    return d, pcap, meta, gt


def jax_cli(args) -> str:
    r = CliRunner().invoke(ptudes_cli, args, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def port_cli(capsys, args):
    """(the command's results, its printed output)."""
    capsys.readouterr()
    res = pcli.run(args + (["--device", "cpu"] if args[0] != "ekf-bench"
                           or args[1] != "cmp" else []))
    return res, capsys.readouterr().out


def numbers(text: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", text)]


@pytest.mark.parametrize("flags", [
    [], ["--start-scan", "2", "--end-scan", "5"], ["-t", "0.45"],
    ["--beams", "4", "--start-scan", "3"]])
def test_stat(rec, capsys, flags):
    d, pcap, meta, gt = rec
    want = jax_cli(["stat", pcap, "-m", meta] + flags)
    _, got = port_cli(capsys, ["stat", pcap, "-m", meta] + flags)
    assert got == want
    assert "scans:" in got and "Grav vector est" in got


def test_stat_kiss_run_and_window_errors(rec, capsys):
    d, pcap, meta, gt = rec
    res, out = port_cli(capsys, ["stat", pcap, "-m", meta, "--kiss-run"])
    assert f"KISS run: {N_SCANS} scans" in out
    kp = res["kiss_poses"]
    assert kp.shape == (N_SCANS, 4, 4) and np.isfinite(kp).all()
    assert pcli.main(["stat", pcap, "-m", meta, "--start-scan", "99",
                      "--device", "cpu"]) == 2
    assert "selects no scans" in capsys.readouterr().err


@pytest.fixture(scope="module")
def jax_ouster(rec):
    """The JAX command's batch run with the IMU prediction (one run)."""
    d, pcap, meta, gt = rec
    k = str(d / "jax_kitti.txt")
    out = jax_cli(["ekf-bench", "ouster", pcap, "-m", meta,
                   "--use-imu-prediction", "-g", gt, "--save-kitti-poses",
                   k] + SMALL_CAPS)
    return np.loadtxt(k).reshape(-1, 3, 4), out


def _check_against(kitti_path, out, jposes, jout):
    p = np.loadtxt(kitti_path).reshape(-1, 3, 4)
    assert p.shape == (N_SCANS, 3, 4) and np.isfinite(p).all()
    err = np.linalg.norm(p[:, :, 3] - jposes[:, :, 3], axis=1)
    assert err.max() <= POSE_BAR_M, err
    got, want = ATE.findall(out), ATE.findall(jout)
    assert len(got) == len(want) == 2
    for (_, a), (_, b) in zip(got, want):
        assert abs(float(a) - float(b)) <= ATE_BAR_M, (a, b)


def test_ouster_batch_and_online(rec, capsys, jax_ouster):
    d, pcap, meta, gt = rec
    jposes, jout = jax_ouster
    base = ["ekf-bench", "ouster", pcap, "-m", meta, "--use-imu-prediction",
            "-g", gt] + SMALL_CAPS
    k = str(d / "port_kitti.txt")
    res, out = port_cli(capsys, base + ["--save-kitti-poses", k])
    _check_against(k, out, jposes, jout)
    # the printed lines the timings do not change are the JAX command's
    strip = lambda s: [ln for ln in s.splitlines()  # noqa: E731
                       if not ln.startswith(("Timings", "  per scan"))
                       and "saved to" not in ln]
    assert strip(out) == strip(jout)
    assert res["cfg"].ekf.predict_batch == "unroll"

    ko = str(d / "port_online.txt")
    res_o, out_o = port_cli(capsys, base + ["--online",
                                            "--save-kitti-poses", ko])
    _check_against(ko, out_o, jposes, jout)
    assert "per-scan latency: p50" in out_o and "p99" in out_o
    assert "dropped IMU samples: 0" in out_o
    assert len(res_o["latencies_s"]) == N_SCANS
    # scan by scan, the same steps as the batch run: bit for bit
    np.testing.assert_array_equal(res_o["ekf_poses"], res["ekf_poses"])
    np.testing.assert_array_equal(res_o["kiss_poses"], res["kiss_poses"])


def test_ouster_point_loss(rec, capsys):
    d, pcap, meta, gt = rec
    args = ["ekf-bench", "ouster", pcap, "-m", meta, "--use-imu-prediction",
            "-g", gt, "--loss", "point"] + SMALL_CAPS
    jk, k = str(d / "jax_point.txt"), str(d / "port_point.txt")
    jout = jax_cli(args + ["--save-kitti-poses", jk])
    res, out = port_cli(capsys, args + ["--save-kitti-poses", k])
    assert res["cfg"].kiss.loss == "point" and "loss: point" in out
    _check_against(k, out, np.loadtxt(jk).reshape(-1, 3, 4), jout)


FLAG_SETS = [
    ["--use-imu-prediction"],
    ["--use-gt-guess", "-g", "GT"],
    [],
    ["--use-imu-prediction", "--loss", "point", "--kiss-min-range", "2",
     "--kiss-max-range", "50", "--voxel-size", "0.5", "--beams", "8"],
    ["--use-imu-prediction"] + SMALL_CAPS,
    ["--max-frame", "40000", "--max-source", "4096"],
    ["--map-capacity", str(1 << 16), "--max-frame", "1024", "--end-scan",
     "5"],
]
FORMS = {"cpu": ("torch", "unroll", "xla"), "cuda": ("cuda", "cuda", "xla")}


class _Captured(Exception):
    pass


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_build_config_matches_the_jax_command(rec, monkeypatch, flags):
    """The configuration of ``ekf-bench ouster`` with ``flags``: the JAX
    command's (captured where it calls ``lio.run_sequence``) field by
    field, apart from the kernel forms and the JAX-only knobs; the forms
    are the card's with ``--device cuda`` and the twins' on the CPU."""
    import ptudes_tpu.models.lio as jlio
    d, pcap, meta, gt = rec
    flags = [gt if f == "GT" else f for f in flags]
    seen = []

    def capture(state, batches, lut, *, cfg, **kw):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jlio, "run_sequence", capture)
    r = CliRunner().invoke(ptudes_cli, ["ekf-bench", "ouster", pcap, "-m",
                                        meta] + flags)
    assert isinstance(r.exception, _Captured), r.output
    j = seen[0]
    info = metadata.read_metadata_json(meta)
    for device, forms in FORMS.items():
        args = pcli.build_parser().parse_args(
            ["ekf-bench", "ouster", pcap, "-m", meta, "--device", device]
            + flags)
        p = pcli.build_config(args, info)
        assert (p.kiss.icp_form, p.ekf.predict_batch,
                p.ekf.update_form) == forms
        for part in ("kiss", "cap", "ekf"):
            a = dataclasses.asdict(getattr(p, part))
            b = dataclasses.asdict(getattr(j, part))
            for key in ("icp_form", "predict_batch", "update_form",
                        "gn_backend", "gn_unroll"):
                a.pop(key, None)
                b.pop(key, None)
            assert a == b, (part, flags)
        a = {k: v for k, v in dataclasses.asdict(p).items()
             if k not in ("kiss", "cap", "ekf")}
        b = {k: v for k, v in dataclasses.asdict(j).items()
             if k not in ("kiss", "cap", "ekf", "scan_unroll")}
        assert a == b, flags


def test_ekf_bench_sim(capsys):
    args = ["ekf-bench", "sim", "--duration", "2.0", "--corr-t", "0.5"]
    want = jax_cli(args)
    res, got = port_cli(capsys, args)
    assert res["updates"] == 3 and "ATE RMSE" in got
    assert got.splitlines()[:3] == want.splitlines()[:3]
    np.testing.assert_allclose(numbers(got), numbers(want), rtol=0,
                               atol=2e-4)


def _imu_bag(rec):
    """The recording's IMU packets as a ROS1 bag on /os_node/imu_packets."""
    from ptudes_tpu_torch.io import packets, pcap, rosbag
    d, rec_path, meta, gt = rec
    path = str(d / "imu.bag")
    if not os.path.exists(path):
        st = dict(pcap.read_pcap_udp(rec_path))[packets.IMU_PACKET_SIZE]
        rosbag.write_simple_bag(path, [
            ("/os_node/imu_packets", "ouster_ros/msg/PacketMsg",
             rosbag.OUSTER_PACKETMSG_MD5, int(t * 1e9),
             np.uint32(len(p)).tobytes() + p.tobytes())
            for t, p in zip(st.ts, st.payloads)])
    return path


@pytest.mark.parametrize("flags", [[], ["--start-ts", "0.2", "-t", "0.4"]])
def test_ekf_bench_nc(rec, capsys, flags):
    d, pcap, meta, gt = rec
    args = ["ekf-bench", "nc", _imu_bag(rec), "-g", gt] + flags
    want = jax_cli(args)
    res, got = port_cli(capsys, args)
    assert res["updates"] > 0 and "ATE trans" in got
    assert got.splitlines()[:4] == want.splitlines()[:4]
    np.testing.assert_allclose(numbers(got), numbers(want), rtol=0,
                               atol=2e-4)


def test_ekf_bench_cmp(rec, capsys):
    """Two trajectories against the ground truth: the port's saved NC
    poses and a copy of the ground truth shifted in time."""
    d, pcap, meta, gt = rec
    nc = str(d / "port_nc.csv")
    port_cli(capsys, ["ekf-bench", "ouster", pcap, "-m", meta,
                      "--use-imu-prediction", "--save-nc-gt-poses", nc]
             + SMALL_CAPS)
    from ptudes_tpu_torch.io import poses
    shifted = str(d / "shifted.csv")
    g = poses.read_newer_college_gt(gt)
    poses.save_poses_nc_gt_format(
        shifted, np.asarray([t for t, _ in g]) + 0.03,
        np.asarray([p for _, p in g]))
    args = ["ekf-bench", "cmp", gt, nc, shifted]
    want = jax_cli(args)
    _, got = port_cli(capsys, args)
    assert got == want and got.count("ATE trans") == 2


def test_device_defaults_to_the_card(rec, capsys):
    """Without ``--device`` the commands run on the card; with no card
    they raise instead of running on the CPU. Usage errors exit 2."""
    d, pcap, meta, gt = rec
    if not torch.cuda.is_available():
        for args in (["ekf-bench", "ouster", pcap, "-m", meta],
                     ["ekf-bench", "sim"],
                     ["stat", pcap, "-m", meta, "--kiss-run"],
                     ["ekf-bench", "nc", _imu_bag(rec), "-g", gt]):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                pcli.run(args)
    assert pcli.main(["ekf-bench", "ouster", pcap, "-m", meta,
                      "--frozen-map", "--device", "cpu"]) == 2
    assert "resume-state" in capsys.readouterr().err
    assert pcli.main(["ekf-bench", "ouster", pcap, "-m", meta,
                      "--use-gt-guess", "--device", "cpu"]) == 2
    assert "--gt-file" in capsys.readouterr().err
    assert pcli.main(["stat", str(d / "missing.pcap")]) == 2
