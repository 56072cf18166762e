"""PyTorch port: the recording readers and writers against the JAX
package's, bit for bit on the same bytes.

``ptudes_tpu_torch.io`` and ``native`` are copies of ``ptudes_tpu.io`` and
``ptudes_tpu.native`` (the port imports nothing of the JAX package). Each
reader runs on the same files or packets in both packages: the
IP-fragmented LEGACY pcap of ``tools/make_fixture.py``, eUDP RNG19, RNG15,
DUAL and FUSA packets, IMU packets, ROS1 bags (uncompressed, bz2, lz4) and
a ROS2 bag, metadata, KITTI and Newer College pose files, the trajectory
and stream-statistics helpers and the projection LUT. The port's native
decoder is held against its numpy decoder, and
``tools/make_torch_fixture.py``'s recordings against the same writer over
``ptudes_tpu.io`` and against ``tools/make_fixture.py``.
"""
import contextlib
import dataclasses
import filecmp
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from ptudes_tpu.io import metadata as jmeta
from ptudes_tpu.io import packets as jpkt
from ptudes_tpu.io import pcap as jpcap
from ptudes_tpu.io import poses as jposes
from ptudes_tpu.io import rosbag as jbag
from ptudes_tpu.io import rosbag2 as jbag2
from ptudes_tpu.io import sources as jsources
from ptudes_tpu.ops import projection as jproj
from ptudes_tpu.utils import stats as jstats
from ptudes_tpu.utils import trajectory as jtraj
from ptudes_tpu_torch import native
from ptudes_tpu_torch.io import metadata, packets, pcap, poses, rosbag, \
    rosbag2, sources
from ptudes_tpu_torch.ops import projection
from ptudes_tpu_torch.utils import stats, trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import make_fixture  # noqa: E402
import make_torch_fixture  # noqa: E402

N_SCANS, H, W = 8, 16, 128
JAX_IO = types.SimpleNamespace(metadata=jmeta, packets=jpkt, pcap=jpcap,
                               poses=jposes)


def same(a, b, where="") -> None:
    """``a`` and ``b`` equal bit for bit: arrays (dtype, shape, values),
    dataclasses and named tuples field by field, dicts, lists, scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """``tools/make_fixture.generate(n_scans=8, h=16, w=128, seed=7)``."""
    d = tmp_path_factory.mktemp("rec")
    return d, *make_fixture.generate(str(d), n_scans=N_SCANS, h=H, w=W,
                                     seed=7)


def _info(pkg_meta, h=H, w=W, profile="LEGACY"):
    return pkg_meta.SensorInfo(
        prod_line=f"OS-0-{h}", mode=f"{w}x10", columns_per_frame=w,
        pixels_per_column=h, columns_per_packet=16,
        pixel_shift_by_row=[0] * h, udp_profile_lidar=profile,
        beam_altitude_angles=np.linspace(20, -20, h),
        beam_azimuth_angles=np.zeros(h),
        lidar_origin_to_beam_origin_mm=15.806,
        lidar_to_sensor_transform=np.eye(4),
        imu_to_sensor_transform=np.eye(4), extrinsic=np.eye(4))


def test_fragmented_legacy_pcap(recording):
    """The fixture pcap (lidar packets IP-fragmented at MTU 1500, IMU
    packets whole) decodes to the same streams, scans and IMU."""
    d, rec, meta, gt = recording
    same(pcap.read_pcap_udp(rec), jpcap.read_pcap_udp(rec), "streams")
    info, jinfo = metadata.read_metadata_json(meta), \
        jmeta.read_metadata_json(meta)
    same(info, jinfo, "info")
    for keep in (False, True):
        got = sources.read_packet_source(rec, info, keep_fields=keep)
        want = jsources.read_packet_source(rec, jinfo, keep_fields=keep)
        same(got, want, f"pcap keep_fields={keep}")
    scans, imu = got
    assert scans.range_mm.shape == (N_SCANS, H, W) and len(imu) == 80
    same(scans.window(2, 5), want[0].window(2, 5), "window")


@pytest.mark.parametrize("profile", ["RNG19_RFL8_SIG16_NIR16",
                                     "RNG15_RFL8_NIR8",
                                     "RNG19_RFL8_SIG16_NIR16_DUAL",
                                     "FUSA_RNG15_RFL8_NIR8_DUAL"])
def test_eudp_packets(profile):
    """The eUDP writers write the same bytes; the parsers (native and
    numpy) and the scan assembly with every field agree."""
    rng = np.random.default_rng(3)
    info, jinfo = _info(metadata, 16, 32, profile), \
        _info(jmeta, 16, 32, profile)
    cpp = info.columns_per_packet
    bufs = []
    for frame in range(2):
        for p in range(2):
            ts = (np.arange(cpp) + 100 + p * cpp
                  + frame * 1000).astype(np.uint64)
            mids = (np.arange(cpp) + p * cpp).astype(np.uint16)
            kw = dict(
                reflectivity=rng.integers(0, 255, (cpp, 16)).astype(
                    np.uint16),
                signal=rng.integers(0, 65535, (cpp, 16)).astype(np.uint16),
                nir=rng.integers(0, 255, (cpp, 16)).astype(np.uint16),
                range2_mm=rng.integers(0, 2**15, (cpp, 16)).astype(
                    np.uint32) * 8,
                reflectivity2=rng.integers(0, 255, (cpp, 16)).astype(
                    np.uint16),
                signal2=rng.integers(0, 65535, (cpp, 16)).astype(np.uint16))
            r1 = rng.integers(0, 2**15, (cpp, 16)).astype(np.uint32) * 8
            b = packets.make_eudp_packet(info, ts, mids, 9 + frame, r1, **kw)
            assert b == jpkt.make_eudp_packet(jinfo, ts, mids, 9 + frame,
                                              r1, **kw)
            bufs.append(b)
    arr = np.stack([np.frombuffer(b, np.uint8) for b in bufs])
    assert arr.shape[1] == packets.lidar_packet_size(info)
    cols = packets.parse_lidar_packets(info, arr)
    assert native.backend() == "native"
    with native.numpy_only():
        np_cols = packets.parse_lidar_packets(info, arr)
        assert native.backend() == "numpy"
        same(np_cols, jpkt.parse_lidar_packets(jinfo, arr), "numpy decode")
    same(cols, np_cols, "native vs numpy")
    same(sources.assemble_scans(info, cols, keep_fields=True),
         jsources.assemble_scans(jinfo, jpkt.parse_lidar_packets(jinfo, arr),
                                 keep_fields=True), "assembly")


def test_imu_packets():
    rng = np.random.default_rng(4)
    bufs = []
    for i in range(7):
        acc, gyr = rng.normal(0, 1, 3), rng.normal(0, 30, 3)
        b = packets.make_imu_packet(10**18 + i * 10**7, acc, gyr)
        assert b == jpkt.make_imu_packet(10**18 + i * 10**7, acc, gyr)
        bufs.append(np.frombuffer(b, np.uint8))
    arr = np.stack(bufs)
    got = packets.parse_imu_packets(arr)
    assert native.backend() == "native"
    with native.numpy_only():
        same(packets.parse_imu_packets(arr), got, "native vs numpy")
    same(got, jpkt.parse_imu_packets(arr), "imu")
    same(sources.imu_from_raw(got["sys_ts"], got["accel_g"],
                              got["avel_deg"]),
         jsources.imu_from_raw(got["sys_ts"], got["accel_g"],
                               got["avel_deg"]), "si units")


def test_native_pcap_split_against_numpy(recording):
    """The port's C++ splitter (IPv4 reassembly) against its numpy path."""
    d, rec, meta, gt = recording
    data = np.fromfile(rec, np.uint8)
    assert native.pcap_split_udp(data) is not None
    assert native.backend() == "native"
    nat = pcap.read_pcap_udp(rec)
    with native.numpy_only():
        assert native.pcap_split_udp(data) is None
        slow = pcap.read_pcap_udp(rec)
        assert native.backend() == "numpy"
    assert [s for s, _ in nat] == [s for s, _ in slow]
    for (_, a), (_, b) in zip(nat, slow):
        same(a.payloads, b.payloads, "payloads")
        np.testing.assert_allclose(a.ts, b.ts, rtol=0, atol=1e-6)


def _bag_messages(rec, info):
    """The fixture's lidar and IMU packets as ROS1 PacketMsg messages."""
    streams = dict(jpcap.read_pcap_udp(rec))
    msgs = []
    for size, topic in ((jpkt.lidar_packet_size(info),
                         "/os_node/lidar_packets"),
                        (jpkt.IMU_PACKET_SIZE, "/os_node/imu_packets")):
        st = streams[size]
        for t, p in zip(st.ts, st.payloads):
            msgs.append((topic, "ouster_ros/msg/PacketMsg",
                         jbag.OUSTER_PACKETMSG_MD5, int(t * 1e9),
                         np.uint32(len(p)).tobytes() + p.tobytes()))
    return sorted(msgs, key=lambda m: m[3])


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_ros1_bag(recording, tmp_path, compression):
    """Ouster packet bags: the writers write the same bytes, the readers
    decode the same scans and IMU (and the IMU-only source the same
    samples); chunks of 40 messages."""
    d, rec, meta, gt = recording
    info, jinfo = metadata.read_metadata_json(meta), \
        jmeta.read_metadata_json(meta)
    msgs = _bag_messages(rec, jinfo)
    a, b = str(tmp_path / "port.bag"), str(tmp_path / "jax.bag")
    rosbag.write_simple_bag(a, msgs, messages_per_chunk=40,
                            compression=compression)
    jbag.write_simple_bag(b, msgs, messages_per_chunk=40,
                          compression=compression)
    assert filecmp.cmp(a, b, shallow=False)
    got = sources.read_packet_source(a, info)
    same(got, jsources.read_packet_source(a, jinfo), "bag")
    same(got[0].range_mm,
         jsources.read_packet_source(rec, jinfo)[0].range_mm, "vs pcap")
    same(sources.read_imu_bag(a), jsources.read_imu_bag(a), "imu bag")


def test_ros1_sensor_imu_and_ros2_bag(recording, tmp_path):
    """``sensor_msgs/Imu`` in a ROS1 bag, and a ROS2 bag directory of
    PacketMsg lidar and IMU topics and an Imu topic."""
    d, rec, meta, gt = recording
    info, jinfo = metadata.read_metadata_json(meta), \
        jmeta.read_metadata_json(meta)
    rng = np.random.default_rng(5)
    samples = [(100.0 + i * 0.01, rng.normal(0, 1, 3), rng.normal(0, 1, 3))
               for i in range(12)]
    assert rosbag.serialize_imu_msg(*samples[0]) == \
        jbag.serialize_imu_msg(*samples[0])
    imu1 = str(tmp_path / "imu.bag")
    rosbag.write_simple_bag(imu1, [
        ("/imu", "sensor_msgs/msg/Imu", "", int(t * 1e9),
         rosbag.serialize_imu_msg(t, la, av)) for t, la, av in samples])
    same(sources.read_imu_bag(imu1), jsources.read_imu_bag(imu1), "imu1")

    msgs2 = [(topic, "ouster_sensor_msgs/msg/PacketMsg", ts,
              rosbag2.cdr_serialize_packetmsg(raw[4:]))
             for topic, _, _, ts, raw in _bag_messages(rec, jinfo)]
    msgs2 += [("/alpha/imu", "sensor_msgs/msg/Imu", int(t * 1e9),
               rosbag2.cdr_serialize_imu_msg(t, la, av, frame_id="imu_x"))
              for t, la, av in samples]
    assert msgs2[-1][3] == jbag2.cdr_serialize_imu_msg(
        *samples[-1], frame_id="imu_x")
    bag2 = str(tmp_path / "bag2")
    rosbag2.write_simple_bag2(bag2, msgs2)
    same(sources.read_packet_source(bag2, info),
         jsources.read_packet_source(bag2, jinfo), "ros2 packets")
    for topic in ("/alpha/imu", "/os_node/imu_packets"):
        same(sources.read_imu_bag(bag2, imu_topic=topic),
             jsources.read_imu_bag(bag2, imu_topic=topic), topic)


def test_lz4_native_against_python():
    rng = np.random.default_rng(6)
    data = bytes(rng.integers(0, 4, 200_000).astype(np.uint8)) * 2
    from ptudes_tpu.io import lz4f as jlz4f
    from ptudes_tpu_torch.io import lz4f
    frame = lz4f.frame_compress(data, block_size=1 << 16)
    assert frame == jlz4f.frame_compress(data, block_size=1 << 16)
    assert lz4f.frame_decompress(frame) == data
    assert native.backend() == "native"
    with native.numpy_only():
        assert lz4f.frame_decompress(frame) == data
        assert native.backend() == "numpy"


def test_metadata_parse_and_resolve(recording, tmp_path):
    """The flat layout with the legacy ``lidar_mode`` backfill, the nested
    FW 2.x layout, and resolution next to the data file."""
    d, rec, meta, gt = recording
    flat = json.load(open(meta))
    del flat["lidar_mode"]
    nested = {
        "sensor_info": {"prod_line": "OS-1-64"},
        "beam_intrinsics": {
            "beam_altitude_angles": list(np.linspace(16, -16, 64)),
            "beam_azimuth_angles": list(np.full(64, -1.2)),
            "lidar_origin_to_beam_origin_mm": 15.806},
        "lidar_data_format": {
            "columns_per_frame": 2048, "columns_per_packet": 16,
            "pixel_shift_by_row": [12, 4, -4, -12] * 16,
            "udp_profile_lidar": "RNG19_RFL8_SIG16_NIR16"},
        "config_params": {"lidar_mode": "2048x10"},
        "lidar_intrinsics": {"lidar_to_sensor_transform":
                             list(np.eye(4).ravel() * 2)},
        "imu_intrinsics": {"imu_to_sensor_transform":
                           list(np.arange(16.0))}}
    for js in (flat, nested):
        warns = (lambda: pytest.warns(UserWarning)) if js is flat \
            else contextlib.nullcontext
        with warns():
            got = metadata.parse_metadata(json.dumps(js))
        with warns():
            same(got, jmeta.parse_metadata(json.dumps(js)), "metadata")
        assert got.range_unit_m() == jmeta.parse_metadata(
            json.dumps(js)).range_unit_m()
    for data, m in ((rec, None), (rec, meta), (str(tmp_path / "x.pcap"),
                                               None)):
        assert metadata.resolve_metadata(data, m) == \
            jmeta.resolve_metadata(data, m)


def test_pose_files_round_trip(recording, tmp_path):
    """KITTI and NC GT: each package reads what the other writes, and the
    GT matching helpers agree."""
    d, rec, meta, gt = recording
    rng = np.random.default_rng(7)
    p = np.tile(np.eye(4), (9, 1, 1))
    p[:, :3, 3] = rng.normal(0, 5, (9, 3))
    from scipy.spatial.transform import Rotation
    p[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 1, (9, 3))).as_matrix()
    ts = 1.7e9 + np.arange(9) * 0.1
    for write, read in ((poses, jposes), (jposes, poses)):
        k, c = str(tmp_path / "k.txt"), str(tmp_path / "c.csv")
        write.save_poses_kitti_format(k, p, header="h")
        write.save_poses_nc_gt_format(c, ts, p, header="h")
        same(read.load_poses_kitti_format(k),
             write.load_poses_kitti_format(k), "kitti")
        same(read.read_newer_college_gt(c), write.read_newer_college_gt(c),
             "nc")
    gts = poses.read_newer_college_gt(gt)
    assert len(gts) == N_SCANS
    scan_ts = list(jsources.read_packet_source(
        rec, jmeta.read_metadata_json(meta))[0].ts)
    same(poses.filter_nc_gt_by_close_ts(gts, scan_ts),
         jposes.filter_nc_gt_by_close_ts(gts, scan_ts), "close ts")
    cmp = gts[1::2] + [(gts[-1][0] + 0.05, gts[-1][1])]
    same(poses.filter_nc_gt_by_cmp(gts, cmp),
         jposes.filter_nc_gt_by_cmp(gts, cmp), "by cmp")


def test_trajectory_stats_and_projection(recording):
    """``utils.trajectory``, ``utils.stats``, ``make_xyz_lut`` (the nav-frame
    LUT the commands build) and ``reduce_active_beams_mask``."""
    d, rec, meta, gt = recording
    jinfo = jmeta.read_metadata_json(meta)
    scans, imu = jsources.read_packet_source(rec, jinfo)
    gts = jposes.read_newer_college_gt(gt)
    for tb in (0.0, 1.0, 1.5):
        same(trajectory.poses_for_scans(scans.ts, gts, time_bounds=tb),
             jtraj.poses_for_scans(scans.ts, gts, time_bounds=tb), "gt")
    same(trajectory.prune_trajectory(gts, min_dist_m=0.3),
         jtraj.prune_trajectory(gts, min_dist_m=0.3), "prune")
    for beams in (None, 4):
        a = stats.sequence_stats(scans.range_mm, scans.ts, imu.lacc,
                                 imu.avel, imu.ts, use_beams_num=beams)
        b = jstats.sequence_stats(scans.range_mm, scans.ts, imu.lacc,
                                  imu.avel, imu.ts, use_beams_num=beams)
        assert repr(a) == repr(b)
        same(a.gravity_estimate, b.gravity_estimate, "gravity")
    for h, beams in ((16, 4), (128, 32), (64, 64)):
        same(projection.reduce_active_beams_mask(h, beams),
             jproj.reduce_active_beams_mask(h, beams), "beams")
    ext = np.linalg.inv(np.array([[0, -1, 0, 6.25], [1, 0, 0, -12.0],
                                  [0, 0, 1, 7.5], [0, 0, 0, 1.0]]))
    args = (W, H, jinfo.beam_altitude_angles + 0.3,
            np.linspace(-3, 3, H), 15.806,
            np.array([[-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 36.18],
                      [0, 0, 0, 1.0]]))
    got = projection.make_xyz_lut(*args, extrinsic=ext, device="cpu")
    want = jproj.make_xyz_lut(*args, extrinsic=ext)
    for g, w in zip(got, want):
        assert g.dtype.is_floating_point and g.device.type == "cpu"
        same(g.numpy(), np.asarray(w), "lut")


def test_make_torch_fixture_bytes(recording, tmp_path):
    """The port-only fixture writer writes ``tools/make_fixture.py``'s
    bytes, and the bench writer the same bytes over either package's IO
    (here on a 2-scan 16 x 128 scene with the bench's sensor model); the
    metadata's beams reproduce the scene sensor's LUT."""
    d, rec, meta, gt = recording
    got = make_torch_fixture.generate(str(tmp_path / "port"), N_SCANS, H, W,
                                      seed=7)
    for a, b in zip(got, (rec, meta, gt)):
        assert filecmp.cmp(a, b, shallow=False), a
    from ptudes_tpu_torch.models import sim
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=90.0)
    ts = np.arange(3) * 0.1
    sweep = sim.circle_poses_at(ts, ramp=1.0)
    world = sim.make_sim_world(seed=0, extent=30.0, n_boxes=10,
                               keepout_points=sweep[:, :3, 3])
    scans = np.stack([sim.render_range_image(
        world, sweep[i], sensor, max_range=70.0, noise_std=0.01, seed=i,
        end_pose=sweep[i + 1]) for i in range(2)])
    imu = sim.imu_for_circle(np.arange(1, 22) * 0.01, ramp=1.0)
    scene = (sensor, scans, ts[:2] + 0.1,
             sim.circle_poses_at(ts[:2] + 0.05, ramp=1.0), imu)
    a = make_torch_fixture.bench(str(tmp_path / "a"), scene=scene)
    b = make_torch_fixture.bench(str(tmp_path / "b"), io=JAX_IO, scene=scene)
    for x, y in zip(a, b):
        assert filecmp.cmp(x, y, shallow=False), x
    info = metadata.read_metadata_json(a[1])
    lut = projection.make_xyz_lut(
        info.w, info.h, info.beam_altitude_angles, info.beam_azimuth_angles,
        info.lidar_origin_to_beam_origin_mm, info.lidar_to_sensor_transform,
        extrinsic=np.eye(4), device="cpu")
    same(lut.direction.numpy(), sensor.lut.direction, "direction")
    same(lut.offset.numpy(), sensor.lut.offset, "offset")
    rscans, rimu = sources.read_packet_source(a[0], info)
    assert len(rscans) == 2 and len(rimu) == 21
    same(rscans.range_mm, np.clip(scans * 1000.0, 0, (1 << 20) - 1).astype(
        np.uint32), "ranges in mm")


def test_port_imports_neither_jax_nor_the_jax_package():
    """With ``jax``, ``ptudes_tpu`` and ``matplotlib`` blocked, every
    module of the port imports (``parallel``, ``parallel.sharded`` and
    ``viz`` among them) and the command line's ``--help`` runs, ``ekf-bench
    ouster``'s and ``ekf-bench sweep``'s too; so does a CPU run of the
    batched driver at the library's defaults (the refresh loop, the
    ``"assoc"`` predict) with the constant-velocity guess and
    ``sim.make_world``: the code they reach at run time imports nothing
    of either."""
    code = """
import pkgutil, runpy, sys
sys.modules["jax"] = None
sys.modules["ptudes_tpu"] = None
sys.modules["matplotlib"] = None
import ptudes_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ptudes_tpu_torch.__path__, "ptudes_tpu_torch.")
    if not m.name.endswith(".__main__")]
for name in names:
    __import__(name)
need = {"ptudes_tpu_torch.io.sources", "ptudes_tpu_torch.native",
        "ptudes_tpu_torch.cli.main", "ptudes_tpu_torch.models.online",
        "ptudes_tpu_torch.io.rosbag2", "ptudes_tpu_torch.utils.stats",
        "ptudes_tpu_torch.parallel", "ptudes_tpu_torch.parallel.batched",
        "ptudes_tpu_torch.parallel.replay", "ptudes_tpu_torch.parallel.mesh",
        "ptudes_tpu_torch.parallel.sharded", "ptudes_tpu_torch.viz",
        "ptudes_tpu_torch.viz.cloud", "ptudes_tpu_torch.viz.fly",
        "ptudes_tpu_torch.viz.graphs", "ptudes_tpu_torch.viz.stream_player",
        "ptudes_tpu_torch.viz.debug_scene"}
assert need <= set(names), need - set(names)
assert not any(m == "jax" or m.startswith(("jax.", "ptudes_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(names), "modules")
#RUN
sys.argv = ["ptudes-tpu-torch", "--help"]
runpy.run_module("ptudes_tpu_torch.cli.main", run_name="__main__")
"""
    run = """
import numpy as np
from ptudes_tpu_torch import config
from ptudes_tpu_torch.models import lio, sim
from ptudes_tpu_torch.parallel import batched, replay
from ptudes_tpu_torch.utils import convert
cfg = config.PipelineConfig(
    kiss=config.KissConfig(max_range=30.0, min_range=1.0),
    cap=config.Capacity(max_points=16 * 128, max_frame=2048, max_source=512,
                        map_capacity=1 << 12, dedup_table=1 << 12,
                        max_new_per_scan=1024), guess="kiss")
sensor = sim.make_sim_sensor(h=16, w=128)
world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=20)
ts = np.array([0.0, 0.1, 0.2])
scans = np.stack([sim.render_range_image(world, p, sensor)
                  for p in sim.circle_poses_at(ts)])
imu_ts = np.arange(1, 21) * 0.01
imu = sim.imu_for_circle(imu_ts)
bt = lio.build_batches(cfg, scans, ts + 1e-9, np.asarray(imu.lacc),
                       np.asarray(imu.avel), imu_ts, device="cpu")
_, out = batched.run_sequence_batched(
    replay.stack_bags([lio.init_state(cfg, "cpu")] * 2),
    replay.stack_bags([bt, bt]), convert.lut_from_numpy(sensor.lut, "cpu"),
    cfg=cfg)
assert out.kiss_pose.shape == (2, 3, 4, 4)
assert sim.make_world(0, n=600).shape == (600, 3)
assert not any(m == "jax" or m.startswith(("jax.", "ptudes_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("batched run")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code.replace("#RUN", run)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "modules" in r.stdout and "ekf-bench" in r.stdout
    assert "batched run" in r.stdout
    r = subprocess.run([sys.executable, "-c", code.replace(
        '"--help"', '"ekf-bench", "ouster", "--help"')], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--use-imu-prediction" in r.stdout and "--online" in r.stdout
    r = subprocess.run([sys.executable, "-c", code.replace(
        '"--help"', '"ekf-bench", "sweep", "--help"')], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--bacc-z" in r.stdout and "--replicas" in r.stdout


def test_plot_flags_refused_without_matplotlib(tmp_path):
    """Where matplotlib is missing (the card's machine), a plot flag is
    refused with a clear error before anything runs (exit code 2), and
    ``viz --stream-dir`` (numpy) still runs; nothing imports JAX."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["ptudes_tpu"] = None
sys.modules["matplotlib"] = None
from ptudes_tpu_torch.cli import main
from ptudes_tpu_torch.viz import graphs
for argv in (["ekf-bench", "sim", "-p", "graphs", "--device", "cpu"],
             ["ekf-bench", "cmp", "GT", "-p", "graphs"],
             ["viz", "GT", "--out-png", "x.png", "--device", "cpu"]):
    argv = [sys.argv[1] if a == "GT" else a for a in argv]
    assert main.main(argv) == 2, argv
try:
    graphs.kiss_innovation_graph([0.0], [0.0], [0.0], [0.0], show=False)
except graphs.PlotUnavailable as e:
    print("refused:", e)
print("ok")
"""
    gt = tmp_path / "gt.csv"
    gt.write_text("0,0,0,0,0,0,0,0,1\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code, str(gt)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.endswith("ok\n") and "refused: plotting needs " \
        "matplotlib" in r.stdout
    assert r.stderr.count("plotting needs matplotlib, which is not "
                          "installed") == 3, r.stderr
