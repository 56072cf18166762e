"""Write a real-format Ouster recording with the PyTorch port only: a LEGACY
pcap (IP-fragmented at MTU 1500, as a real capture is), its metadata JSON
and a Newer College ground-truth csv, at epoch-scale timestamps.

Two scenes:

- ``fixture`` (:func:`generate`): ``tools/make_fixture.py``'s recording
  (the analytic circle, a rotosweep render) with the same bytes, made
  without JAX.
- ``bench`` (:func:`bench`): ``sim.bench_scene``'s range images (50 scans
  of 128 x 1024, a 90 degree vertical field of view), its IMU and its
  mid-sweep ground truth, as an OS-128 recording in 1024x10 mode: 64
  packets of 24,896 B a scan and 501 IMU packets.

Ranges are quantised to millimetres. The metadata's beam angles reproduce
the scene sensor's LUT through ``ops.projection.make_xyz_lut``. Scan ``i``
sweeps from ``T0_EPOCH + i * SCAN_DT``; the pipeline stamps it with its
last column's time, and the ground truth carries the mid-sweep pose at
that stamp.

    python tools/make_torch_fixture.py OUTDIR [--scene fixture|bench]
        [--scans N] [--h H] [--w W] [--seed S]

``io`` (every writer's last argument) is the set of IO modules to write
with: the port's by default, or ``ptudes_tpu.io``'s to check that both
write the same bytes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptudes_tpu_torch import GRAV  # noqa: E402
from ptudes_tpu_torch.models import sim  # noqa: E402

T0_EPOCH = 1.7e9  # seconds — PTP epoch scale
SCAN_DT = 0.1     # 10 Hz
IMU_DT = 0.01     # 100 Hz


def port_io() -> types.SimpleNamespace:
    """The port's IO modules (the default ``io``)."""
    from ptudes_tpu_torch.io import metadata, packets, pcap, poses
    return types.SimpleNamespace(metadata=metadata, packets=packets,
                                 pcap=pcap, poses=poses)


def make_info(h: int, w: int, alt_deg, io):
    """An OS-0-``h`` LEGACY sensor in ``w``x10 mode with beam altitudes
    ``alt_deg`` and no azimuth offsets, beam origin offset or extrinsics."""
    m = io.metadata
    return m.SensorInfo(
        prod_line=f"OS-0-{h}",
        mode=f"{w}x10",
        columns_per_frame=w,
        pixels_per_column=h,
        columns_per_packet=16,
        pixel_shift_by_row=[0] * h,
        udp_profile_lidar=m.PROFILE_LEGACY,
        beam_altitude_angles=np.asarray(alt_deg, np.float64),
        beam_azimuth_angles=np.zeros(h),
        lidar_origin_to_beam_origin_mm=0.0,
        lidar_to_sensor_transform=np.eye(4),
        imu_to_sensor_transform=np.eye(4),
        extrinsic=np.eye(4),
    )


def info_to_json(info) -> str:
    return json.dumps({
        "prod_line": info.prod_line,
        "lidar_mode": info.mode,
        "beam_altitude_angles": list(info.beam_altitude_angles),
        "beam_azimuth_angles": list(info.beam_azimuth_angles),
        "lidar_origin_to_beam_origin_mm": info.lidar_origin_to_beam_origin_mm,
        "lidar_to_sensor_transform":
            list(info.lidar_to_sensor_transform.ravel()),
        "imu_to_sensor_transform":
            list(info.imu_to_sensor_transform.ravel()),
        "data_format": {
            "columns_per_frame": info.w,
            "columns_per_packet": info.columns_per_packet,
            "pixel_shift_by_row": info.pixel_shift_by_row,
            "udp_profile_lidar": info.udp_profile_lidar,
        },
    }, indent=1)


def write_recording(outdir: str, name: str, info, ranges, imu_ts_rel, lacc,
                    avel, gt_poses, io, header: str):
    """Write ``ranges`` [N, H, W] (metres, 0 = no return; sweep i starts at
    ``T0_EPOCH + i * SCAN_DT``), the IMU samples at ``T0_EPOCH +
    imu_ts_rel`` (``lacc`` m/s^2, ``avel`` rad/s) and ``gt_poses`` [N, 4, 4]
    stamped at each scan's last column as ``<name>.pcap``, ``<name>.json``
    and ``gt.csv``; returns their paths."""
    pkt = io.packets
    n_scans, h, w = ranges.shape
    cpp = info.columns_per_packet
    payloads = []
    for i in range(n_scans):
        rng_mm = np.clip(ranges[i] * 1000.0, 0, (1 << 20) - 1).astype(
            np.uint32)
        t_start = T0_EPOCH + i * SCAN_DT
        for c0 in range(0, w, cpp):
            mids = np.arange(c0, c0 + cpp)
            col_ts_ns = ((t_start + mids / w * SCAN_DT) * 1e9).astype(
                np.uint64)
            buf = pkt.make_legacy_packet(info, col_ts_ns, mids, 1 + i,
                                         rng_mm[:, mids].T)
            payloads.append((float(col_ts_ns[0]) * 1e-9, buf))
    for k, trel in enumerate(imu_ts_rel):
        ns = int(round((T0_EPOCH + trel) * 1e9))
        buf = pkt.make_imu_packet(ns, lacc[k] / GRAV, np.rad2deg(avel[k]))
        payloads.append((T0_EPOCH + trel, buf))

    payloads.sort(key=lambda p: p[0])
    pcap_path = os.path.join(outdir, f"{name}.pcap")
    # mtu=1500: lidar packets exceed Ethernet MTU and are IP-fragmented,
    # as in real captures
    io.pcap.write_pcap_udp(pcap_path, payloads, mtu=1500)

    meta_path = os.path.join(outdir, f"{name}.json")
    with open(meta_path, "w") as f:
        f.write(info_to_json(info))

    scan_ts = T0_EPOCH + np.arange(n_scans) * SCAN_DT + (w - 1) / w * SCAN_DT
    gt_path = os.path.join(outdir, "gt.csv")
    io.poses.save_poses_nc_gt_format(gt_path, scan_ts, gt_poses[:n_scans],
                                     header=header)
    print(f"{name}: {pcap_path} ({os.path.getsize(pcap_path)} bytes), "
          f"{meta_path}, {gt_path}; {n_scans} scans {h}x{w} @ epoch "
          f"t0={T0_EPOCH}")
    return pcap_path, meta_path, gt_path


def generate(outdir: str, n_scans: int = 30, h: int = 32, w: int = 512,
             seed: int = 0, noise_std: float = 0.01, io=None):
    """``tools/make_fixture.generate``'s recording, byte for byte."""
    io = io or port_io()
    os.makedirs(outdir, exist_ok=True)
    info = make_info(h, w, np.linspace(22.5, -22.5, h), io)
    ts_rel, poses = sim.circle_trajectory(n_scans + 1, radius=8.0, speed=2.0,
                                          scan_dt=SCAN_DT)
    # mid-sweep poses: the analytic circle half a sweep later
    omega = 2.0 / 8.0
    a_mid = omega * (ts_rel + SCAN_DT / 2.0)
    poses_mid = np.tile(np.eye(4), (n_scans + 1, 1, 1))
    ca, sa = np.cos(a_mid), np.sin(a_mid)
    poses_mid[:, 0, 0], poses_mid[:, 0, 1] = ca, -sa
    poses_mid[:, 1, 0], poses_mid[:, 1, 1] = sa, ca
    poses_mid[:, :3, 3] = np.stack(
        [8.0 * sa, 8.0 * (1 - ca), np.full_like(a_mid, 1.2)], -1)

    world = sim.make_sim_world(seed=seed, extent=25.0, n_boxes=30,
                               keepout_points=poses[:, :3, 3])
    sensor = sim.make_sim_sensor(h=h, w=w, fov_deg=45.0)
    ranges = np.stack([
        sim.render_range_image(world, poses[i], sensor, max_range=60.0,
                               noise_std=noise_std, seed=seed * 997 + i,
                               end_pose=poses[i + 1])
        for i in range(n_scans)])
    imu_ts_rel = np.arange(1, n_scans * 10 + 1) * IMU_DT
    imu = sim.imu_for_circle(imu_ts_rel, radius=8.0, speed=2.0)
    return write_recording(
        outdir, "fixture", info, ranges, imu_ts_rel,
        np.asarray(imu.lacc, np.float64), np.asarray(imu.avel, np.float64),
        poses_mid, io, header="synthetic circle GT (mid-sweep poses)")


def bench(outdir: str, n_scans: int = sim.BENCH_SCANS, io=None,
          scene=None):
    """``sim.bench_scene(n_scans)`` (or ``scene``, a tuple of the same
    form) as a recording: its range images, its IMU samples (at their
    float64 times, every ``IMU_DT`` from ``IMU_DT``) and its mid-sweep
    ground truth."""
    io = io or port_io()
    os.makedirs(outdir, exist_ok=True)
    sensor, scans, _, gt_mid, imu = scene or sim.bench_scene(n_scans)
    info = make_info(sensor.h, sensor.w, sensor.alt_deg, io)
    imu_ts_rel = np.arange(1, len(imu.ts) + 1) * IMU_DT
    return write_recording(
        outdir, "bench", info, scans, imu_ts_rel,
        np.asarray(imu.lacc, np.float64), np.asarray(imu.avel, np.float64),
        gt_mid, io, header="bench scene GT (mid-sweep poses)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--scene", choices=["fixture", "bench"],
                    default="fixture")
    ap.add_argument("--scans", type=int, default=None,
                    help="scans (default 30 for fixture, 50 for bench)")
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--w", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.scene == "bench":
        bench(args.outdir, args.scans or sim.BENCH_SCANS)
    else:
        generate(args.outdir, args.scans or 30, args.h, args.w, args.seed)
