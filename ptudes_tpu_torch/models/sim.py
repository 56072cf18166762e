"""Synthetic lidar + IMU data, made with numpy (a copy of the numpy subset
of ``ptudes_tpu.models.sim``): the analytic raycast world, the sensor LUT,
range-image rendering with a true rotosweep, the speed-ramped circle
trajectory and its exact IMU, the seeded IMU streams of ``ekf-bench
sim`` (:func:`sim_imu_arrays`, the only one that returns tensors) and the
point-cloud world of :func:`make_world`. The
rest returns numpy, so the card's machine (which has no JAX) can make the
same scenes as the JAX package; ``utils.convert.lut_from_numpy`` moves a
sensor's LUT to a device.
"""
from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from .. import GRAV
from ..ops.projection import XyzLut, make_xyz_lut_np
from .esekf import Imu


class SimWorld(NamedTuple):
    """Ground plane + 4 perimeter walls + axis-aligned boxes."""
    extent: float
    wall_height: float
    box_lo: np.ndarray  # [K, 3]
    box_hi: np.ndarray  # [K, 3]


class SimSensor(NamedTuple):
    h: int
    w: int
    alt_deg: np.ndarray
    lut: XyzLut  # numpy f32 direction / offset [H, W, 3]


class SimImu(NamedTuple):
    lacc: np.ndarray  # [M, 3] f32
    avel: np.ndarray  # [M, 3] f32
    ts: np.ndarray    # [M] f32


def sim_imu_arrays(seed: int, n: int, *, freq: float = 100.0,
                   acc_mean: np.ndarray | None = None, acc_std: float = 1.5,
                   acc_noise_std: float = 0.4,
                   acc_bias: np.ndarray | None = None,
                   gyr_mean: np.ndarray | None = None, gyr_std: float = 1.0,
                   gyr_noise_std: float = 0.2,
                   gyr_bias: np.ndarray | None = None,
                   gravity: np.ndarray | None = None,
                   device="cuda") -> tuple[Imu, Imu]:
    """Piecewise-constant motion resampled every 10 ticks, plus white noise
    and fixed biases: the (ideal, noisy) IMU streams of length n as f32
    tensors on ``device`` (the card unless the caller asks for another),
    from the same ``default_rng(seed)`` draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    acc_mean = np.zeros(3) if acc_mean is None else acc_mean
    gyr_mean = np.zeros(3) if gyr_mean is None else gyr_mean
    acc_bias = np.array([0.9, -0.2, -0.4]) if acc_bias is None else acc_bias
    gyr_bias = np.array([0.01, 0.03, -0.012]) if gyr_bias is None \
        else gyr_bias
    gravity = GRAV * np.array([0.0, 0.0, -1.0]) if gravity is None \
        else gravity

    nseg = (n + 9) // 10
    acc_seg = rng.normal(0.0, acc_std, (nseg, 3)) + acc_mean - gravity
    gyr_seg = rng.normal(0.0, gyr_std, (nseg, 3)) + gyr_mean
    acc = np.repeat(acc_seg, 10, axis=0)[:n]
    gyr = np.repeat(gyr_seg, 10, axis=0)[:n]
    acc_noise = rng.normal(0.0, acc_noise_std, (n, 3))
    gyr_noise = rng.normal(0.0, gyr_noise_std, (n, 3))
    ts = np.arange(n) * (1.0 / freq)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    ideal = Imu(lacc=f32(acc), avel=f32(gyr), ts=f32(ts))
    noisy = Imu(lacc=f32(acc + acc_noise + acc_bias),
                avel=f32(gyr + gyr_noise + gyr_bias), ts=f32(ts))
    return ideal, noisy


def make_world(seed: int = 0, n: int = 60000,
               extent: float = 40.0) -> np.ndarray:
    """Structured static world point cloud: ground + perimeter walls +
    random boxes (``ptudes_tpu.models.sim.make_world``, the same draws in
    the same order). Non-degenerate for point-to-point ICP."""
    rng = np.random.default_rng(seed)
    e = extent
    n_ground = n // 3
    ground = np.stack(
        [rng.uniform(-e, e, n_ground), rng.uniform(-e, e, n_ground),
         rng.normal(0, 0.02, n_ground)], -1)

    n_wall = n // 6
    walls = []
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1)]:
        w = np.zeros((n_wall, 3))
        w[:, axis] = sign * e + rng.normal(0, 0.02, n_wall)
        w[:, 1 - axis] = rng.uniform(-e, e, n_wall)
        w[:, 2] = rng.uniform(0, 8, n_wall)
        walls.append(w)

    n_box = n - n_ground - 4 * n_wall
    centers = rng.uniform(-e * 0.7, e * 0.7, (12, 3))
    centers[:, 2] = rng.uniform(0.5, 3, 12)
    sizes = rng.uniform(0.5, 3.0, (12, 3))
    which = rng.integers(0, 12, n_box)
    face = rng.integers(0, 3, n_box)
    u = rng.uniform(-1, 1, (n_box, 3))
    pts = centers[which] + u * sizes[which]
    # snap one coordinate to a face
    snap = np.sign(rng.uniform(-1, 1, n_box))
    pts[np.arange(n_box), face] = (
        centers[which, face] + snap * sizes[which, face])

    return np.vstack([ground, *walls, pts]).astype(np.float32)


def make_sim_world(seed: int = 0, extent: float = 40.0, n_boxes: int = 14,
                   wall_height: float = 8.0,
                   keepout_points: np.ndarray | None = None,
                   keepout_margin: float = 2.0) -> SimWorld:
    """``keepout_points`` (trajectory positions) reject boxes the sensor
    would pass through."""
    rng = np.random.default_rng(seed)
    lo_list, hi_list = [], []
    tries = 0
    while len(lo_list) < n_boxes and tries < n_boxes * 20:
        tries += 1
        center = rng.uniform(-extent * 0.75, extent * 0.75, 3)
        size = rng.uniform(0.6, 3.5, 3)
        center[2] = size[2]
        lo, hi = center - size, center + size
        if keepout_points is not None:
            closest = np.maximum(
                lo[None, :2] - keepout_points[:, :2],
                np.maximum(0.0, keepout_points[:, :2] - hi[None, :2]))
            if np.min(np.linalg.norm(closest, axis=1)) < keepout_margin:
                continue
        lo_list.append(lo)
        hi_list.append(hi)
    return SimWorld(extent=extent, wall_height=wall_height,
                    box_lo=np.asarray(lo_list, np.float64),
                    box_hi=np.asarray(hi_list, np.float64))


def make_sim_sensor(h: int = 64, w: int = 1024,
                    fov_deg: float = 45.0) -> SimSensor:
    """Uniform-altitude spinning lidar with zero azimuth offsets."""
    alt = np.linspace(fov_deg / 2, -fov_deg / 2, h)
    direction, offset = make_xyz_lut_np(w, h, alt, np.zeros(h))
    return SimSensor(h=h, w=w, alt_deg=alt,
                     lut=XyzLut(direction.astype(np.float32),
                                offset.astype(np.float32)))


def render_range_image(world: SimWorld, pose: np.ndarray, sensor: SimSensor,
                       max_range: float = 60.0, noise_std: float = 0.0,
                       seed: int = 0,
                       end_pose: np.ndarray | None = None) -> np.ndarray:
    """Analytic raycast -> [H, W] range image (0 = no return); with
    ``end_pose`` each column m is rendered from the pose interpolated at
    m/W between ``pose`` and ``end_pose`` (a rotosweep)."""
    h, w = sensor.h, sensor.w
    dirs = np.asarray(sensor.lut.direction, np.float64)
    if end_pose is None:
        origins = np.broadcast_to(pose[:3, 3], (h, w, 3))
        d = dirs @ pose[:3, :3].T
    else:
        from scipy.spatial.transform import Rotation
        frac = (np.arange(w) / w)[None, :, None]
        t0, t1 = pose[:3, 3], end_pose[:3, 3]
        origins = np.broadcast_to((1 - frac) * t0 + frac * t1,
                                  (h, w, 3)).copy()
        dr = Rotation.from_matrix(pose[:3, :3].T @ end_pose[:3, :3]
                                  ).as_rotvec()
        cols = Rotation.from_rotvec((np.arange(w) / w)[:, None] * dr
                                    ).as_matrix()
        d = np.einsum("wij,hwj->hwi", pose[:3, :3] @ cols, dirs)
    o = origins.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tbest = np.full(len(d), np.inf)
    eps = 1e-12
    e, wh = world.extent, world.wall_height

    def consider(t, hit_ok):
        nonlocal tbest
        good = hit_ok & (t > 0.3) & (t < tbest)
        tbest = np.where(good, t, tbest)

    t = -o[:, 2] / np.where(np.abs(d[:, 2]) < eps, eps, d[:, 2])
    px, py = o[:, 0] + t * d[:, 0], o[:, 1] + t * d[:, 1]
    consider(t, (t > 0) & (np.abs(px) <= e) & (np.abs(py) <= e))
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1)]:
        da = np.where(np.abs(d[:, axis]) < eps, eps, d[:, axis])
        t = (sign * e - o[:, axis]) / da
        pu = o[:, 1 - axis] + t * d[:, 1 - axis]
        pz = o[:, 2] + t * d[:, 2]
        consider(t, (t > 0) & (np.abs(pu) <= e) & (pz >= 0) & (pz <= wh))
    for lo, hi in zip(world.box_lo, world.box_hi):
        dd = np.where(np.abs(d) < eps, eps, d)
        t1 = (lo[None] - o) / dd
        t2 = (hi[None] - o) / dd
        tmin = np.minimum(t1, t2).max(axis=1)
        tmax = np.maximum(t1, t2).min(axis=1)
        consider(tmin, (tmin <= tmax) & (tmin > 0))
    img = tbest.reshape(h, w)
    img = np.where(np.isfinite(img) & (img < max_range), img, 0.0)
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        img = np.where(img > 0, img + rng.normal(0, noise_std, img.shape),
                       0.0)
    return img.astype(np.float32)


def _circle_kinematics(t, radius: float, speed: float, ramp: float):
    """Arc angle, angular rate and tangential acceleration at ``t`` for
    speed ``v(t) = speed * min(1, t / ramp)``."""
    t = np.asarray(t, np.float64)
    if ramp <= 0.0:
        arc = speed * t
        v = np.full_like(t, speed)
        at = np.zeros_like(t)
    else:
        tr = np.minimum(t, ramp)
        arc = 0.5 * speed / ramp * tr ** 2 + speed * np.maximum(t - ramp, 0.0)
        v = speed * np.minimum(t / ramp, 1.0)
        at = np.where(t < ramp, speed / ramp, 0.0)
    return arc / radius, v / radius, at


def circle_poses_at(t, *, radius: float = 8.0, speed: float = 2.0,
                    ramp: float = 0.0, z: float = 1.2) -> np.ndarray:
    """Exact poses [len(t), 4, 4] of the (speed-ramped) circle."""
    a, _, _ = _circle_kinematics(t, radius, speed, ramp)
    poses = np.tile(np.eye(4), (len(a), 1, 1))
    ca, sa = np.cos(a), np.sin(a)
    poses[:, 0, 0], poses[:, 0, 1] = ca, -sa
    poses[:, 1, 0], poses[:, 1, 1] = sa, ca
    poses[:, :3, 3] = np.stack(
        [radius * np.sin(a), radius * (1 - np.cos(a)), np.full_like(a, z)],
        -1)
    return poses.astype(np.float64)


def circle_trajectory(n_scans: int, *, radius: float = 8.0,
                      speed: float = 2.0, scan_dt: float = 0.1,
                      z: float = 1.2, ramp: float = 0.0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(ts [n], poses [n, 4, 4]) of the circle with tangent heading,
    sampled every ``scan_dt`` from 0 (``ramp`` > 0: from rest)."""
    ts = np.arange(n_scans) * scan_dt
    return ts, circle_poses_at(ts, radius=radius, speed=speed, ramp=ramp,
                               z=z)


def imu_for_circle(imu_ts, *, radius: float = 8.0, speed: float = 2.0,
                   ramp: float = 0.0) -> SimImu:
    """Exact IMU (specific force, body rates) along the circle."""
    a, omega, at = _circle_kinematics(imu_ts, radius, speed, ramp)
    v = omega * radius
    ca, sa = np.cos(a), np.sin(a)
    acc2d = (at[:, None] * np.stack([ca, sa], -1)
             + (v ** 2 / radius)[:, None] * np.stack([-sa, ca], -1))
    g = GRAV * np.array([0.0, 0.0, -1.0])
    fx = ca * (acc2d[:, 0] - g[0]) + sa * (acc2d[:, 1] - g[1])
    fy = -sa * (acc2d[:, 0] - g[0]) + ca * (acc2d[:, 1] - g[1])
    fz = np.full_like(a, -g[2])
    zero = np.zeros_like(a)
    return SimImu(lacc=np.stack([fx, fy, fz], -1).astype(np.float32),
                  avel=np.stack([zero, zero, omega], -1).astype(np.float32),
                  ts=np.asarray(imu_ts, np.float32))


# the bench scene (bench.py:make_data): 50 scans of a 128 x 1024 sensor with
# a 90 degree vertical field of view on an 8 m circle at 2 m/s, starting at
# rest with a 1 s speed ramp; scan timestamps at the end of each sweep
BENCH_SCANS, BENCH_H, BENCH_W = 50, 128, 1024
BENCH_DT, BENCH_RADIUS, BENCH_SPEED, BENCH_RAMP = 0.1, 8.0, 2.0, 1.0


def bench_scene(n_scans: int = BENCH_SCANS, cache_dir: str | None = None):
    """Render (or load from the temp-dir cache) the bench scene; returns
    (sensor, scans [N, H, W], scan_ts [N], gt_mid [N, 4, 4], imu SimImu).
    ``gt_mid`` are the exact mid-sweep poses (the deskew anchor)."""
    sensor = make_sim_sensor(h=BENCH_H, w=BENCH_W, fov_deg=90.0)
    cache = os.path.join(cache_dir or tempfile.gettempdir(),
                         f"ptudes_torch_bench_{n_scans}_{BENCH_H}x"
                         f"{BENCH_W}_v1.npz")
    kin = dict(radius=BENCH_RADIUS, speed=BENCH_SPEED, ramp=BENCH_RAMP)
    ts = np.arange(n_scans + 1) * BENCH_DT
    if os.path.exists(cache):
        with np.load(cache) as z:
            scans = z["scans"]
    else:
        sweep = circle_poses_at(ts, **kin)
        world = make_sim_world(seed=0, extent=30.0, n_boxes=40,
                               keepout_points=sweep[:, :3, 3])
        scans = np.stack([
            render_range_image(world, sweep[i], sensor, max_range=70.0,
                               noise_std=0.01, seed=i,
                               end_pose=sweep[i + 1])
            for i in range(n_scans)])
        tmp = cache + f".{os.getpid()}.npz"
        np.savez_compressed(tmp, scans=scans)
        os.replace(tmp, cache)
    scan_ts = ts[:n_scans] + BENCH_DT
    gt_mid = circle_poses_at(ts[:n_scans] + BENCH_DT / 2, **kin)
    imu = imu_for_circle(np.arange(1, n_scans * 10 + 2) * 0.01, **kin)
    return sensor, scans, scan_ts, gt_mid, imu
