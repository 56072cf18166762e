"""The benchmark's scenes: a lidar and IMU recording of a platform driving
a circle through a world of boxes, from a start on the circle and with
range noise drawn from a seed.

A copy of the port's numpy scene (``sim.make_sim_world``,
``render_range_image``, ``circle_poses_at``, ``imu_for_circle`` and the
sensor LUT of ``make_xyz_lut_np``), with the ray-cast rewritten in torch so
that a whole recording renders on the card in seconds, many frames a call:
every column of a frame is cast from the pose interpolated along its sweep
(the rotosweep), against the ground plane, the four walls and every box.
The world and the trajectory are drawn on the host in float64; the rays
are cast in float64 on the device and the ranges rounded to float32.
Range noise comes from a ``torch.Generator`` on the device, seeded from
the recording's seed, so the same seed gives the same recording.

Nothing here imports the program under test: both the program and the
plain reference are handed what this module makes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GRAV = 9.782940329221166   # m/s^2, the value the program and reference use


class World(NamedTuple):
    """Ground plane, four perimeter walls and axis-aligned boxes."""
    extent: float
    wall_height: float
    box_lo: np.ndarray   # [K, 3] f64
    box_hi: np.ndarray   # [K, 3] f64


class Sensor(NamedTuple):
    h: int
    w: int
    direction: np.ndarray   # [H, W, 3] f32 unit beam directions
    offset: np.ndarray      # [H, W, 3] f32 beam origins (zero here)


class Recording(NamedTuple):
    """One recording in host memory."""
    scans: np.ndarray     # [N, H, W] f32 range images, 0 = no return
    scan_ts: np.ndarray   # [N] f64 end-of-sweep timestamps (s)
    gt_mid: np.ndarray    # [N, 4, 4] f64 exact mid-sweep poses
    imu_lacc: np.ndarray  # [M, 3] f32 specific force (body)
    imu_avel: np.ndarray  # [M, 3] f32 body rates
    imu_ts: np.ndarray    # [M] f64 timestamps (s)


def make_sensor(h: int, w: int, fov_deg: float) -> Sensor:
    """Uniform beam altitudes over ``fov_deg``, zero azimuth offsets, no
    beam-origin offset (``make_xyz_lut_np`` for such a sensor)."""
    alt = np.radians(np.linspace(fov_deg / 2, -fov_deg / 2, h))
    theta = 2.0 * np.pi * (1.0 - np.arange(w, dtype=np.float64) / w)
    phi = np.broadcast_to(alt[:, None], (h, w))
    th = np.broadcast_to(theta[None, :], (h, w))
    direction = np.stack([np.cos(th) * np.cos(phi),
                          np.sin(th) * np.cos(phi), np.sin(phi)], -1)
    return Sensor(h, w, direction.astype(np.float32),
                  np.zeros((h, w, 3), np.float32))


def make_world(seed: int, extent: float, n_boxes: int,
               wall_height: float = 8.0, keepout_points=None,
               keepout_margin: float = 2.0) -> World:
    """Boxes of half-size 0.6-3.5 m standing on the ground, none within
    ``keepout_margin`` of a trajectory point (``sim.make_sim_world``)."""
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
    return World(extent, wall_height, np.asarray(lo_list, np.float64),
                 np.asarray(hi_list, np.float64))


def _circle_kinematics(t, radius: float, speed: float, ramp: float):
    """Arc angle, angular rate and tangential acceleration at ``t`` for
    the speed ``speed * min(1, t / ramp)``."""
    t = np.asarray(t, np.float64)
    if ramp <= 0.0:
        return speed * t / radius, np.full_like(t, speed / radius), \
            np.zeros_like(t)
    tr = np.minimum(t, ramp)
    arc = 0.5 * speed / ramp * tr ** 2 + speed * np.maximum(t - ramp, 0.0)
    v = speed * np.minimum(t / ramp, 1.0)
    at = np.where(t < ramp, speed / ramp, 0.0)
    return arc / radius, v / radius, at


def circle_poses_at(t, *, radius: float, speed: float, ramp: float,
                    z: float = 1.2, phase: float = 0.0) -> np.ndarray:
    """Exact poses [len(t), 4, 4] on the circle, heading along it, from the
    arc angle ``phase`` at t = 0."""
    a, _, _ = _circle_kinematics(t, radius, speed, ramp)
    a = a + phase
    poses = np.tile(np.eye(4), (len(a), 1, 1))
    ca, sa = np.cos(a), np.sin(a)
    poses[:, 0, 0], poses[:, 0, 1] = ca, -sa
    poses[:, 1, 0], poses[:, 1, 1] = sa, ca
    poses[:, :3, 3] = np.stack(
        [radius * np.sin(a), radius * (1 - np.cos(a)), np.full_like(a, z)],
        -1)
    return poses


def imu_for_circle(imu_ts, *, radius: float, speed: float, ramp: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Exact specific force and body rates along the circle (f32); in the
    body frame they do not depend on where on the circle it starts."""
    a, omega, at = _circle_kinematics(imu_ts, radius, speed, ramp)
    v = omega * radius
    ca, sa = np.cos(a), np.sin(a)
    acc2d = (at[:, None] * np.stack([ca, sa], -1)
             + (v ** 2 / radius)[:, None] * np.stack([-sa, ca], -1))
    fx = ca * acc2d[:, 0] + sa * acc2d[:, 1]
    fy = -sa * acc2d[:, 0] + ca * acc2d[:, 1]
    fz = np.full_like(a, GRAV)
    zero = np.zeros_like(a)
    return (np.stack([fx, fy, fz], -1).astype(np.float32),
            np.stack([zero, zero, omega], -1).astype(np.float32))


def _rotvec_exp(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vectors [..., 3] -> matrices [..., 3, 3]."""
    th = torch.linalg.vector_norm(v, dim=-1)[..., None, None]
    k = torch.zeros(v.shape[:-1] + (3, 3), dtype=v.dtype, device=v.device)
    k[..., 0, 1], k[..., 0, 2] = -v[..., 2], v[..., 1]
    k[..., 1, 0], k[..., 1, 2] = v[..., 2], -v[..., 0]
    k[..., 2, 0], k[..., 2, 1] = -v[..., 1], v[..., 0]
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th ** 2 / 6, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a * k + b * (k @ k)


def _rotvec_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] (angles below pi) -> rotation vectors."""
    cos = ((r.diagonal(0, -2, -1).sum(-1) - 1) / 2).clamp(-1.0, 1.0)
    th = torch.arccos(cos)
    w = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1)
    s = torch.sin(th)
    scale = torch.where(th < 1e-8, 0.5 + th ** 2 / 12,
                        th / (2 * torch.where(th < 1e-8, 1.0, s)))
    return w * scale[..., None]


def render(world: World, sweep: np.ndarray, sensor: Sensor,
           max_range: float, device, noise_std: float = 0.0,
           generator: torch.Generator | None = None,
           frames_per_call: int = 64) -> np.ndarray:
    """Frames [N, H, W] f32 of ``sweep`` [N + 1, 4, 4]: frame i cast column
    by column from the pose interpolated at m / W between ``sweep[i]`` and
    ``sweep[i + 1]``; ranges past ``max_range`` (or none) are 0; with
    ``noise_std`` > 0 each return gets Gaussian noise from ``generator``."""
    n = len(sweep) - 1
    h, w = sensor.h, sensor.w
    f64 = dict(dtype=torch.float64, device=device)
    dirs = torch.as_tensor(sensor.direction, **f64)          # [H, W, 3]
    frac = torch.arange(w, **f64) / w                         # [W]
    box_lo = torch.as_tensor(world.box_lo, **f64)
    box_hi = torch.as_tensor(world.box_hi, **f64)
    out = np.empty((n, h, w), np.float32)
    eps = 1e-12
    e, wh = world.extent, world.wall_height
    for lo_f in range(0, n, frames_per_call):
        f = min(frames_per_call, n - lo_f)
        p0 = torch.as_tensor(sweep[lo_f:lo_f + f], **f64)
        p1 = torch.as_tensor(sweep[lo_f + 1:lo_f + f + 1], **f64)
        dr = _rotvec_log(p0[:, :3, :3].transpose(1, 2) @ p1[:, :3, :3])
        cols = _rotvec_exp(frac[None, :, None] * dr[:, None, :])  # [F,W,3,3]
        rot = p0[:, None, :3, :3] @ cols                          # [F,W,3,3]
        d = torch.einsum("fwij,hwj->fhwi", rot, dirs).reshape(f, -1, 3)
        org = ((1 - frac)[None, :, None] * p0[:, None, :3, 3]
               + frac[None, :, None] * p1[:, None, :3, 3])        # [F,W,3]
        o = org[:, None].expand(f, h, w, 3).reshape(f, -1, 3)
        best = torch.full(d.shape[:2], torch.inf, **f64)

        def consider(t, ok):
            good = ok & (t > 0.3) & (t < best)
            best.copy_(torch.where(good, t, best))

        dz = torch.where(d[..., 2].abs() < eps, eps, d[..., 2])
        t = -o[..., 2] / dz
        px, py = o[..., 0] + t * d[..., 0], o[..., 1] + t * d[..., 1]
        consider(t, (t > 0) & (px.abs() <= e) & (py.abs() <= e))
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            da = torch.where(d[..., axis].abs() < eps, eps, d[..., axis])
            t = (sign * e - o[..., axis]) / da
            pu = o[..., 1 - axis] + t * d[..., 1 - axis]
            pz = o[..., 2] + t * d[..., 2]
            consider(t, (t > 0) & (pu.abs() <= e) & (pz >= 0) & (pz <= wh))
        dd = torch.where(d.abs() < eps, eps, d)
        inv = 1.0 / dd
        for k in range(box_lo.shape[0]):
            t1 = (box_lo[k] - o) * inv
            t2 = (box_hi[k] - o) * inv
            tmin = torch.minimum(t1, t2).amax(-1)
            tmax = torch.maximum(t1, t2).amin(-1)
            consider(tmin, (tmin <= tmax) & (tmin > 0))
        img = torch.where(torch.isfinite(best) & (best < max_range), best,
                          0.0).reshape(f, h, w)
        if noise_std > 0:
            noise = torch.randn(img.shape, generator=generator, **f64)
            img = torch.where(img > 0, img + noise_std * noise, 0.0)
        out[lo_f:lo_f + f] = img.to(torch.float32).cpu().numpy()
    return out


def circle_recording(seed: int, sensor: Sensor, *, n_scans: int,
                     scan_dt: float, imu_dt: float, radius: float,
                     speed: float, ramp: float, extent: float, n_boxes: int,
                     world_seed: int, max_range: float, noise_std: float,
                     device) -> Recording:
    """A recording of ``n_scans`` sweeps on the circle from rest through the
    world of ``world_seed``, its start on the circle and its range noise
    drawn from ``seed`` (every seed sees the same world and does the same
    laps, from another start); scan i covers [i, i + 1) * ``scan_dt`` and
    is stamped at its end; the IMU runs at 1 / ``imu_dt`` from ``imu_dt``
    on."""
    phase = float(np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi))
    kin = dict(radius=radius, speed=speed, ramp=ramp)
    ts = np.arange(n_scans + 1) * scan_dt
    sweep = circle_poses_at(ts, **kin, phase=phase)
    # the whole circle is kept out, whatever the start and the length
    ring = circle_poses_at(np.linspace(0.0, 2 * np.pi * radius / speed, 721),
                           radius=radius, speed=speed, ramp=0.0)
    world = make_world(world_seed, extent, n_boxes,
                       keepout_points=ring[:, :3, 3])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    scans = render(world, sweep, sensor, max_range, device,
                   noise_std=noise_std, generator=gen)
    per_scan = int(round(scan_dt / imu_dt))
    imu_ts = np.arange(1, n_scans * per_scan + 2) * imu_dt
    lacc, avel = imu_for_circle(imu_ts, **kin)
    return Recording(scans, ts[:n_scans] + scan_dt,
                     circle_poses_at(ts[:n_scans] + scan_dt / 2, **kin,
                                     phase=phase),
                     lacc, avel, imu_ts)
