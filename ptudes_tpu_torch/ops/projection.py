"""Range image to points (``ptudes_tpu.ops.projection``).

The XYZ lookup table is built on the host with numpy
(:func:`make_xyz_lut_np`, the Ouster legacy-frame model) and moved to the
device once (``utils.convert.lut_from_numpy``); the per-scan projection is
one multiply-add.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class XyzLut(NamedTuple):
    """Direction + offset lookup (meters), staggered column order."""
    direction: torch.Tensor | np.ndarray  # [H, W, 3] f32
    offset: torch.Tensor | np.ndarray     # [H, W, 3] f32


def make_xyz_lut_np(w: int, h: int, beam_altitude_deg, beam_azimuth_deg,
                    lidar_origin_to_beam_origin_mm: float = 0.0,
                    lidar_to_sensor_transform=None, extrinsic=None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The projection LUT on the host, (direction, offset) numpy f64 —
    a copy of ``ptudes_tpu.ops.projection.make_xyz_lut_np``."""
    alt = np.asarray(beam_altitude_deg, np.float64) * (np.pi / 180.0)
    azi = np.asarray(beam_azimuth_deg, np.float64) * (np.pi / 180.0)
    assert alt.shape == (h,) and azi.shape == (h,)
    m = np.arange(w, dtype=np.float64)
    theta_enc = 2.0 * np.pi * (1.0 - m / w)
    theta = theta_enc[None, :] - azi[:, None]
    phi = np.broadcast_to(alt[:, None], (h, w))
    direction = np.stack(
        [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
         np.sin(phi)], axis=-1)
    n_m = float(lidar_origin_to_beam_origin_mm) / 1000.0
    beam_origin = n_m * np.stack(
        [np.broadcast_to(np.cos(theta_enc), (h, w)),
         np.broadcast_to(np.sin(theta_enc), (h, w)), np.zeros((h, w))],
        axis=-1)
    offset = beam_origin - n_m * direction
    tf = np.eye(4)
    if lidar_to_sensor_transform is not None:
        lt = np.array(lidar_to_sensor_transform, np.float64).reshape(4, 4)
        lt = lt.copy()
        lt[:3, 3] /= 1000.0
        tf = lt
    if extrinsic is not None:
        tf = np.array(extrinsic, np.float64).reshape(4, 4) @ tf
    r3, t3 = tf[:3, :3], tf[:3, 3]
    return direction @ r3.T, offset @ r3.T + t3


def scan_to_points(lut: XyzLut, range_m: torch.Tensor, decimate: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range image [H, W] (0 = no return) -> flat points [H*W/d, 3], mask
    [H*W/d] and per-column normalized timestamps [H*W/d] in [0, 1).

    ``decimate`` d > 1 keeps, per beam row, the first valid return of each
    group of d adjacent columns: its exact direction, offset, range and
    column timestamp (column 0 of the group where none is valid, masked
    out)."""
    h, w = range_m.shape
    dev = range_m.device
    if decimate == 1:
        pts = (lut.direction * range_m[..., None]
               + lut.offset).reshape(h * w, 3)
        mask = (range_m > 0).reshape(h * w)
        ts = (torch.arange(w, dtype=torch.float32, device=dev) / w).repeat(h)
        return pts, mask, ts
    if decimate < 1 or w % decimate:
        raise ValueError(f"decimate {decimate} must divide the width {w}")
    g = w // decimate
    rm = range_m.reshape(h, g, decimate)
    valid = rm > 0
    col = torch.arange(decimate, device=dev)
    k = torch.where(valid, col, decimate).amin(-1)
    k = torch.where(k == decimate, 0, k)                   # [h, g]
    r = rm.gather(-1, k[..., None])[..., 0]
    kk = k[..., None, None].expand(h, g, 1, 3)
    d = lut.direction.reshape(h, g, decimate, 3).gather(2, kk)[:, :, 0]
    o = lut.offset.reshape(h, g, decimate, 3).gather(2, kk)[:, :, 0]
    pts = (d * r[..., None] + o).reshape(h * g, 3)
    mask = valid.any(-1).reshape(h * g)
    cols = torch.arange(g, device=dev)[None, :] * decimate + k
    ts = (cols.to(torch.float32) / w).reshape(h * g)
    return pts, mask, ts
