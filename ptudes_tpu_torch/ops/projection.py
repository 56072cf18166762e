"""Range image to points (``ptudes_tpu.ops.projection``).

The XYZ lookup table is built on the host with numpy
(:func:`make_xyz_lut_np`, the Ouster legacy-frame model) and moved to the
device once (:func:`make_xyz_lut`, or ``utils.convert.lut_from_numpy`` for
a table already built); the per-scan projection is one multiply-add.
:func:`reduce_active_beams_mask` keeps a subset of the beam rows (the
commands' ``--beams``); :func:`destagger` shifts each row of a channel
image by its beam's pixel offset (the ``viz`` command's images).
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


def make_xyz_lut(w: int, h: int, beam_altitude_deg, beam_azimuth_deg,
                 lidar_origin_to_beam_origin_mm: float = 0.0,
                 lidar_to_sensor_transform=None, extrinsic=None, *,
                 device="cuda") -> XyzLut:
    """The projection LUT as f32 tensors on ``device`` (the card unless the
    caller asks for another): :func:`make_xyz_lut_np` in f64 on the host,
    then cast, as ``ptudes_tpu.ops.projection.make_xyz_lut`` does."""
    direction, offset = make_xyz_lut_np(
        w, h, beam_altitude_deg, beam_azimuth_deg,
        lidar_origin_to_beam_origin_mm, lidar_to_sensor_transform,
        extrinsic)
    return XyzLut(*(torch.tensor(x.astype(np.float32), device=device)
                    for x in (direction, offset)))


def scan_to_points(lut: XyzLut, range_m: torch.Tensor, decimate: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range image [H, W] (0 = no return) -> flat points [H*W/d, 3], mask
    [H*W/d] and per-column normalized timestamps [H*W/d] in [0, 1).

    ``decimate`` d > 1 keeps, per beam row, the first valid return of each
    group of d adjacent columns: its exact direction, offset, range and
    column timestamp (column 0 of the group where none is valid, masked
    out). A leading replica axis ([B, H, W]) gives [B, ...] outputs."""
    lead, (h, w) = range_m.shape[:-2], range_m.shape[-2:]
    dev = range_m.device
    if decimate == 1:
        pts = (lut.direction * range_m[..., None]
               + lut.offset).reshape(lead + (h * w, 3))
        mask = (range_m > 0).reshape(lead + (h * w,))
        ts = (torch.arange(w, dtype=torch.float32, device=dev) / w).repeat(h)
        return pts, mask, ts.expand(lead + (h * w,))
    if decimate < 1 or w % decimate:
        raise ValueError(f"decimate {decimate} must divide the width {w}")
    g = w // decimate
    rm = range_m.reshape(lead + (h, g, decimate))
    valid = rm > 0
    col = torch.arange(decimate, device=dev)
    k = torch.where(valid, col, decimate).amin(-1)
    k = torch.where(k == decimate, 0, k)                   # [..., h, g]
    r = rm.gather(-1, k[..., None])[..., 0]
    kk = k[..., None, None].expand(lead + (h, g, 1, 3))

    def pick(x):
        x = x.reshape(h, g, decimate, 3).expand(lead + (h, g, decimate, 3))
        return x.gather(-2, kk)[..., 0, :]

    pts = (pick(lut.direction) * r[..., None]
           + pick(lut.offset)).reshape(lead + (h * g, 3))
    mask = valid.any(-1).reshape(lead + (h * g,))
    cols = torch.arange(g, device=dev)[None, :] * decimate + k
    ts = (cols.to(torch.float32) / w).reshape(lead + (h * g,))
    return pts, mask, ts


def destagger(field: torch.Tensor, pixel_shift_by_row) -> torch.Tensor:
    """Each row of ``field`` [H, W, ...] rolled right by its per-beam
    offset ``pixel_shift_by_row`` [H] (ouster-sdk ``client.destagger``;
    ``ptudes_tpu.ops.projection.destagger``'s ``jnp.roll`` per row), as one
    gather: ``out[r, c] = field[r, (c - shift[r]) mod W]``."""
    h, w = field.shape[:2]
    shift = torch.as_tensor(np.asarray(pixel_shift_by_row),
                            device=field.device).to(torch.int64)
    cols = torch.remainder(
        torch.arange(w, device=field.device)[None, :] - shift[:, None], w)
    idx = cols.reshape((h, w) + (1,) * (field.dim() - 2)).expand(field.shape)
    return torch.gather(field, 1, idx)


def reduce_active_beams_mask(h: int, beams_num: int) -> np.ndarray:
    """Row mask keeping ``beams_num`` uniformly spaced beams of ``h`` (a
    copy of ``ptudes_tpu.ops.projection.reduce_active_beams_mask``: the
    reference zeroes the other rows to simulate a low-resolution sensor)."""
    keep = np.zeros(h, dtype=bool)
    keep[np.linspace(0, h, num=beams_num, endpoint=False, dtype=int)] = True
    return keep
