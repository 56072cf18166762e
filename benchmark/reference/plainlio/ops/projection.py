"""Range image to points (``ptudes_tpu.ops.projection``): the per-scan
projection through the XYZ lookup table is one multiply-add."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class XyzLut(NamedTuple):
    """Direction + offset lookup (meters), staggered column order."""
    direction: torch.Tensor | np.ndarray  # [H, W, 3] f32
    offset: torch.Tensor | np.ndarray     # [H, W, 3] f32


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


