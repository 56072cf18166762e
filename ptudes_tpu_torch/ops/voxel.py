"""Static-shape voxel downsampling (``ptudes_tpu.ops.voxel``).

Outputs match the JAX package bit for bit on the same inputs. The hashes
are uint32 wraparound multiplies with logical shifts; PyTorch's int32
``>>`` is arithmetic, so they run in int64 masked to 32 bits. The stable
multi-key ``lax.sort`` becomes one stable ``torch.sort`` on a combined
int64 key. Nothing here synchronises with the host: every shape is static.

The grid front end (:func:`range_clip_mask`, :func:`window_prededup_mask`,
:func:`compact`, :func:`first_in_voxel_sorted`) also takes a leading
replica axis ([B, N, 3] points, [B, N] masks): each replica's row is
sorted and compacted on its own, in the same launches for all of them.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
INT_MAX = 2 ** 31 - 1
_H1, _H2, _H3 = 73856093, 19349669, 83492791
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
_G1, _G2 = 0x9E3779B9, 0x517CC1B7


def recip(x: float) -> float:
    """1/x rounded to f32. XLA compiles a division by a constant as a
    multiplication by this reciprocal, so the port multiplies by it too:
    voxel coordinates and quantized points then match the compiled JAX
    pipeline bit for bit (PyTorch's CUDA division by a scalar does the
    same, its CPU division does not)."""
    return float(np.float32(1.0) / np.float32(x))


def voxel_coords(pts: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Points (..., 3) -> int32 voxel coordinates (..., 3)."""
    return torch.floor(pts * recip(voxel_size)).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (any sign) -> its uint32 value held in int64."""
    return x.to(torch.int64) & _M32


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64, without int64
    overflow: split c into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, _C1)
    h = h ^ (h >> 13)
    h = mul32(h, _C2)
    return h ^ (h >> 16)


def to_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def coord_hash(coords: torch.Tensor) -> torch.Tensor:
    """The per-axis-mixed 32-bit hash of int32 voxel coords (..., 3)."""
    c = u32(coords)
    return (mix32(mul32(c[..., 0], _H1))
            ^ mul32(mix32(mul32(c[..., 1], _H2)), _G1)
            ^ mul32(mix32(mul32(c[..., 2], _H3)), _G2))


def spatial_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """3D spatial hash -> int32 in [0, table_size)."""
    return (mix32(coord_hash(coords)) & (table_size - 1)).to(torch.int32)


def window_prededup_mask(pts: torch.Tensor, mask: torch.Tensor,
                         voxel_size: float, grid_hw: tuple[int, int],
                         rows: int = 4, cols: int = 4) -> torch.Tensor:
    """Drop points whose voxel id also appears at a causally earlier pixel
    within a (rows x +-cols) range-image window. Columns wrap, rows do not."""
    h, w = grid_hw
    lead = mask.shape[:-1]
    ids = spatial_hash(voxel_coords(pts, voxel_size), 1 << 31).reshape(
        lead + (h, w))
    m = mask.reshape(lead + (h, w))
    keep = m
    row = torch.arange(h, device=pts.device)
    for dr in range(0, -rows, -1):
        for dc in range(-cols, cols + 1):
            if dr == 0 and dc >= 0:
                continue
            sh_ids = torch.roll(ids, (-dr, -dc), dims=(-2, -1))
            sh_m = torch.roll(m, (-dr, -dc), dims=(-2, -1))
            if dr != 0:
                sh_m = sh_m & (row >= -dr)[:, None]
            keep = keep & ~((sh_ids == ids) & sh_m)
    return keep.reshape(lead + (h * w,))


def first_in_voxel_mask(pts: torch.Tensor, mask: torch.Tensor,
                        voxel_size: float, table_size: int) -> torch.Tensor:
    """The first valid point of each voxel (scan order) through a
    ``table_size`` scratch table: each point's index is scatter-min'ed into
    its voxel's ``spatial_hash`` slot, and a point survives iff it holds
    its slot. Two voxels sharing a slot keep only the earlier one's first
    point, as in the JAX package."""
    n = pts.shape[0]
    slots = spatial_hash(voxel_coords(pts, voxel_size), table_size).long()
    idx = torch.arange(n, dtype=torch.int32, device=pts.device)
    cand = torch.where(mask, idx, INT_MAX)
    table = torch.full((table_size,), INT_MAX, dtype=torch.int32,
                       device=pts.device)
    table = table.scatter_reduce(0, slots, cand, reduce="amin",
                                 include_self=True)
    return mask & (table[slots] == idx)


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float, capacity: int, table_size: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """First point per voxel (:func:`first_in_voxel_mask`), compacted into a
    [capacity, 3] buffer in scan order."""
    keep = first_in_voxel_mask(pts, mask, voxel_size, table_size)
    return compact(pts, keep, capacity)


def _take_pad(col: torch.Tensor, capacity: int) -> torch.Tensor:
    """First ``capacity`` entries of the last axis, zero-padded if short."""
    if col.shape[-1] >= capacity:
        return col[..., :capacity]
    pad = torch.zeros(col.shape[:-1] + (capacity - col.shape[-1],),
                      dtype=col.dtype, device=col.device)
    return torch.cat([col, pad], -1)


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    """Permutation of a stable ascending sort of ``key`` (last axis)."""
    return torch.sort(key, stable=True).indices


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` of each replica: rows [..., N, K] picked by [..., M]."""
    if idx.dim() == 1:
        return x[idx]
    return torch.gather(x, -2, idx[..., None].expand(
        idx.shape + x.shape[-1:]))


def compact(pts: torch.Tensor, mask: torch.Tensor, capacity: int,
            decimate_overflow: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack masked points to the front of a [capacity, 3] buffer, in order.

    ``decimate_overflow``: when more than ``capacity`` points are masked,
    keep position p iff ``(p * capacity) % n_keep < capacity`` — evenly
    spread survivors instead of a truncated tail."""
    if decimate_overflow:
        assert pts.shape[-2] * capacity < 2 ** 31
        pos = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32) - 1
        n_keep = torch.clamp(pos[..., -1:] + 1, min=1)
        mask = mask & (torch.remainder(pos * capacity, n_keep) < capacity)
    head = _take_pad(_stable_order((~mask).to(torch.int32)), capacity)
    out = _rows(pts, head)
    count = torch.clamp(mask.to(torch.int32).sum(-1, keepdim=True),
                        max=capacity)
    out_mask = torch.arange(capacity, device=pts.device) < count
    return torch.where(out_mask[..., None], out, 0.0), out_mask


def compact_with_payload(pts: torch.Tensor, payload: torch.Tensor,
                         mask: torch.Tensor, capacity: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`compact` carrying an [N, K] integer payload."""
    head = _take_pad(_stable_order((~mask).to(torch.int32)), capacity)
    count = torch.clamp(mask.to(torch.int32).sum(), max=capacity)
    out_mask = torch.arange(capacity, device=pts.device) < count
    out = torch.where(out_mask[:, None], pts[head], 0.0)
    outp = torch.where(out_mask[:, None], payload[head], 0)
    return out, outp, out_mask


def first_in_voxel_sorted(pts: torch.Tensor, mask: torch.Tensor,
                          voxel_size: float, capacity: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """First point per voxel (scan order) via one stable sort by
    (dropped, 31-bit voxel hash); returns the reordered points and their
    keep mask at ``capacity`` width."""
    n = pts.shape[-2]
    h = spatial_hash(voxel_coords(pts, voxel_size), 1 << 31).to(torch.int64)
    drop = (~mask).to(torch.int64)
    sd, perm = torch.sort((drop << 31) | h, stable=True)
    d, hh = sd >> 31, sd & ((1 << 31) - 1)
    n_valid = mask.to(torch.int32).sum(-1, keepdim=True)
    if n <= capacity:
        d, hh = _take_pad(d, capacity), _take_pad(hh, capacity)
        out = _rows(pts, _take_pad(perm, capacity))
        first = torch.ones_like(d, dtype=torch.bool)
        first[..., 1:] = hh[..., 1:] != hh[..., :-1]
        in_range = torch.arange(capacity, device=pts.device) < n_valid
        keep = (d == 0) & first & in_range
        return torch.where(keep[..., None], out, 0.0), keep
    first = torch.ones_like(d, dtype=torch.bool)
    first[..., 1:] = hh[..., 1:] != hh[..., :-1]
    in_range = torch.arange(n, device=pts.device) < n_valid
    keep_full = (d == 0) & first & in_range
    head = _take_pad(_stable_order((~keep_full).to(torch.int32)), capacity)
    out = _rows(pts, torch.gather(perm, -1, head))
    count = torch.clamp(keep_full.to(torch.int32).sum(-1, keepdim=True),
                        max=capacity)
    out_mask = torch.arange(capacity, device=pts.device) < count
    return torch.where(out_mask[..., None], out, 0.0), out_mask


def range_clip_mask(pts: torch.Tensor, mask: torch.Tensor,
                    min_range: float, max_range: float) -> torch.Tensor:
    d2 = torch.sum(pts * pts, -1)
    return mask & (d2 >= min_range * min_range) & (d2 <= max_range * max_range)
