"""Fixed-capacity voxel hash map (``ptudes_tpu.ops.hashmap``).

Same layout, hashes and insert protocol, so the tables match the JAX
package bit for bit:

    meta   [C, 8] int32 — [fingerprint, count, rep_x, rep_y, rep_z, octants]
    points [C, P] int32 — points quantized to 3 x 10-bit sub-voxel offsets

JAX's out-of-range ``mode="drop"`` scatters become scatters into one spare
row appended to each column for the duration of the insert; its
``mode="fill"`` gathers become explicit masks. Claim arbitration is a
scatter-min (``scatter_reduce(..., "amin")``), so the winner of a contested
slot does not depend on scatter order. The map is updated out of place, as
in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .voxel import (INT_MAX, compact_with_payload, coord_hash, mix32,
                    recip, to_i32, voxel_coords)
META_W = 8
QBITS = 10
QSCALE = 1 << QBITS
_QMASK = QSCALE - 1


class VoxelHashMap(NamedTuple):
    meta: torch.Tensor    # [C, 8] int32
    points: torch.Tensor  # [C, P] int32


def create(capacity: int, max_points_per_voxel: int, device) -> VoxelHashMap:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return VoxelHashMap(
        meta=torch.zeros((capacity, META_W), dtype=torch.int32, device=device),
        points=torch.zeros((capacity, max_points_per_voxel),
                           dtype=torch.int32, device=device))


def pack_points(pts: torch.Tensor, coords: torch.Tensor,
                voxel_size: float) -> torch.Tensor:
    """Quantize points (..., 3) to one int32 each (offsets in the voxel)."""
    frac = pts * recip(voxel_size) - coords.to(pts.dtype)
    q = torch.clamp((frac * QSCALE).to(torch.int32), 0, _QMASK)
    return q[..., 0] | (q[..., 1] << QBITS) | (q[..., 2] << (2 * QBITS))


def unpack_points(packed: torch.Tensor, coords: torch.Tensor,
                  voxel_size: float) -> torch.Tensor:
    """Inverse of :func:`pack_points` to mid-step precision."""
    q = torch.stack([packed & _QMASK, (packed >> QBITS) & _QMASK,
                     (packed >> (2 * QBITS)) & _QMASK], -1).to(torch.float32)
    return (coords.to(torch.float32) + (q + 0.5) * (1.0 / QSCALE)) \
        * voxel_size


def _fingerprint_and_slot(coords: torch.Tensor, capacity: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(fingerprint int32, never 0; home slot int32) per voxel coord."""
    h1 = coord_hash(coords)
    slot = (mix32(h1) & (capacity - 1)).to(torch.int32)
    fp = mix32(h1 ^ 0xDEADBEEF)
    fp = torch.where(fp == 0, torch.ones_like(fp), fp)
    return to_i32(fp), slot


def neighbor_offsets(n: int, device) -> torch.Tensor:
    """The first ``n`` voxel neighbour offsets ordered by L1 norm (centre,
    6 faces, 12 edges, 8 corners; ``ptudes_tpu.ops.hashmap``'s order),
    built on ``device``: a host tensor copied in would synchronise the
    scan step."""
    g = torch.arange(27, device=device)
    o = torch.stack([g // 9 - 1, g // 3 % 3 - 1, g % 3 - 1], 1)
    order = torch.sort(o.abs().sum(1), stable=True).indices
    return o[order[:n]].to(torch.int32)


def gather_rows(table: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``table[s]`` with zero rows for ``s`` outside the table."""
    n = table.shape[0]
    rows = table[torch.clamp(s, 0, n - 1).long()]
    inside = (s >= 0) & (s < n)
    return torch.where(inside[..., None], rows, 0)


def probe(m: VoxelHashMap, keys: torch.Tensor, max_probes: int,
          miss_slot: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first fingerprint match of each voxel key [..., 3] within
    ``max_probes`` linear probes from its home slot: (slot, count,
    representative point [..., 3], found). A miss has slot ``miss_slot``,
    count 0 and representative 0."""
    cap = m.meta.shape[0]
    fp, h0 = _fingerprint_and_slot(keys, cap)
    slot = torch.full_like(fp, miss_slot)
    cnt = torch.zeros_like(fp)
    found = torch.zeros_like(fp, dtype=torch.bool)
    rep = torch.zeros(fp.shape + (3,), dtype=torch.float32, device=fp.device)
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        rows = m.meta[s.long()]
        match = (rows[..., 0] == fp) & ~found
        slot = torch.where(match, s, slot)
        cnt = torch.where(match, rows[..., 1], cnt)
        rep = torch.where(match[..., None],
                          rows[..., 2:5].contiguous().view(torch.float32),
                          rep)
        found = found | match
    return slot, cnt, rep, found


def num_points(m: VoxelHashMap) -> torch.Tensor:
    return m.meta[:, 1].sum()


def _spare(col: torch.Tensor) -> torch.Tensor:
    """``col`` with one zero row appended: the target of dropped writes."""
    return torch.cat([col, torch.zeros_like(col[:1])])


def _last_writer(idx: torch.Tensor) -> torch.Tensor:
    """Mask of the entries a sequential scatter to ``idx`` leaves in place:
    the last entry per target, as XLA's scatter writes on the CPU. Needed
    where two entries can target one cell: the frame is deduplicated in
    the sensor frame but inserted in the world frame, so two rotated
    points can share a world sub-voxel cell, and ``index_put`` does not
    order duplicate writes."""
    order = torch.sort(idx, stable=True).indices
    s = idx[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    keep = torch.empty_like(last)
    keep[order] = last
    return keep


def _popcount_below(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Number of set bits of ``bits`` below bit ``k`` (int32 SWAR)."""
    x = bits & ((torch.ones_like(k) << k) - 1)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    return (((x + (x >> 4)) & 0x0F0F0F0F) * 0x01010101) >> 24


def _insert_chunk(state, pts: torch.Tensor, payload: torch.Tensor,
                  chunk: torch.Tensor, *, voxel_size: float, max_probes: int,
                  new_capacity: int):
    """Claim + write one compacted chunk of new points into ``state``, the
    (fps, counts, occupancy, reps, points) columns with their spare rows.
    A chunk with an empty mask writes only to the spare rows. ``payload``
    is (slot, found) per point."""
    fps, counts, occ_col, reps, points = state
    cap = fps.shape[0] - 1
    ppv = points.shape[1]
    dev = pts.device
    cpts, cpay, cmask = compact_with_payload(pts, payload, chunk,
                                             new_capacity)
    cslot = torch.where(cmask, cpay[:, 0], cap)
    cfound = cmask & (cpay[:, 1] > 0)
    ccoords = voxel_coords(cpts, voxel_size)
    csub = voxel_coords(cpts, 0.5 * voxel_size) - 2 * ccoords
    csub_id = torch.where(cmask, csub[:, 0] + 2 * csub[:, 1] + 4 * csub[:, 2],
                          0)
    cfp, ch0 = _fingerprint_and_slot(ccoords, cap)
    cidx = torch.arange(new_capacity, dtype=torch.int32, device=dev)

    # claim rounds for points whose voxel does not exist yet
    resolved = ~cmask | cfound
    for r in range(max_probes):
        s = ((ch0 + r) & (cap - 1)).long()
        want = ~resolved & (fps[s] == 0)
        claim = torch.full((cap,), INT_MAX, dtype=torch.int32, device=dev)
        claim = claim.scatter_reduce(
            0, s, torch.where(want, cidx, INT_MAX), reduce="amin")
        won = want & (claim[s] == cidx)
        fps = fps.index_put((torch.where(won, s, cap),), cfp)
        match = ~resolved & (fps[s] == cfp)
        cslot = torch.where(match, s.to(torch.int32), cslot)
        resolved = resolved | match
    accept = cmask & (cslot < cap) & resolved

    # batch occupancy bits per slot (distinct octants: add == or); rank in
    # the batch = set bits below the point's own; base = stored count
    bit = torch.where(accept, torch.ones_like(csub_id) << csub_id, 0)
    tgt = torch.where(accept, cslot, cap).long()
    batch_bits = torch.zeros(cap + 1, dtype=torch.int32, device=dev
                             ).index_add_(0, tgt, bit)
    rank = _popcount_below(batch_bits[tgt], csub_id)
    write_pos = counts[cslot.long()] + rank   # spare row: count 0
    accept = accept & (write_pos < ppv)
    tgt = torch.where(accept, cslot, cap).long()

    wpos = torch.where(accept, write_pos, 0).long()
    points = points.index_put(
        (torch.where(_last_writer(tgt * ppv + wpos), tgt, cap), wpos),
        pack_points(cpts, ccoords, voxel_size))
    counts = counts.index_add(0, tgt, accept.to(torch.int32))
    occ_col = occ_col.index_add(
        0, tgt, torch.where(accept, torch.ones_like(csub_id) << csub_id, 0))
    rep_tgt = torch.where(accept & (write_pos == 0), cslot, cap).long()
    rep_tgt = torch.where(_last_writer(rep_tgt), rep_tgt, cap)
    reps = reps.index_put((rep_tgt,), cpts.view(torch.int32))
    return fps, counts, occ_col, reps, points


def insert_deduped(m: VoxelHashMap, pts: torch.Tensor, mask: torch.Tensor,
                   *, voxel_size: float, max_probes: int = 2,
                   new_capacity: int = 8192, overflow: bool | str = True,
                   evict_origin: torch.Tensor | None = None,
                   evict_r2: torch.Tensor | None = None) -> VoxelHashMap:
    """Occupancy-deduped insert of points unique at voxel_size/2, with the
    distance eviction fused into the meta rebuild.

    The new points go in chunks of ``new_capacity``. ``overflow=True`` or
    ``"cond"``: every new point, the first chunk holding the first
    ``new_capacity`` of them and the rest following chunk by chunk (the
    exact insert). ``overflow=False``: one chunk, the new points decimated
    evenly to ``new_capacity``; the rest retry on the next scan.

    The JAX package runs the overflow chunks in a loop whose trip count
    depends on the data (under a ``lax.cond`` for ``"cond"``). Here all
    ``ceil(len(pts) / new_capacity) - 1`` of them always run, each masked
    to its slice of the new points, so the step never reads the count on
    the host; a chunk with no points writes only to the spare rows, so the
    tables are the same, and ``True`` and ``"cond"`` are one path.
    """
    cap, ppv = m.meta.shape[0], m.points.shape[1]
    n = pts.shape[0]
    assert ppv >= 8 and cap & (cap - 1) == 0
    n_chunks = -(-n // new_capacity)
    dev = pts.device

    coords = voxel_coords(pts, voxel_size)
    sub = voxel_coords(pts, 0.5 * voxel_size) - 2 * coords
    sub_id = sub[:, 0] + 2 * sub[:, 1] + 4 * sub[:, 2]
    fp, h0 = _fingerprint_and_slot(coords, cap)

    # phase A: one meta-row gather per probe -> fingerprint + occupancy
    slot = torch.full((n,), cap, dtype=torch.int32, device=dev)
    occ = torch.zeros((n,), dtype=torch.int32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    free_seen = torch.zeros((n,), dtype=torch.bool, device=dev)
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        rows = m.meta[s.long()]
        match = (rows[:, 0] == fp) & ~found
        slot = torch.where(match, s, slot)
        occ = torch.where(match, rows[:, 5], occ)
        found = found | match
        free_seen = free_seen | (rows[:, 0] == 0)
    # storable-new points: a free octant of an existing voxel, or a free
    # slot to claim somewhere in the probe chain
    is_new = mask & torch.where(found, ((occ >> sub_id) & 1) == 0, free_seen)
    new_pos = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    chunk_den = new_capacity
    if overflow is not False or n_chunks == 1:
        first = is_new & (new_pos < chunk_den)
    else:
        assert n * new_capacity < 2 ** 31
        n_new = torch.clamp(is_new.to(torch.int32).sum(), min=1)
        first = is_new & (torch.remainder(new_pos * new_capacity, n_new)
                          < new_capacity)

    payload = torch.stack([slot, found.to(torch.int32)], 1)
    state = (_spare(m.meta[:, 0]), _spare(m.meta[:, 1]),
             _spare(m.meta[:, 5]), _spare(m.meta[:, 2:5]), _spare(m.points))
    kw = dict(voxel_size=voxel_size, max_probes=max_probes,
              new_capacity=new_capacity)
    state = _insert_chunk(state, pts, payload, first, **kw)

    def chunk(lo):
        return _insert_chunk(
            state, pts, payload,
            is_new & (new_pos >= lo) & (new_pos < lo + chunk_den), **kw)

    if overflow is not False:
        for c in range(1, n_chunks):
            state = chunk(c * chunk_den)

    fps, counts, occ_col, reps, points = (x[:cap] for x in state)
    if evict_origin is not None:
        d2 = torch.sum((reps.view(torch.float32) - evict_origin) ** 2, -1)
        evict = (counts > 0) & (d2 > evict_r2)
        fps = torch.where(evict, 0, fps)
        counts = torch.where(evict, 0, counts)
        occ_col = torch.where(evict, 0, occ_col)
    meta = torch.cat([fps[:, None], counts[:, None], reps, occ_col[:, None],
                      m.meta[:, 6:]], 1)
    return VoxelHashMap(meta=meta, points=points)


def argmin_select(d2: torch.Tensor, pts3: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min of ``d2`` [M, K] over K, the point of ``pts3`` [M, K, 3] at its
    first argmin)."""
    dmin, j = torch.min(d2, -1, keepdim=True)
    nn = pts3.gather(1, j[..., None].expand(-1, 1, 3))[:, 0]
    return dmin[:, 0], nn


