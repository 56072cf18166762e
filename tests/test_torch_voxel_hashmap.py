"""PyTorch port: the integer stages against the JAX package, bit for bit.

Hashes, fingerprints, the window pre-dedup, compaction (with even
decimation), the sort-based first-in-voxel dedup and the hash-map tables
after a bootstrap insert plus steady decimated inserts with eviction must
all be identical. The JAX side runs under ``jax.jit``, as in the pipeline:
XLA then compiles a division by a constant voxel size as a multiplication
by its f32 reciprocal, which the port reproduces.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.ops import hashmap as jhashmap
from ptudes_tpu.ops import voxel as jvoxel
from ptudes_tpu_torch.ops import hashmap, voxel

torch.set_num_threads(2)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _cloud(seed, n=20000, scale=20.0, valid=0.9):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return pts, rng.uniform(size=n) < valid


def test_hashes_and_coords_bit_exact():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2 ** 20, 2 ** 20, (5000, 3)).astype(np.int32)
    coords[:4] = [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 7],
                  [-2 ** 31, 2 ** 31 - 1, -5]]
    c_t = torch.from_numpy(coords)
    for size in (1 << 16, 1 << 31):
        _eq(voxel.spatial_hash(c_t, size),
            jvoxel.spatial_hash(jnp.asarray(coords), size))
    fp, slot = hashmap._fingerprint_and_slot(c_t, 1 << 19)
    jfp, jslot = jhashmap._fingerprint_and_slot(jnp.asarray(coords), 1 << 19)
    _eq(fp, jfp)
    _eq(slot, jslot)
    pts, _ = _cloud(1)
    t = torch.from_numpy(pts)
    for vs in (0.15, 0.3, 0.45):
        _eq(voxel.voxel_coords(t, vs),
            jax.jit(jvoxel.voxel_coords, static_argnums=1)(pts, vs))
        # packed as the insert packs: coordinates computed in the same jit
        # (XLA's fusion then rounds p / vs before subtracting them)
        _eq(hashmap.pack_points(t, voxel.voxel_coords(t, vs), vs),
            jax.jit(lambda p, vs=vs: jhashmap.pack_points(
                p, jvoxel.voxel_coords(p, vs), vs))(pts))


def test_window_prededup_bit_exact():
    rng = np.random.default_rng(2)
    h, w = 16, 64
    # a smooth surface so neighbouring pixels share voxels
    u, v = np.meshgrid(np.linspace(-3, 3, w), np.linspace(-1, 1, h))
    pts = np.stack([u, v, 0.1 * u * v], -1).reshape(-1, 3)
    pts = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    mask = rng.uniform(size=h * w) < 0.9
    got = voxel.window_prededup_mask(torch.from_numpy(pts),
                                     torch.from_numpy(mask), 0.15, (h, w))
    ref = jax.jit(jvoxel.window_prededup_mask, static_argnums=(2, 3))(
        pts, mask, 0.15, (h, w))
    _eq(got, ref)
    assert 0 < int(got.sum()) < int(mask.sum())


@pytest.mark.parametrize("capacity,decimate", [
    (4096, False), (4096, True), (30000, True)])
def test_compact_bit_exact(capacity, decimate):
    pts, mask = _cloud(3)
    out, m = voxel.compact(torch.from_numpy(pts), torch.from_numpy(mask),
                           capacity, decimate_overflow=decimate)
    jout, jm = jax.jit(jvoxel.compact, static_argnums=(2, 3, 4))(
        pts, mask, capacity, 0.0, decimate)
    _eq(out, jout)
    _eq(m, jm)


def test_compact_with_payload_bit_exact():
    pts, mask = _cloud(4)
    pay = np.random.default_rng(4).integers(0, 1000, (len(pts), 2)).astype(
        np.int32)
    got = voxel.compact_with_payload(torch.from_numpy(pts),
                                     torch.from_numpy(pay),
                                     torch.from_numpy(mask), 8192)
    ref = jax.jit(jvoxel.compact_with_payload, static_argnums=3)(
        pts, pay, mask, 8192)
    for a, b in zip(got, ref):
        _eq(a, b)


@pytest.mark.parametrize("capacity", [32768, 4096])
def test_first_in_voxel_sorted_bit_exact(capacity):
    # 20000 points: the single-sort path (fits) and the re-compacting path
    pts, mask = _cloud(5)
    for vs in (0.15, 0.45):
        got = voxel.first_in_voxel_sorted(
            torch.from_numpy(pts), torch.from_numpy(mask), vs, capacity)
        ref = jax.jit(jvoxel.first_in_voxel_sorted, static_argnums=(2, 3))(
            pts, mask, vs, capacity)
        _eq(got[0], ref[0])
        _eq(got[1], ref[1])


def test_map_tables_bit_exact_after_bootstrap_and_steady_inserts():
    """One bootstrap insert (whole frame, one chunk) then steady inserts
    decimated to a small budget, each with the fused eviction, from frames
    that drift and turn across the map so voxels get evicted, slots
    reused and cells written twice."""
    cap, ppv, vs = 1 << 14, 8, 0.3
    frame = 8192
    jins = jax.jit(jhashmap.insert_deduped,
                   static_argnames=("voxel_size", "max_probes",
                                    "new_capacity", "overflow"))
    jm = jhashmap.create(cap, ppv)
    pm = hashmap.create(cap, ppv, "cpu")
    rng = np.random.default_rng(6)
    for step in range(6):
        origin = np.array([1.5 * step, 0.5 * step, 0.0], np.float32)
        raw = rng.uniform(-12, 12, (20000, 3)).astype(np.float32)
        pts, keep = jax.jit(jvoxel.first_in_voxel_sorted,
                            static_argnums=(2, 3))(
            raw, np.ones(len(raw), bool), 0.5 * vs, frame)
        # deduped in the sensor frame, inserted in the world frame: as in
        # the pipeline, rotated points can share a half-voxel cell, and
        # the later of two writes to one cell must win on both sides
        a = 0.3 * step + 0.1
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], np.float32)
        pts, keep = np.asarray(pts) @ rot.T + origin, np.array(keep)
        boot = step == 0
        kw = dict(voxel_size=vs, max_probes=2,
                  new_capacity=frame if boot else 1024, overflow=boot)
        r2 = np.float32(100.0)
        jm = jins(jm, pts, keep, evict_origin=jnp.asarray(origin),
                  evict_r2=jnp.asarray(r2), **kw)
        pm = hashmap.insert_deduped(
            pm, torch.from_numpy(pts), torch.from_numpy(keep),
            evict_origin=torch.from_numpy(origin),
            evict_r2=torch.tensor(r2), **kw)
        _eq(pm.meta, jm.meta)
        _eq(pm.points, jm.points)
        assert int(hashmap.num_points(pm)) == int(jhashmap.num_points(jm))
    # evicted slots keep their representative as dead storage
    evicted = (pm.meta[:, 1] == 0) & (pm.meta[:, 2:5] != 0).any(1)
    assert int(evicted.sum()) > 100 and int(hashmap.num_points(pm)) > 1000


@pytest.mark.parametrize("overflow", [True, "cond"])
def test_shared_octant_counts_past_the_row_as_in_jax(overflow):
    """A fault of the reference that the port keeps (the map count that
    passes its row of points). The occupancy-deduped insert takes points
    unique at half a voxel, but the frame is deduplicated in the sensor
    frame and inserted in the world frame, so two points can share a world
    octant. Both then rank 0 in it: both are accepted at the voxel's next
    row (one point stored, the last writer), the count grows by two, and
    the octant bit added twice carries into the next bit, which frees the
    octant for later frames. With the voxel one point short of its row the
    count passes the row. JAX's insert does the same: the tables are bit
    for bit JAX's, and the count is one past the row in both."""
    cap, ppv, vs = 1 << 8, 8, 0.3
    jins = jax.jit(jhashmap.insert_deduped,
                   static_argnames=("voxel_size", "max_probes",
                                    "new_capacity", "overflow"))
    kw = dict(voxel_size=vs, max_probes=2, new_capacity=16,
              overflow=overflow)
    # voxel (0, 0, 0): one point in each of octants 0-6, then a frame with
    # two points in octant 7 and a point of another voxel
    octant = np.array([[(k >> i) & 1 for i in range(3)] for k in range(7)])
    first = (0.05 + 0.15 * octant).astype(np.float32)
    second = np.array([[0.20, 0.20, 0.20], [0.26, 0.22, 0.21],
                       [1.05, 0.05, 0.05]], np.float32)
    jm = jhashmap.create(cap, ppv)
    pm = hashmap.create(cap, ppv, "cpu")
    for pts in (first, second, first[:1] + 0.01):
        keep = np.ones(len(pts), bool)
        jm = jins(jm, pts, keep, **kw)
        pm = hashmap.insert_deduped(pm, torch.from_numpy(pts),
                                    torch.from_numpy(keep), **kw)
        _eq(pm.meta, jm.meta)
        _eq(pm.points, jm.points)
    counts = np.asarray(pm.meta[:, 1])
    assert counts.max() == ppv + 1 and np.asarray(jm.meta[:, 1]).max() \
        == ppv + 1
    assert int(hashmap.num_points(pm)) == int(jhashmap.num_points(jm)) \
        == ppv + 1 + 1


def test_unpack_points_matches_jax():
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 2 ** 30, (100, 8)).astype(np.int32)
    coords = rng.integers(-50, 50, (100, 1, 3)).astype(np.int32)
    _eq(hashmap.unpack_points(torch.from_numpy(packed),
                              torch.from_numpy(coords), 0.3),
        jax.jit(partial(jhashmap.unpack_points, voxel_size=0.3))(
            packed, coords))
