"""PyTorch port: the grid front end's voxel hashing in both forms.

``voxel.sort_key`` (the int32 key that K9 writes on the card) gives the
permutation, points and keep mask that the int64 key (transcribed below)
gave, and JAX's ``first_in_voxel_sorted``'s; ``form="cuda"`` on CPU
tensors runs the torch code (K8's and K9's wrappers take it there) and is
bit-equal to JAX's window pre-dedup; ``kiss.register_scan`` gives the same
bits under ``icp_form="cuda"`` and ``"torch"`` on the CPU.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from ptudes_tpu.ops import voxel as jvoxel
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.models import kiss, sim
from ptudes_tpu_torch.ops import cuda_voxel, voxel
from ptudes_tpu_torch.ops.projection import scan_to_points
from ptudes_tpu_torch.utils import convert

R = dataclasses.replace


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _int64_order(pts, mask, vs):
    """The stable sort the port ran before the int32 key: by the int64
    ``(drop << 31) | hash31``; (sorted key, permutation)."""
    h = voxel.spatial_hash(voxel.voxel_coords(pts, vs), 1 << 31).to(
        torch.int64)
    return torch.sort(((~mask).to(torch.int64) << 31) | h, stable=True)


def _int64_first_in_voxel(pts, mask, vs, capacity):
    """``first_in_voxel_sorted`` as the port ran it with the int64 key."""
    n = pts.shape[-2]
    sd, perm = _int64_order(pts, mask, vs)
    d, hh = sd >> 31, sd & ((1 << 31) - 1)
    n_valid = mask.to(torch.int32).sum(-1, keepdim=True)
    if n <= capacity:
        d, hh = voxel._take_pad(d, capacity), voxel._take_pad(hh, capacity)
        out = voxel._rows(pts, voxel._take_pad(perm, capacity))
        first = torch.ones_like(d, dtype=torch.bool)
        first[..., 1:] = hh[..., 1:] != hh[..., :-1]
        keep = (d == 0) & first & (torch.arange(capacity) < n_valid)
        return torch.where(keep[..., None], out, 0.0), keep
    first = torch.ones_like(d, dtype=torch.bool)
    first[..., 1:] = hh[..., 1:] != hh[..., :-1]
    keep_full = (d == 0) & first & (torch.arange(n) < n_valid)
    head = voxel._take_pad(voxel._stable_order(
        (~keep_full).to(torch.int32)), capacity)
    out = voxel._rows(pts, torch.gather(perm, -1, head))
    count = torch.clamp(keep_full.to(torch.int32).sum(-1, keepdim=True),
                        max=capacity)
    out_mask = torch.arange(capacity) < count
    return torch.where(out_mask[..., None], out, 0.0), out_mask


def _cloud(case, seed=7, n=6000):
    """Points [n, 3] and a mask for one case: ``mixed`` (10 % masked),
    ``all_masked``, ``none_masked``, ``ties`` (every point repeated once
    further on, and many points of one voxel: equal hashes)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    if case == "all_masked":
        mask[:] = False
    elif case == "none_masked":
        mask[:] = True
    elif case == "ties":
        pts[n // 2:] = pts[:n - n // 2]
        pts[:200] = pts[0] + rng.uniform(0, 0.01, (200, 3)).astype(
            np.float32)
    return torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.mark.parametrize("case", ["mixed", "all_masked", "none_masked",
                                  "ties"])
@pytest.mark.parametrize("capacity", [8192, 2048])
def test_int32_key_is_the_int64_sort(case, capacity):
    """n <= capacity (one sort) and n > capacity (the re-compacting sort):
    the same permutation, points and keep mask as the int64 key, and as
    JAX's."""
    pts, mask = _cloud(case)
    for vs in (0.15, 0.45):
        key = voxel.sort_key(pts, mask, vs)
        assert key.dtype == torch.int32
        _eq(torch.sort(key, stable=True).indices,
            _int64_order(pts, mask, vs).indices)
        got = voxel.first_in_voxel_sorted(pts, mask, vs, capacity)
        for a, b in zip(got, _int64_first_in_voxel(pts, mask, vs, capacity)):
            _eq(a, b)
        ref = jax.jit(jvoxel.first_in_voxel_sorted, static_argnums=(2, 3))(
            pts.numpy(), mask.numpy(), vs, capacity)
        _eq(got[0], ref[0])
        _eq(got[1], ref[1])
        kernels.reset_launches()
        for a, b in zip(voxel.first_in_voxel_sorted(pts, mask, vs, capacity,
                                                    form="cuda"), got):
            _eq(a, b)
        assert kernels.LAUNCHES["voxel_key"] == 0
        if case == "all_masked":
            assert not bool(got[1].any())
        if case == "ties":
            assert int(got[1].sum()) < 0.6 * int(mask.sum())


@pytest.mark.parametrize("capacity", [8192, 2048])
def test_int32_key_replica_axis(capacity):
    """[B, N]: the keys, points and masks of each replica are its own
    call's and the int64 key's; K9's wrapper gives the same on CPU."""
    clouds = [_cloud(c, seed=s) for c, s in (("mixed", 1), ("ties", 2),
                                             ("all_masked", 3))]
    pts = torch.stack([c[0] for c in clouds])
    mask = torch.stack([c[1] for c in clouds])
    _eq(cuda_voxel.voxel_key(pts, mask, 0.15),
        voxel.sort_key(pts, mask, 0.15))
    got = voxel.first_in_voxel_sorted(pts, mask, 0.15, capacity, form="cuda")
    for a, b in zip(got, _int64_first_in_voxel(pts, mask, 0.15, capacity)):
        _eq(a, b)
    for i, (p, m) in enumerate(clouds):
        one = voxel.first_in_voxel_sorted(p, m, 0.15, capacity)
        _eq(got[0][i], one[0])
        _eq(got[1][i], one[1])


def _planted_grid(h, w, seed=3):
    """Scattered points on an h x w grid (no two window neighbours share a
    half-voxel by chance) with planted duplicates; returns (pts [h*w, 3],
    mask [h*w], what each planted pixel must do: (row, col, kept))."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (h, w, 3)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.9
    mask[0, [0, 5, w - 1]] = True
    mask[2, [w - 3, 7]] = True
    mask[1, 10] = True
    mask[0, 10] = False
    mask[h - 1, 5] = True
    # column wrap: (0, w-1) is (0, 0)'s causal neighbour at dc = -1
    pts[0, w - 1] = pts[0, 0]
    # no row wrap: (h-1, 5) is not above (0, 5), nor (0, 5) above it
    pts[h - 1, 5] = pts[0, 5]
    # (0, 8) is (2, 7)'s neighbour at dr = -2, dc = +1
    mask[0, 8] = True
    pts[2, 7] = pts[0, 8]
    # wrap at the right edge: (1, 0) is (2, w-3)'s neighbour at dr = -1,
    # dc = +3
    mask[1, 0] = True
    pts[2, w - 3] = pts[1, 0]
    # a masked neighbour drops nothing: (0, 10) is masked
    pts[1, 10] = pts[0, 10]
    want = [(0, 0, False), (0, w - 1, True), (0, 5, True), (h - 1, 5, True),
            (2, 7, False), (0, 8, True), (2, w - 3, False), (1, 10, True)]
    return (torch.from_numpy(pts.reshape(-1, 3)),
            torch.from_numpy(mask.reshape(-1)), want)


def _surface(h, w, seed=2):
    """A smooth surface so neighbouring pixels share voxels (the CPU
    parity test's)."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(-3, 3, w), np.linspace(-1, 1, h))
    pts = np.stack([u, v, 0.1 * u * v], -1).reshape(-1, 3)
    pts = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return (torch.from_numpy(pts),
            torch.from_numpy(rng.uniform(size=h * w) < 0.9))


@pytest.mark.parametrize("scene", ["planted", "surface"])
@pytest.mark.parametrize("grid", [(16, 64), (16, 32)])
def test_prededup_cuda_form_on_cpu_matches_jax(scene, grid):
    """``form="cuda"`` on CPU tensors runs the torch form and equals JAX's
    pre-dedup bit for bit: column wrap-around, the first three rows (no
    row wrap), a masked neighbour, and a W/2 grid (16 x 32)."""
    h, w = grid
    pts, mask = (_planted_grid(h, w)[:2] if scene == "planted"
                 else _surface(h, w))
    kernels.reset_launches()
    got = voxel.window_prededup_mask(pts, mask, 0.15, grid, form="cuda")
    assert kernels.LAUNCHES["grid_prededup"] == 0
    _eq(got, voxel.window_prededup_mask(pts, mask, 0.15, grid))
    ref = jax.jit(jvoxel.window_prededup_mask, static_argnums=(2, 3))(
        pts.numpy(), mask.numpy(), 0.15, grid)
    _eq(got, ref)
    if scene == "planted":
        keep = got.reshape(h, w)
        for r, c, kept in _planted_grid(h, w)[2]:
            assert bool(keep[r, c]) == kept, (r, c, kept)
    else:
        assert 0 < int(got.sum()) < int(mask.sum())


def test_prededup_replica_axis_and_window():
    """[B, H*W] through K8's wrapper on CPU: each replica's own call; a
    window other than the kernel's 4 x +-4 is refused in the cuda form."""
    grid = (16, 64)
    (p0, m0, _), (p1, m1) = _planted_grid(*grid), _surface(*grid)
    pts, mask = torch.stack([p0, p1]), torch.stack([m0, m1])
    got = cuda_voxel.grid_prededup(pts, mask, 0.15, grid)
    _eq(got[0], voxel.window_prededup_mask(p0, m0, 0.15, grid))
    _eq(got[1], voxel.window_prededup_mask(p1, m1, 0.15, grid))
    with pytest.raises(ValueError, match="4 x"):
        voxel.window_prededup_mask(p0, m0, 0.15, grid, rows=3, form="cuda")


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [y for item in x for y in _leaves(item)]


def test_register_scan_forms_match_on_cpu():
    """Three scans of a rendered 32 x 256 scene through
    ``kiss.register_scan`` at the bench configuration (cut to the scene)
    under ``icp_form="cuda"`` and ``"torch"``: the same bits (every CPU
    wrapper takes its twin, and no kernel launches)."""
    sensor = sim.make_sim_sensor(h=32, w=256, fov_deg=45.0)
    poses = sim.circle_poses_at(np.arange(4) * 0.1, radius=8.0, speed=2.0)
    world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=40,
                               keepout_points=poses[:, :3, 3])
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    base = config.bench_config()
    cfg = R(base.kiss, max_range=30.0)
    cap = R(base.cap, max_points=32 * 256, max_frame=8192,
            map_capacity=1 << 14)
    states = {f: kiss.init_state(R(cfg, icp_form=f), cap, "cpu")
              for f in ("cuda", "torch")}
    kernels.reset_launches()
    for i in range(3):
        rm = torch.from_numpy(sim.render_range_image(
            world, poses[i], sensor, max_range=60.0, noise_std=0.01,
            seed=i).astype(np.float32))
        pts, mask, ts = scan_to_points(lut, rm)
        outs = {}
        for f in ("cuda", "torch"):
            states[f], pose, aux = kiss.register_scan(
                states[f], pts, mask, ts, cfg=R(cfg, icp_form=f), cap=cap,
                grid_hw=(32, 256))
            outs[f] = (pose, aux)
        for a, b in zip(_leaves((states["cuda"], outs["cuda"])),
                        _leaves((states["torch"], outs["torch"]))):
            assert torch.equal(a, b)
    assert int(outs["cuda"][1].source_count) > 100
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
