"""PyTorch port: the fused candidate gather (K6) and the plane moments (K7)
against the JAX package.

K6's twin (``cuda_gather.gather_prep_fused_torch``) is held to JAX's
``gather_prep_fused`` in interpret mode on tests/test_pallas_gather.py's
scene at that file's bars: ``inf`` bit for bit, candidate coordinates on
valid slots 1e-6, centroid 1e-5, mask exact, quality 2e-2, normal |dot|
> 0.995 where quality > 0.3. The kernel's select rule (a matched
neighbour's rank is the number of matched neighbours with a smaller
(distance, index); ranks below V are the selection, the rest neighbour 0
with count 0), transcribed into torch here, is held bit for bit to the
select twin on hand-built maps with exact distance ties, with fewer than
V matches and with none. The port's ``register_frame_cached`` with
``fused_gather`` (CPU tensors: K6's and K4's twins) is held to JAX's fused
gather and fused loop at tests/test_pallas_icp.py's bars. K7's twin is
held to ``plane_moments_pallas`` in interpret mode on
tests/test_pallas_gn.py's scene: the count row exact, the other rows
within 1e-5 of each row's largest magnitude.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.geom import se3 as jse3
from ptudes_tpu.ops import hashmap as jhashmap
from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops import voxel as jvoxel
from ptudes_tpu.ops.pallas_gather import gather_prep_fused
from ptudes_tpu.ops.pallas_gn import plane_moments_pallas
from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.ops import cuda_gather, cuda_gn, hashmap, icp
from ptudes_tpu_torch.ops.voxel import voxel_coords
from test_pallas_gather import VS, _make_map, _make_queries
from test_pallas_icp import _run, _setup

torch.set_num_threads(2)


def _port_map(m):
    return hashmap.VoxelHashMap(torch.from_numpy(np.array(m.meta)),
                                torch.from_numpy(np.array(m.points)))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gather_scene():
    m, pts = _make_map()
    src, mask, t = _make_queries(pts)
    return (m, src, mask, t), (_port_map(m), _t(src), _t(mask), _t(t))


def _fused_both(scene, neighborhood, max_probes, loss):
    (m, src, mask, t), (pm, tsrc, tmask, tt) = scene
    kw = dict(voxel_size=VS, max_probes=max_probes,
              neighborhood=neighborhood, n_voxels=4, plane_radius=1.5 * VS,
              loss=loss)
    ref = gather_prep_fused(m, src, mask, t, interpret=True, **kw)
    kernels.reset_launches()
    got = cuda_gather.gather_prep_fused(pm, tsrc, tmask, tt, **kw)
    assert kernels.LAUNCHES["gather_fused"] == 0    # CPU tensors: the twin
    return got, ref


@pytest.mark.parametrize("neighborhood,max_probes", [(7, 1), (7, 2),
                                                     (27, 2)])
def test_fused_gather_twin_matches_pallas(gather_scene, neighborhood,
                                          max_probes):
    got, ref = _fused_both(gather_scene, neighborhood, max_probes, "plane")
    inf = np.asarray(ref.inf)
    np.testing.assert_array_equal(got.inf.numpy(), inf)
    valid = inf == 0.0
    assert valid.sum() > 1000
    for a, b in ((got.cx, ref.cx), (got.cy, ref.cy), (got.cz, ref.cz)):
        np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid],
                                   rtol=0, atol=1e-6)
    feat, rfeat = got.feat.numpy(), np.asarray(ref.feat)
    np.testing.assert_allclose(feat[3:6], rfeat[3:6], atol=1e-5)
    np.testing.assert_array_equal(feat[7], rfeat[7])
    np.testing.assert_allclose(feat[6], rfeat[6], atol=2e-2)
    good = rfeat[6] > 0.3
    assert good.any()
    dots = np.abs(np.sum(feat[:3, good] * rfeat[:3, good], 0))
    assert dots.min() > 0.995, dots.min()


def test_fused_gather_point_loss_feat(gather_scene):
    got, ref = _fused_both(gather_scene, 7, 1, "point")
    f = got.feat.numpy()
    np.testing.assert_array_equal(f, np.asarray(ref.feat))
    assert (f[:6] == 0).all() and (f[6] == -1.0).all()
    np.testing.assert_array_equal(f[7].astype(bool),
                                  np.asarray(gather_scene[0][2]))
    np.testing.assert_array_equal(got.inf.numpy(), np.asarray(ref.inf))


def test_fused_radius_is_squared_in_f64():
    """K6 squares the patch radius in f64 before the f32 cast, K3 in f32:
    one ulp apart at the CLI's 1.05 m."""
    assert cuda_gather.fused_radius2(0.6) == cuda_gn._radius2(0.6)
    assert cuda_gather.fused_radius2(1.05) == float(np.float32(1.1025))
    assert cuda_gn._radius2(1.05) == float(np.float32(1.05) ** 2)
    assert cuda_gather.fused_radius2(1.05) != cuda_gn._radius2(1.05)


def test_fused_gather_rejects_what_the_kernel_cannot_run(gather_scene):
    _, (pm, tsrc, tmask, tt) = gather_scene
    kw = dict(voxel_size=VS, max_probes=1, plane_radius=0.45)
    for bad in (dict(neighborhood=8), dict(n_voxels=9), dict(loss="x")):
        with pytest.raises(ValueError, match="fused gather"):
            cuda_gather.gather_prep_fused(pm, tsrc, tmask, tt,
                                          **dict(kw, **bad))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.gather_prep_fused(pm, tsrc.to("meta"), tmask.to("meta"),
                                      tt.to("meta"), **kw)


def test_gather_fused_on_cpu_is_the_twins_with_the_selection(gather_scene):
    """The one-launch wrapper on CPU tensors: the select and prep twins,
    the selection copied into ``aux``, no launch counted."""
    _, (pm, tsrc, tmask, tt) = gather_scene
    pts_w = (tsrc @ tt[:3, :3].T + tt[:3, 3]).contiguous()
    kw = dict(voxel_size=VS, max_probes=2, neighborhood=7, n_voxels=4)
    aux = torch.full((20, pts_w.shape[0]), -1, dtype=torch.int32)
    kernels.reset_launches()
    got = cuda_gather.gather_fused(pm, pts_w, tmask, radius2=0.2,
                                   loss="plane", aux=aux, **kw)
    assert kernels.LAUNCHES["gather_fused"] == 0
    sel = cuda_gather.select_voxels_torch(pm, pts_w, **kw)
    assert torch.equal(aux, sel)
    ref = cuda_gather.prep_selected_torch(pm, pts_w, tmask, sel,
                                          voxel_size=VS, radius2=0.2,
                                          loss="plane")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ------------------------------------------------ K6's select by rank

_SEL_VS = 0.5      # a power of two: voxel corners and reps are exact


def _hand_map(keys, reps, counts, cap=1 << 9, ppv=8):
    """A map holding ``keys`` [M, 3] with representatives ``reps`` and
    counts, each in the first free slot from its home slot (so some sit
    a probe past it), built row by row."""
    meta = torch.zeros((cap, hashmap.META_W), dtype=torch.int32)
    fp, h0 = hashmap._fingerprint_and_slot(keys, cap)
    for i in range(keys.shape[0]):
        s = int(h0[i])
        while int(meta[s, 0]) != 0:
            s = (s + 1) & (cap - 1)
        meta[s, 0], meta[s, 1] = fp[i], int(counts[i])
        meta[s, 2:5] = reps[i].view(torch.int32)
    points = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 30, (cap, ppv), dtype=np.int32))
    return hashmap.VoxelHashMap(meta, points)


def _select_scene(kind):
    """(map, query points): reps and queries on a 1/8 m grid, so squared
    distances are exact and tie often. ``ties``: half the voxels of a 4 m
    cube filled; ``sparse``: one voxel in ten (fewer than V matches);
    ``none``: the queries 100 m away from every voxel."""
    rng = np.random.default_rng({"ties": 1, "sparse": 2, "none": 3}[kind])
    grid = np.stack(np.meshgrid(*[np.arange(-4, 4)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    keep = rng.uniform(size=len(grid)) < (0.1 if kind == "sparse" else 0.5)
    keys = grid[keep]
    reps = (keys + rng.integers(0, 2, keys.shape) / 2.0 + 0.25) * _SEL_VS
    m = _hand_map(torch.from_numpy(keys.astype(np.int32)),
                  torch.from_numpy(reps.astype(np.float32)),
                  rng.integers(1, 9, len(keys)))
    q = rng.integers(-14, 14, (512, 3)) / 8.0
    if kind == "none":
        q = q + 100.0
    return m, torch.from_numpy(q.astype(np.float32))


def select_by_rank(vmap_, pts_w, *, voxel_size, max_probes, neighborhood,
                   n_voxels):
    """csrc/gather_fused.cu's select in torch: lane j probes neighbour j;
    a matched neighbour's rank is the number of matched neighbours with a
    smaller (d, j); rank v is selection v, and once the matches run out
    the selection is neighbour 0 (its slot, count 0)."""
    n = pts_w.shape[0]
    keys = voxel_coords(pts_w, voxel_size)[:, None, :] \
        + icp.neighbor_offsets(neighborhood, "cpu")[None]     # [N, J, 3]
    slot, cnt, rep, found = hashmap.probe(vmap_, keys, max_probes,
                                          miss_slot=0)
    dx, dy, dz = (rep[..., i] - pts_w[:, None, i] for i in range(3))
    d = dx * dx + dy * dy + dz * dz
    big = cuda_gather._BIG
    ok = found & (d < big)
    key = torch.where(ok, d, big)
    j = torch.arange(neighborhood)
    smaller = (key[:, None, :] < key[:, :, None]) | (
        (key[:, None, :] == key[:, :, None]) & (j[None, :] < j[:, None]))
    rank = (smaller & ok[:, None, :]).sum(-1)                 # [N, J]
    sel_slot, sel_cnt, sel_key = [], [], []
    for v in range(n_voxels):
        pick = ok & (rank == v)
        has = pick.any(1)
        jv = torch.where(has, pick.int().argmax(1), 0)[:, None]
        sel_slot.append(torch.where(has, slot.gather(1, jv)[:, 0],
                                    slot[:, 0]))
        sel_cnt.append(torch.where(has, cnt.gather(1, jv)[:, 0], 0))
        sel_key.append(keys.gather(1, jv[..., None].expand(n, 1, 3))[:, 0])
    key_v = torch.stack(sel_key, 1)                           # [N, V, 3]
    return torch.cat([torch.stack(sel_slot), torch.stack(sel_cnt),
                      key_v.permute(2, 1, 0).reshape(3 * n_voxels, n)]
                     ).to(torch.int32), ok, key


@pytest.mark.parametrize("neighborhood,max_probes", [(7, 1), (7, 2),
                                                     (27, 2)])
@pytest.mark.parametrize("kind", ["ties", "sparse", "none"])
def test_select_by_rank_matches_the_select_twin(kind, neighborhood,
                                                 max_probes):
    m, q = _select_scene(kind)
    kw = dict(voxel_size=_SEL_VS, max_probes=max_probes,
              neighborhood=neighborhood, n_voxels=4)
    got, ok, key = select_by_rank(m, q, **kw)
    assert torch.equal(got, cuda_gather.select_voxels_torch(m, q, **kw))
    n_ok = ok.sum(1)
    if kind == "none":
        assert int(n_ok.max()) == 0
        assert bool((got[4:8] == 0).all())
        return
    assert bool(((n_ok > 0) & (n_ok < 4)).any())       # junk picks taken
    if kind == "ties":
        # exact ties among the matched neighbours of a point
        k = torch.where(ok, key, float("nan")).sort(1).values
        assert int((k.diff(dim=1) == 0).sum()) > 50
        assert int((n_ok >= 4).sum()) > 100


# ---------------------------------------------------------- registration

@pytest.fixture(scope="module")
def icp_scene():
    m, src, mask, guess = _setup()
    return (m, src, mask, guess), (_port_map(m), _t(src), _t(mask),
                                   _t(guess))


def _register(scene, **kw):
    _, (pm, tsrc, tmask, tguess) = scene
    return icp.register_frame_cached(
        tsrc, tmask, pm, tguess, torch.tensor(0.5), torch.tensor(0.1667),
        voxel_size=0.3, max_probes=2, max_iterations=30, convergence=1e-5,
        plane_min_quality=0.2, prior_rot_weight=0.01,
        prior_trans_weight=0.01, neighborhood=7, n_voxels=4,
        plane_radius=0.6, form="cuda", **kw)


def test_fused_registration_matches_jax(icp_scene):
    """K6 -> K4 (their twins) against JAX's fused gather and fused loop
    (interpret mode)."""
    (m, src, mask, guess), _ = icp_scene
    ref = _run("fused", m, src, mask, guess, "plane")
    kernels.reset_launches()
    got = _register(icp_scene, fused_gather=True)
    assert sum(kernels.LAUNCHES.values()) == 0
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=2e-4)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    n0, n1 = int(ref.num_corr), int(got.num_corr)
    assert abs(n0 - n1) <= max(3, int(0.01 * n0)) and n0 > 1000
    d = np.asarray(jse3.log_pose(jse3.inv(ref.pose)
                                 @ jnp.asarray(got.pose.numpy())))
    assert np.linalg.norm(d) < 5e-4, d


def test_fused_gather_matches_the_unfused_path(icp_scene):
    """K6 -> K4 against gather_candidates -> K3 -> K4 (twins) at
    tests/test_pallas_gather.py's pose bars."""
    a = _register(icp_scene, fused_gather=True)
    b = _register(icp_scene, fused_gather=False)
    np.testing.assert_allclose(a.pose.numpy(), b.pose.numpy(), atol=2e-4)
    assert abs(int(a.iterations) - int(b.iterations)) <= 2


def test_fused_gather_has_no_effect_with_refresh(icp_scene):
    """With candidate refresh the gather is always gather_candidates', as
    in the JAX package: fused_gather changes no bit."""
    a = _register(icp_scene, fused_gather=True, refresh_drift=0.5)
    b = _register(icp_scene, fused_gather=False, refresh_drift=0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- K7

def test_plane_moments_twin_matches_pallas():
    """tests/test_pallas_gn.py:test_plane_moments_parity's planar scene."""
    rng = np.random.default_rng(7)
    m = jhashmap.create(1 << 14, 16)
    xy = rng.uniform(-15, 15, (40000, 2)).astype(np.float32)
    z = (0.2 * xy[:, 0] + 0.1 * xy[:, 1]
         + rng.normal(scale=0.01, size=40000)).astype(np.float32)
    pts = np.column_stack([xy, z])
    keep = jvoxel.first_in_voxel_mask(
        jnp.asarray(pts), jnp.ones(len(pts), bool), 0.15, 1 << 17)
    m = jhashmap.insert_deduped(m, jnp.asarray(pts), keep, voxel_size=0.3,
                                max_probes=2, new_capacity=8192)
    n = 2048
    sxy = rng.uniform(-14, 14, (n, 2)).astype(np.float32)
    src = jnp.asarray(np.column_stack(
        [sxy, 0.2 * sxy[:, 0] + 0.1 * sxy[:, 1]]).astype(np.float32))
    cand = jax.jit(lambda m_, q: jicp.gather_candidates(
        m_, q, voxel_size=0.3, max_probes=2, neighborhood=7, n_voxels=4,
        fit_planes=False))(m, src)
    c_pts = np.asarray(cand.pts)                             # [N, C, 3]
    cx, cy, cz = (np.ascontiguousarray(c_pts[..., i].T) for i in range(3))
    inf = np.where(np.asarray(cand.valid).T, 0.0, 1e30).astype(np.float32)
    ptq = np.zeros((8, n), np.float32)
    ptq[:3] = np.asarray(src).T
    ref = np.asarray(plane_moments_pallas(
        *map(jnp.asarray, (ptq, cx, cy, cz, inf)),
        jnp.asarray(0.36, jnp.float32), interpret=True))
    kernels.reset_launches()
    got = cuda_gn.plane_moments(*map(torch.from_numpy,
                                     (ptq, cx, cy, cz, inf)), 0.36).numpy()
    assert kernels.LAUNCHES["plane_moments"] == 0
    assert got.shape == ref.shape == (16, n)
    np.testing.assert_array_equal(got[0], ref[0])
    assert ref[0].sum() > 4 * n
    for r in range(1, 10):
        scale = np.abs(ref[r]).max()
        assert np.abs(got[r] - ref[r]).max() <= 1e-5 * scale, r
    assert (got[10:] == 0).all()
