"""PyTorch port: the order of work of K3 (``csrc/gn_prep.cu``), K7
(``csrc/plane_moments.cu``) and K2 (``csrc/ekf_update.cu``), transcribed
into torch and held to the JAX kernels in interpret mode and to the port's
twins.

K3, one warp a source point and 8 points a CTA: each point's CandidateSet
row goes into the CTA's swizzled [x, y, z, inf][C][8] tiles, lane k adds
candidates k, k + 32, ... to ten moment registers, an xor butterfly sums
them over the warp, one lane a point runs the finish (the means by the
count's reciprocal), and the tiles leave row by row. The lane-major rows must equal ``cuda_gn.lane_major`` bit for
bit; feat meets tests/test_pallas_gn.py's bars (normal |dot| 1%-quantile
> 0.999, centroid 2e-3, quality 2e-2) against ``prep_with_plane_torch``
and ``prep_with_plane_pallas(interpret=True)``, at C = 32, at C = 40 (not
a multiple of 32) and at a ragged N = 2046.

K7, K3's first half on lane-major rows: the CTA loads its 8 points' rows
into the same swizzled tiles and takes K3's lane moments; held to
``plane_moments_torch`` at chip_smoke phase 3's bars (count exact, rows
1-9 within 1e-5) at C = 32 and a ragged N = 2046.

K2: S factored by a warp, one lower-triangle entry a lane, step by step,
the pivots' reciprocals in place of divisions; K's eighteen rows solved at
once, one right-hand side a lane, by forward and back substitution (no
S^-1); A = P - K (J P) and the Joseph entry
A + (K R - A J^T) K^T, each a 6-term dot; the attitude block projected one
element a lane. Held to ``update_pose_pallas(interpret=True)`` and to the
``"xla"`` twin in both Joseph forms, with a rotated measurement and with a
measurement equal to the state's attitude (the small-angle branch of the
log), at tests/test_esekf.py's bars (state 1e-5, cov rtol 1e-4 atol 1e-5).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.config import EkfConfig as JEkfConfig
from ptudes_tpu.models import esekf as jesekf
from ptudes_tpu.geom import se3 as jse3
from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops.pallas_ekf import update_pose_pallas
from ptudes_tpu.ops.pallas_gn import prep_with_plane_pallas
from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.geom import se3, so3
from ptudes_tpu_torch.models import esekf
from ptudes_tpu_torch.ops import cuda_ekf, cuda_gn, hashmap, icp
from ptudes_tpu_torch.ops.plane import smallest_eigvec_sym3
from test_pallas_icp import _setup
from test_torch_ekf import generic_state, to_torch

torch.set_num_threads(2)

# ------------------------------------------------------------------- K3

WARPS = 8   # points a CTA (csrc/gn_prep.cu:kWarps)
LANES = 32


def tile_at(r, i):
    """csrc/gn_prep.cu:tile_at: the slot of (row r, point i) in a
    [rows][8] tile, the point index xor-swizzled by r / 4."""
    return r * WARPS + (i ^ ((r >> 2) & (WARPS - 1)))


def lane_moments(tile, n: int, c: int, q_w, r2: float) -> torch.Tensor:
    """The moments of K3 and K7 (common.cuh:patch_add, patch_warp_sum)
    from a CTA's [B, 4, C * 8] tiles: warp w is point w, lane l reads
    candidates l, l + 32, ... of its column and adds each inside the
    radius in that order, then an xor butterfly sums the lanes; [10, n]."""
    w, kk = torch.arange(WARPS), torch.arange(c)
    blocks = tile.shape[0]
    lanes = -(-c // LANES) * LANES
    col = tile[:, :, tile_at(kk[:, None], w)]          # [B, 4, C, W]
    col = col.permute(0, 3, 1, 2).reshape(blocks * WARPS, 4, c)[:n]
    col = torch.nn.functional.pad(col, (0, lanes - c), value=1e30)
    x, y, z, inf = col.reshape(n, 4, lanes // LANES, LANES).unbind(1)
    dx, dy, dz = x - q_w[:, 0, None, None], y - q_w[:, 1, None, None], \
        z - q_w[:, 2, None, None]
    inside = (dx * dx + dy * dy + dz * dz + inf) <= r2
    terms = [torch.ones_like(dx), dx, dy, dz, dx * dx, dy * dy, dz * dz,
             dx * dy, dx * dz, dy * dz]
    mom = torch.zeros((10, n, LANES))
    for m in range(lanes // LANES):
        for t, v in enumerate(terms):
            mom[t] = torch.where(inside[:, m], mom[t] + v[:, m], mom[t])
    # the xor butterfly over the lanes: every lane ends with the same sums
    for off in (16, 8, 4, 2, 1):
        mom = mom + mom[:, :, torch.arange(LANES) ^ off]
    assert torch.equal(mom, mom[:, :, :1].expand_as(mom))
    return mom[:, :, 0]


def k3_decomposed(cand, source_mask, q_w, r2: float):
    """K3's order of work in torch (f32): returns PreppedCandidates."""
    n, c = cand.valid.shape
    blocks = -(-n // WARPS)
    pad = blocks * WARPS - n
    w = torch.arange(WARPS)
    # loads: the point's 3C floats of its row, value e to row e // 3 of
    # tile e % 3 at the point's slot; its validity bytes to the inf tile
    rows = torch.nn.functional.pad(cand.pts.reshape(n, 3 * c), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(cand.valid, (0, 0, 0, pad))
    tile = torch.zeros((blocks, 4, c * WARPS))
    e = torch.arange(3 * c)
    k, a = e // 3, e % 3
    tile[:, a[:, None].expand(-1, WARPS), tile_at(k[:, None], w)] = \
        rows.reshape(blocks, WARPS, 3 * c).transpose(1, 2)
    kk = torch.arange(c)
    tile[:, 3, tile_at(kk[:, None], w)] = torch.where(ok, 0.0, 1e30).reshape(
        blocks, WARPS, c).transpose(1, 2)
    s0, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz = lane_moments(
        tile, n, c, q_w, r2)
    # the finish, one point a lane (common.cuh:plane_feat<true>: the sums
    # times the reciprocal of the count)
    inv = 1.0 / torch.clamp(s0, min=1.0)
    mx, my, mz = sx * inv, sy * inv, sz * inv
    axx, ayy, azz = sxx * inv - mx * mx, syy * inv - my * my, \
        szz * inv - mz * mz
    axy, axz, ayz = sxy * inv - mx * my, sxz * inv - mx * mz, \
        syz * inv - my * mz
    cov = torch.stack([torch.stack([axx, axy, axz], -1),
                       torch.stack([axy, ayy, ayz], -1),
                       torch.stack([axz, ayz, azz], -1)], -2)
    normal, quality = smallest_eigvec_sym3(cov)
    feat = torch.cat([normal.T, (q_w + torch.stack([mx, my, mz], 1)).T,
                      torch.where(s0 >= 4, quality, 0.0)[None],
                      source_mask.to(torch.float32)[None]])
    # stores: element e of the CTA's 4C x 8 rows is row e // 8, point e % 8
    e = torch.arange(4 * c * WARPS)
    rr, i = e // WARPS, e % WARPS
    a, r = rr // c, rr % c
    flat = tile[:, a, tile_at(r, i)].reshape(blocks, 4 * c, WARPS)
    out = flat.permute(1, 0, 2).reshape(4, c, blocks * WARPS)[:, :, :n]
    return cuda_gn.PreppedCandidates(feat, *out)


def k7_decomposed(ptq, cx, cy, cz, inf, r2: float) -> torch.Tensor:
    """K7's order of work in torch (csrc/plane_moments.cu): the CTA loads
    its 8 points' lane-major rows, element e row e // 8 of the four arrays
    at point e % 8 (0, or 1e30 for inf, past N), into the swizzled tiles;
    K3's lane moments; rows 0-9 the moments, 10-15 zero. [16, N]."""
    c, n = cx.shape
    blocks = -(-n // WARPS)
    pad = blocks * WARPS - n
    arrs = torch.stack([torch.nn.functional.pad(x, (0, pad), value=v)
                        for x, v in ((cx, 0.0), (cy, 0.0), (cz, 0.0),
                                     (inf, 1e30))])      # [4, C, B * 8]
    e = torch.arange(4 * c * WARPS)
    rr, i = e // WARPS, e % WARPS
    a, r = rr // c, rr % c
    tile = torch.zeros((blocks, 4 * c * WARPS))
    p = torch.arange(blocks)[:, None] * WARPS + i
    tile[:, a * c * WARPS + tile_at(r, i)] = arrs[a, r, p]
    mom = lane_moments(tile.reshape(blocks, 4, c * WARPS), n, c,
                       ptq[:3].T, r2)
    return torch.cat([mom, mom.new_zeros((6, n))])


@pytest.fixture(scope="module")
def k3_scene():
    m, src, mask, guess = _setup()
    pm = hashmap.VoxelHashMap(torch.from_numpy(np.array(m.meta)),
                              torch.from_numpy(np.array(m.points)))
    return (m, src, mask, guess), (pm, torch.from_numpy(np.array(src)),
                                   torch.from_numpy(np.array(mask)),
                                   torch.from_numpy(np.array(guess)))


def _check_fit(feat, rfeat, n):
    """tests/test_pallas_gn.py's bars on the first ``n`` points."""
    feat, rfeat = np.asarray(feat)[:, :n], np.asarray(rfeat)[:, :n]
    ok = rfeat[6] > 0.3
    assert ok.sum() > 500
    dots = np.abs(np.sum(feat[0:3, ok] * rfeat[0:3, ok], 0))
    assert np.quantile(dots, 0.01) > 0.999
    np.testing.assert_allclose(feat[3:6, ok], rfeat[3:6, ok], atol=2e-3)
    np.testing.assert_allclose(feat[6, ok], rfeat[6, ok], atol=2e-2)
    np.testing.assert_array_equal(feat[7], rfeat[7])


@pytest.mark.parametrize("n_voxels, n", [(4, 2048), (5, 2048), (4, 2046)],
                         ids=["C32", "C40", "ragged_N2046"])
def test_k3_decomposition_matches_twin_and_pallas(k3_scene, n_voxels, n):
    (m, src, mask, guess), (pm, tsrc, tmask, tguess) = k3_scene
    kw = dict(voxel_size=0.3, max_probes=2, neighborhood=7,
              n_voxels=n_voxels, fit_planes=False)
    q_j = jse3.transform(guess, src)
    cj = jax.jit(partial(jicp.gather_candidates, **kw))(m, q_j)
    ref = prep_with_plane_pallas(cj, mask, q_j, jnp.asarray(0.6, jnp.float32),
                                 loss="plane", interpret=True)
    q_w = se3.transform(tguess, tsrc)[:n].contiguous()
    cand = icp.gather_candidates(pm, q_w, **kw)
    tmask = tmask[:n]
    assert cand.pts.shape == (n, 8 * n_voxels, 3)
    got = k3_decomposed(cand, tmask, q_w, cuda_gn._radius2(0.6))
    twin = cuda_gn.prep_with_plane_torch(cand, tmask, q_w, 0.6)
    # the lane-major rows are copies of the CandidateSet: bit for bit
    for a, b in zip(got[1:], cuda_gn.lane_major(cand)):
        assert torch.equal(a, b)
    for a, b in zip(twin[1:], got[1:]):
        assert torch.equal(a, b)
    _check_fit(got.feat, twin.feat, n)
    _check_fit(got.feat, ref.feat, n)
    kernels.reset_launches()
    wrapped = cuda_gn.prep_with_plane(cand, tmask, q_w, 0.6)
    assert kernels.LAUNCHES["gn_prep"] == 0        # CPU tensors: the twin
    assert all(torch.equal(a, b) for a, b in zip(wrapped, twin))


@pytest.mark.parametrize("n_voxels, n", [(4, 2048), (4, 2046)],
                         ids=["C32", "ragged_N2046"])
def test_k7_decomposition_matches_twin(k3_scene, n_voxels, n):
    """K7's order of work on the bench-shape candidates (lane-major, as
    K3 lays them out): the count row exact, rows 1-9 within 1e-5 of each
    row's largest magnitude (phase 3's bars), rows 10-15 zero; the
    wrapper on CPU tensors is the twin."""
    _, (pm, tsrc, _, tguess) = k3_scene
    q_w = se3.transform(tguess, tsrc)[:n].contiguous()
    cand = icp.gather_candidates(pm, q_w, voxel_size=0.3, max_probes=2,
                                 neighborhood=7, n_voxels=n_voxels,
                                 fit_planes=False)
    rows = cuda_gn.lane_major(cand)
    ptq = torch.cat([q_w.T, torch.zeros((5, n))]).contiguous()
    r2 = cuda_gn._radius2(0.6)
    got = k7_decomposed(ptq, *rows, r2)
    twin = cuda_gn.plane_moments_torch(ptq, *rows, r2)
    assert torch.equal(got[0], twin[0]) and float(twin[0].sum()) > 4 * n
    for k in range(1, 10):
        rel = float((got[k] - twin[k]).abs().max() / twin[k].abs().max())
        assert rel <= 1e-5, (k, rel)
    assert bool((got[10:] == 0).all())
    kernels.reset_launches()
    assert torch.equal(cuda_gn.plane_moments(ptq, *rows, r2), twin)
    assert kernels.LAUNCHES["plane_moments"] == 0


def test_k3_tiles_swizzle_is_conflict_free():
    """The slots a warp reads (rows k..k+31 of one point) fall in 32
    distinct banks, and every 32 consecutive slots of a tile hold four whole
    rows: the column reads and the row-wise stores are conflict-free."""
    r = torch.arange(64)
    for i in range(WARPS):
        for k0 in (0, 32):
            assert len(set((tile_at(r[k0:k0 + 32], i) % 32).tolist())) == 32
    slots = tile_at(r[:, None], torch.arange(WARPS)).reshape(-1)
    for q in range(0, 64 * WARPS, 32):
        chunk = slots[q:q + 32]
        assert sorted(chunk.tolist()) == list(range(q, q + 32))


# ------------------------------------------------------------------- K2

_JP = [0, 1, 2, 6, 7, 8]     # J's rows: POS, then PHI
_PHI = 6


def _log_rot(m):
    """common.cuh:log_rot: the direct axis-angle log, small-angle switch at
    1e-4."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    theta = torch.acos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    fac = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                      theta / torch.clamp(2.0 * torch.sin(theta), min=1e-8))
    return fac * torch.stack([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                              m[1, 0] - m[0, 1]])


def _dot(terms, s=None, sign=1.0):
    """s + sign * (sum of the products), added one product at a time in
    the kernel's order (s = 0 when not given)."""
    for a, b in terms:
        s = sign * a * b if s is None else s + sign * a * b
    return s


def k2_decomposed(s: esekf.EkfState, pose, mc, joseph: bool):
    """K2's order of work in torch (f32): returns the updated EkfState."""
    p = s.cov
    # the residual (warp 1, beside the factorisation)
    r = so3.quat_to_mat(s.quat)
    res = torch.cat([pose[:3, 3] - s.pos, _log_rot(r.T @ pose[:3, :3])])
    # warp 0: lane (i, j) of S's lower triangle; step k scales column k
    # by the pivot's reciprocal, which the diagonal keeps, and updates the
    # trailing block
    a = {(i, j): p[_JP[i], _JP[j]] + mc[i, j]
         for i in range(6) for j in range(i + 1)}
    for k in range(6):
        inv = 1.0 / torch.sqrt(torch.clamp(a[k, k], min=1e-12))
        for i in range(k, 6):
            a[i, k] = inv if i == k else a[i, k] * inv
        for i in range(k + 1, 6):
            for j in range(k + 1, i + 1):
                a[i, j] = a[i, j] - a[i, k] * a[j, k]
    ll = torch.zeros((6, 6))
    for (i, j), v in a.items():
        ll[i, j] = v
    # lane c < 18: S x = (P J^T)[c], all eighteen rows at once
    b = p[:, _JP]                                        # [18, 6]
    y = [None] * 6
    for i in range(6):
        y[i] = _dot([(ll[i, k], y[k]) for k in range(i)], b[:, i], -1.0) \
            * ll[i, i]
    x = [None] * 6
    for i in reversed(range(6)):
        x[i] = _dot([(ll[k, i], x[k]) for k in range(i + 1, 6)], y[i],
                    -1.0) * ll[i, i]
    gain = torch.stack(x, 1)                             # K [18, 6]
    dx = _dot([(gain[:, q], res[q]) for q in range(6)])
    # A = P - K (J P); Joseph: A + (K R - A J^T) K^T
    am = p.clone()
    for q in range(6):
        am = am - gain[:, q, None] * p[_JP[q], None, :]
    cm = am
    if joseph:
        kr = _dot([(gain[:, q, None], mc[None, q, :]) for q in range(6)])
        cm = am.clone()
        for q in range(6):
            cm = cm + (kr[:, q, None] - am[:, _JP[q], None]) \
                * gain[None, :, q]
    cov = 0.5 * (cm + cm.T)
    # the attitude block, one element a lane: matmul3(G, blk) then G^T
    h = 0.5 * dx[_PHI:_PHI + 3]
    g = torch.eye(3) - so3.hat(h)
    blk = cov[_PHI:_PHI + 3, _PHI:_PHI + 3]
    gb = _dot([(g[:, k, None], blk[None, k, :]) for k in range(3)])
    cov = cov.clone()
    cov[_PHI:_PHI + 3, _PHI:_PHI + 3] = _dot(
        [(gb[:, k, None], g[None, :, k]) for k in range(3)])
    rn = r @ so3.exp_rotvec(dx[_PHI:_PHI + 3])
    return esekf.EkfState(
        pos=s.pos + dx[0:3], vel=s.vel + dx[3:6], quat=so3.mat_to_quat(rn),
        bias_gyr=s.bias_gyr + dx[9:12], bias_acc=s.bias_acc + dx[12:15],
        grav=s.grav + dx[15:18], cov=cov, imu_ts=s.imu_ts,
        initialized=s.initialized)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _check_update(got, ref):
    for f in ("pos", "vel", "bias_gyr", "bias_acc", "grav"):
        _close(getattr(got, f), getattr(ref, f), 1e-5)
    q0, q1 = np.asarray(got.quat), np.asarray(ref.quat)
    assert min(np.abs(q0 - q1).max(), np.abs(q0 + q1).max()) < 1e-5
    _close(got.cov, ref.cov, 1e-5, 1e-4)


@pytest.mark.parametrize("meas", ["rotated", "identity"])
@pytest.mark.parametrize("joseph", [True, False])
def test_k2_decomposition_matches_twin_and_pallas(joseph, meas):
    jcfg = JEkfConfig(joseph_form=joseph)
    js = generic_state(5, cfg=jcfg)
    pose = np.eye(4, dtype=np.float32)
    if meas == "rotated":
        pose[:3, :3] = np.asarray(jesekf.so3.quat_to_mat(
            jesekf.so3.rotvec_to_quat(jnp.asarray([0.02, -0.01, 0.03]))))
    else:
        # the state's attitude exactly (the identity quaternion), so
        # R^T R_meas = I and the log takes its small-angle branch
        js = js._replace(quat=jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32))
    pose[:3, 3] = [0.1, -0.2, 0.05]
    mc = np.array(jesekf.default_meas_cov(jcfg))
    ref = update_pose_pallas(js, jnp.asarray(pose), jnp.asarray(mc),
                             joseph=joseph, interpret=True)
    ref_xla = jesekf.process_pose(js, jnp.asarray(pose), cfg=jcfg)
    s = to_torch(js)
    got = k2_decomposed(s, torch.from_numpy(pose), torch.from_numpy(mc),
                        joseph)
    kernels.reset_launches()
    twin = cuda_ekf.update_pose(s, torch.from_numpy(pose),
                                torch.from_numpy(mc), joseph=joseph)
    assert kernels.LAUNCHES["ekf_update"] == 0
    for r in (ref, ref_xla, twin):
        _check_update(got, r)
    if meas == "identity":
        r = so3.quat_to_mat(s.quat)
        m = r.T @ torch.from_numpy(pose[:3, :3])
        assert torch.equal(m, torch.eye(3))
        assert torch.equal(_log_rot(m), torch.zeros(3))
