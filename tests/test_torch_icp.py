"""PyTorch port: candidate gather, GN build and the ICP kernels' twins
against the JAX package, on tests/test_pallas_icp.py's scene.

K3's twin (patch plane fit) is held to ``prep_with_plane_pallas`` in
interpret mode at tests/test_pallas_gn.py's bars (normal |dot| 1%-quantile
> 0.999, centroid 2e-3, quality 2e-2); K4's twin, through the port's
``register_frame_cached(form="cuda")`` with CPU tensors, to the JAX fused
loop kernel (``gn_backend="fused"``, interpret mode) at
tests/test_pallas_icp.py's bars (log-pose < 5e-4, n_corr within
max(3, 1 %), iterations within 2). The JAX gathers run under ``jax.jit``
as in the pipeline, so both packages see the same candidates.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.geom import se3 as jse3
from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops.pallas_gn import prep_with_plane_pallas
from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.ops import cuda_gn, hashmap, icp
from test_pallas_icp import _run, _setup

torch.set_num_threads(2)

GATHER = dict(voxel_size=0.3, max_probes=2, neighborhood=7, n_voxels=4,
              plane_radius=0.6)


@pytest.fixture(scope="module")
def scene():
    m, src, mask, guess = _setup()
    pm = hashmap.VoxelHashMap(torch.from_numpy(np.array(m.meta)),
                              torch.from_numpy(np.array(m.points)))
    t = (torch.from_numpy(np.array(src)), torch.from_numpy(np.array(mask)),
         torch.from_numpy(np.array(guess)))
    return (m, src, mask, guess), (pm,) + t


def _gather_both(scene, fit_planes):
    (m, src, _, guess), (pm, tsrc, _, tguess) = scene
    q_j = jse3.transform(guess, src)
    cj = jax.jit(partial(jicp.gather_candidates, fit_planes=fit_planes,
                         **GATHER))(m, q_j)
    cp = icp.gather_candidates(pm, se3.transform(tguess, tsrc),
                               fit_planes=fit_planes, **GATHER)
    return cj, cp, q_j


@pytest.mark.parametrize("fit_planes", [False, True])
def test_gather_candidates_matches_jax(scene, fit_planes):
    cj, cp, _ = _gather_both(scene, fit_planes)
    np.testing.assert_array_equal(cp.valid.numpy(), np.asarray(cj.valid))
    assert int(cp.valid.sum()) > 10000
    # candidate points are decoded from the same integers: f32 roundoff of
    # the voxel corner arithmetic only
    np.testing.assert_allclose(cp.pts.numpy(), np.asarray(cj.pts), atol=1e-5)
    if fit_planes:
        ok = np.asarray(cj.quality) > 0.3
        assert ok.sum() > 500
        dots = np.abs(np.sum(cp.normal.numpy()[ok]
                             * np.asarray(cj.normal)[ok], 1))
        assert np.quantile(dots, 0.01) > 0.999
        np.testing.assert_allclose(cp.centroid.numpy()[ok],
                                   np.asarray(cj.centroid)[ok], atol=2e-3)
        np.testing.assert_allclose(cp.quality.numpy()[ok],
                                   np.asarray(cj.quality)[ok], atol=2e-2)


def test_gn_from_candidates_matches_jax(scene):
    """The per-iteration GN build (the twin loop's body) against JAX's
    plain path, at tests/test_pallas_gn.py's relative bar 1e-5."""
    cj, cp, _ = _gather_both(scene, True)
    (_, src, mask, guess), (_, tsrc, tmask, tguess) = scene
    kern, max_d2 = 0.1667, 2.25
    jtj0, jtr0, nc0, tw0 = jicp.gn_from_candidates(
        guess, src, mask, cj, jnp.float32(kern), jnp.float32(max_d2),
        loss="plane", plane_min_quality=0.2)
    jtj1, jtr1, nc1, tw1 = icp.gn_from_candidates(
        tguess, tsrc, tmask, cp, torch.tensor(kern), torch.tensor(max_d2),
        plane_min_quality=0.2)
    assert int(nc0) == int(nc1) and int(nc0) > 100
    jtj0, jtr0 = np.asarray(jtj0), np.asarray(jtr0)
    assert np.abs(jtj1.numpy() - jtj0).max() / np.abs(jtj0).max() < 1e-5
    assert np.abs(jtr1.numpy() - jtr0).max() / np.abs(jtr0).max() < 1e-5
    np.testing.assert_allclose(float(tw1), float(tw0), rtol=1e-5)


def test_prep_twin_matches_pallas(scene):
    cj, cp, q_j = _gather_both(scene, False)
    (_, _, mask, _), (_, tsrc, tmask, tguess) = scene
    ref = prep_with_plane_pallas(cj, mask, q_j, jnp.asarray(0.6, jnp.float32),
                                 loss="plane", interpret=True)
    kernels.reset_launches()
    got = cuda_gn.prep_with_plane(cp, tmask, se3.transform(tguess, tsrc), 0.6)
    assert kernels.LAUNCHES["gn_prep"] == 0      # CPU tensors: the twin
    for a, b in zip(got[1:], ref[1:]):           # lane-major candidates
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    feat, rfeat = got.feat.numpy(), np.asarray(ref.feat)
    ok = rfeat[6] > 0.3
    assert ok.sum() > 500
    dots = np.abs(np.sum(feat[0:3, ok] * rfeat[0:3, ok], 0))
    assert np.quantile(dots, 0.01) > 0.999
    np.testing.assert_allclose(feat[3:6, ok], rfeat[3:6, ok], atol=2e-3)
    np.testing.assert_allclose(feat[6, ok], rfeat[6, ok], atol=2e-2)
    np.testing.assert_array_equal(feat[7], rfeat[7])


def _register(scene, priors, vmap_=None):
    (_, _, _, _), (pm, tsrc, tmask, tguess) = scene
    return icp.register_frame_cached(
        tsrc, tmask, pm if vmap_ is None else vmap_, tguess,
        torch.tensor(0.5), torch.tensor(0.1667), voxel_size=0.3,
        max_probes=2, max_iterations=30, convergence=1e-5,
        plane_min_quality=0.2, prior_rot_weight=priors[0],
        prior_trans_weight=priors[1], neighborhood=7, n_voxels=4,
        plane_radius=0.6, form="cuda")


@pytest.mark.parametrize("priors", [(0.01, 0.01), (0.0, 0.0)])
def test_icp_loop_twin_matches_fused_kernel(scene, priors):
    (m, src, mask, guess), _ = scene
    ref = _run("fused", m, src, mask, guess, "plane", priors)
    kernels.reset_launches()
    got = _register(scene, priors)
    assert kernels.LAUNCHES["icp_loop"] == 0
    d = np.asarray(jse3.log_pose(jse3.inv(ref.pose)
                                 @ jnp.asarray(got.pose.numpy())))
    assert np.linalg.norm(d) < 5e-4, d
    n0, n1 = int(ref.num_corr), int(got.num_corr)
    assert abs(n0 - n1) <= max(3, int(0.01 * n0)) and n0 > 1000
    assert abs(int(ref.iterations) - int(got.iterations)) <= 2
    # the model deviation the kernel's epilogue returns
    np.testing.assert_allclose(float(got.dev_t), float(ref.dev_t), atol=1e-4)
    np.testing.assert_allclose(float(got.dev_r), float(ref.dev_r), atol=1e-4)


def test_icp_loop_empty_map_returns_guess(scene):
    pm = hashmap.create(1 << 14, 8, "cpu")
    res = _register(scene, (0.0, 0.0), vmap_=pm)
    np.testing.assert_allclose(res.pose.numpy(), scene[1][3].numpy(),
                               atol=1e-6)
    assert int(res.num_corr) == 0 and int(res.iterations) == 1
