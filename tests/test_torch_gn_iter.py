"""PyTorch port: K5's twin (one GN build against prepped candidates)
against the JAX package, on tests/test_pallas_gn.py's scene.

``cuda_gn.gn_prepped`` with CPU tensors (its twin, ``gn_prepped_torch``)
is held, for both losses, to ``gn_from_candidates_pallas`` in interpret
mode and to the plain ``icp.gn_from_candidates``, at that test's bars:
``n_corr`` exact, ``jtj`` and ``jtr`` within 1e-5 of their max-abs scale,
the total weight within rtol 1e-5. The candidates are the JAX gather's,
handed over as numpy arrays.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.ops import icp as jicp
from ptudes_tpu.ops.pallas_gn import gn_from_candidates_pallas
from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.ops import cuda_gn, icp
from test_pallas_gn import _setup

torch.set_num_threads(2)

KERN, MAX_D2 = 0.1667, 2.25


@pytest.fixture(scope="module")
def scene():
    tj, src, mask, cand = _setup()
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    pcand = icp.CandidateSet(*(t(x) for x in cand))
    return (tj, src, mask, cand), (t(tj), t(src), t(mask), pcand)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


@pytest.mark.parametrize("loss", ["plane", "point"])
def test_gn_prepped_twin_matches_jax(scene, loss):
    (tj, src, mask, cand), (ptj, psrc, pmask, pcand) = scene
    kern, max_d2 = jnp.float32(KERN), jnp.float32(MAX_D2)
    refs = [
        jicp.gn_from_candidates(tj, src, mask, cand, kern, max_d2,
                                loss=loss, plane_min_quality=0.2),
        gn_from_candidates_pallas(tj, src, mask, cand, kern, max_d2,
                                  loss=loss, plane_min_quality=0.2,
                                  interpret=True)]
    prepped = cuda_gn.prep_candidates(pcand, pmask, loss=loss)
    kernels.reset_launches()
    got = cuda_gn.gn_prepped(ptj, psrc, prepped, torch.tensor(KERN),
                             torch.tensor(MAX_D2), plane_min_quality=0.2)
    assert kernels.LAUNCHES["gn_iter"] == 0      # CPU tensors: the twin
    jtj, jtr, nc, tw = got
    assert jtj.shape == (6, 6) and jtr.shape == (6,)
    assert nc.dtype == torch.int32
    for rjtj, rjtr, rnc, rtw in refs:
        assert int(nc) == int(rnc) and int(rnc) > 100
        assert _rel(jtj.numpy(), rjtj) < 1e-5
        assert _rel(jtr.numpy(), rjtr) < 1e-5
        np.testing.assert_allclose(float(tw), float(rtw), rtol=1e-5)
    if loss == "point":   # quality -1: no plane rows at all
        assert bool((prepped.feat[6] == -1).all())


def test_prep_candidates_round_trip(scene):
    """The lane-major prep and its inverse carry the gather's candidates,
    plane fit and mask unchanged (what the twin and the kernel read)."""
    _, (_, _, pmask, pcand) = scene
    prepped = cuda_gn.prep_candidates(pcand, pmask)
    n, c = pcand.valid.shape
    assert prepped.feat.shape == (8, n) and prepped.cx.shape == (c, n)
    assert all(x.is_contiguous() for x in prepped)
    back, mask = cuda_gn.candidates_from_prepped(prepped)
    assert torch.equal(mask, pmask)
    for a, b in zip(back, pcand):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(prepped.inf.numpy(),
                                  np.where(pcand.valid.numpy().T, 0, 1e30)
                                  .astype(np.float32))


def test_gn_prepped_is_the_frozen_loop_body(scene):
    """One K5 build is the first iteration of K4's twin: the same system
    solved from the same pose gives K4's first step."""
    _, (ptj, psrc, pmask, pcand) = scene
    prepped = cuda_gn.prep_candidates(pcand, pmask)
    kern, max_d2 = torch.tensor(KERN), torch.tensor(MAX_D2)
    jtj, jtr, nc, tw = cuda_gn.gn_prepped_torch(
        ptj, psrc, prepped, kern, max_d2, plane_min_quality=0.2)
    dx = icp.gn_twist(ptj, se3.inv(ptj), jtj, jtr, tw,
                      prior_rot_weight=0.01, prior_trans_weight=0.01)
    from ptudes_tpu_torch.ops import cuda_icp
    pose, n1, it, _, _ = cuda_icp.icp_loop_torch(
        psrc, prepped, ptj, kern, max_d2, 1e-4, plane_min_quality=0.2,
        max_iterations=1, prior_rot_weight=0.01, prior_trans_weight=0.01)
    assert int(it) == 1 and int(n1) == int(nc)
    torch.testing.assert_close(pose, se3.exp_twist(dx) @ ptj, rtol=0,
                               atol=0)
