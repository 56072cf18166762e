"""PyTorch port: the EKF kernels' twins against the JAX package.

K1's twin (the "unroll" predict block, reached here through the K1
wrapper with CPU tensors) against ``predict_block_pallas(interpret=True)``
and against the JAX "unroll" form; K2's twin (the "xla" pose update)
against ``update_pose_pallas(interpret=True)`` in both Joseph forms. The
bars are those of tests/test_esekf.py: predict state 1e-6 and cov rtol/atol
1e-5 (kernel vs unrolled chain), twist 2e-5; update state 1e-5, cov rtol
1e-4 atol 1e-5.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.config import EkfConfig as JEkfConfig
from ptudes_tpu.models import esekf as jesekf
from ptudes_tpu.ops.pallas_ekf import predict_block_pallas, \
    update_pose_pallas
from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.config import EkfConfig
from ptudes_tpu_torch.models import esekf
from ptudes_tpu_torch.ops import cuda_ekf

torch.set_num_threads(2)


def to_torch(s) -> esekf.EkfState:
    return esekf.EkfState(*[torch.from_numpy(np.array(x)) for x in s])


def generic_state(seed: int, n: int = 20, cfg=JEkfConfig()):
    """A JAX EkfState advanced by ``n`` random IMU samples."""
    rng = np.random.default_rng(seed)
    s = jesekf.init_state(cfg)
    ts = 0.0
    for _ in range(n):
        ts += 0.01
        s = jesekf.process_imu(s, jesekf.Imu(
            lacc=jnp.asarray(rng.normal(0, 1, 3) + [0, 0, 9.78], jnp.float32),
            avel=jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32),
            ts=jnp.asarray(ts, jnp.float32)), cfg=cfg)
    return s


def imu_block(seed: int, k: int, t0: float):
    rng = np.random.default_rng(seed)
    lacc = (rng.normal(0, 1, (k, 3)) + [0, 0, 9.78]).astype(np.float32)
    avel = rng.normal(0, 0.3, (k, 3)).astype(np.float32)
    ts = (t0 + np.arange(1, k + 1) * 0.01).astype(np.float32)
    return lacc, avel, ts


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("start", ["generic", "fresh"])
def test_predict_twin_matches_pallas_and_unroll(start):
    k, n_valid = 12, 10
    js = generic_state(1) if start == "generic" else jesekf.init_state(
        JEkfConfig())
    lacc, avel, ts = imu_block(2, k, float(js.imu_ts))
    valid = np.arange(k) < n_valid
    jimu = jesekf.Imu(jnp.asarray(lacc), jnp.asarray(avel), jnp.asarray(ts))
    jcfg = JEkfConfig(predict_batch="pallas")
    s_k, tw_k = predict_block_pallas(js, jimu, jnp.asarray(valid), cfg=jcfg,
                                     interpret=True, want_twist=True)
    s_u, tw_u = jesekf.process_imu_batch(
        js, jimu, jnp.asarray(valid),
        cfg=dataclasses.replace(jcfg, predict_batch="unroll"),
        want_twist=True)

    cfg = EkfConfig(predict_batch="cuda")
    kernels.reset_launches()
    s_p, tw_p = cuda_ekf.predict_block(
        to_torch(js), esekf.Imu(torch.from_numpy(lacc),
                                torch.from_numpy(avel), torch.from_numpy(ts)),
        torch.from_numpy(valid), cfg=cfg, want_twist=True)
    assert kernels.LAUNCHES["ekf_predict"] == 0   # CPU tensors: the twin
    for ref, ref_tw in ((s_k, tw_k), (s_u, tw_u)):
        _close(s_p.pos, ref.pos, 1e-6)
        _close(s_p.vel, ref.vel, 1e-6)
        q0, q1 = s_p.quat.numpy(), np.asarray(ref.quat)
        assert min(np.abs(q0 - q1).max(), np.abs(q0 + q1).max()) < 1e-6
        _close(s_p.cov, ref.cov, 1e-5, 1e-5)
        _close(tw_p, ref_tw, 2e-5)
        assert float(s_p.imu_ts) == float(ref.imu_ts)
        assert bool(s_p.initialized) == bool(ref.initialized)


def test_predict_fresh_filter_first_sample_only_latches():
    lacc, avel, ts = imu_block(3, 4, 0.0)
    valid = np.array([True, False, False, False])
    s0 = esekf.init_state(EkfConfig(), "cpu")
    s1 = cuda_ekf.predict_block(
        s0, esekf.Imu(torch.from_numpy(lacc), torch.from_numpy(avel),
                      torch.from_numpy(ts)), torch.from_numpy(valid),
        cfg=EkfConfig(predict_batch="cuda"))
    assert torch.equal(s1.pos, s0.pos) and torch.equal(s1.cov, s0.cov)
    assert float(s1.imu_ts) == float(ts[0]) and bool(s1.initialized)


@pytest.mark.parametrize("joseph", [True, False])
def test_update_twin_matches_pallas(joseph):
    jcfg = JEkfConfig(joseph_form=joseph)
    js = generic_state(5, cfg=jcfg)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jesekf.so3.quat_to_mat(
        jesekf.so3.rotvec_to_quat(jnp.asarray([0.02, -0.01, 0.03]))))
    pose[:3, 3] = [0.1, -0.2, 0.05]
    mc = np.array(jesekf.default_meas_cov(jcfg))
    ref = update_pose_pallas(js, jnp.asarray(pose), jnp.asarray(mc),
                             joseph=joseph, interpret=True)
    ref_xla = jesekf.process_pose(js, jnp.asarray(pose), cfg=jcfg)

    kernels.reset_launches()
    got = cuda_ekf.update_pose(to_torch(js), torch.from_numpy(pose),
                               torch.from_numpy(mc), joseph=joseph)
    assert kernels.LAUNCHES["ekf_update"] == 0
    for r in (ref, ref_xla):
        for f in ("pos", "vel", "bias_gyr", "bias_acc", "grav"):
            _close(getattr(got, f), getattr(r, f), 1e-5)
        q0, q1 = got.quat.numpy(), np.asarray(r.quat)
        assert min(np.abs(q0 - q1).max(), np.abs(q0 + q1).max()) < 1e-5
        _close(got.cov, r.cov, 1e-5, 1e-4)


def test_init_state_and_meas_cov_match_jax():
    cfg, jcfg = EkfConfig(), JEkfConfig()
    s, js = esekf.init_state(cfg, "cpu"), jesekf.init_state(jcfg)
    for a, b in zip(s, js):
        _close(a.numpy().astype(np.float64), np.asarray(b, np.float64), 1e-7)
    _close(esekf.default_meas_cov(cfg, "cpu"), jesekf.default_meas_cov(jcfg),
           0)
