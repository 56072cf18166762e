"""PyTorch port: SO(3) / SE(3) / solve_spd6 against the JAX functions.

Inputs are made with numpy from a seed and fed to both packages. f32
throughout; tolerances are f32 roundoff of the same formulas (1e-6
absolute on unit-scale outputs, 1e-5 on translations of ~1 m)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.geom import linalg as jlinalg
from ptudes_tpu.geom import se3 as jse3
from ptudes_tpu.geom import so3 as jso3
from ptudes_tpu_torch.geom import linalg, se3, so3

torch.set_num_threads(2)

# rotation vectors: exact zero and below _EPS (series branches), small,
# moderate, and near pi
ROTVECS = np.array([
    [0.0, 0.0, 0.0], [3e-9, -2e-9, 1e-9], [1e-4, -2e-4, 3e-5],
    [0.2, -0.1, 0.3], [1.0, 0.5, -0.7], [0.0, 0.0, 3.1],
], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("i", range(len(ROTVECS)))
def test_so3_roundtrips_match_jax(i):
    v = ROTVECS[i]
    r_j = jso3.exp_rotvec(jnp.asarray(v))
    r_p = so3.exp_rotvec(_t(v))
    _close(r_p, r_j)
    _close(so3.log_rotmat(r_p), jso3.log_rotmat(r_j), atol=2e-6)
    q_j, q_p = jso3.rotvec_to_quat(jnp.asarray(v)), so3.rotvec_to_quat(_t(v))
    _close(q_p, q_j)
    _close(so3.quat_to_mat(q_p), jso3.quat_to_mat(q_j))
    _close(so3.mat_to_quat(r_p), jso3.mat_to_quat(r_j))
    _close(so3.quat_to_rotvec(q_p), jso3.quat_to_rotvec(q_j), atol=2e-6)
    _close(so3.hat(_t(v)), jso3.hat(jnp.asarray(v)))


def test_so3_batched_products_match_jax():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(8, 4)).astype(np.float32)
    q2 = rng.normal(size=(8, 4)).astype(np.float32)
    _close(so3.quat_mul(_t(q1), _t(q2)),
           jso3.quat_mul(jnp.asarray(q1), jnp.asarray(q2)), atol=2e-6)
    _close(so3.normalize_quat(_t(q1)), jso3.normalize_quat(jnp.asarray(q1)))
    rpy = np.array([0.17, -0.3, 0.8], np.float32)
    _close(so3.quat_from_euler_xyz(_t(rpy)),
           jso3.quat_from_euler_xyz(jnp.asarray(rpy)))
    # batched Rodrigues over the whole table, small-angle rows included
    _close(so3.exp_rotvec(_t(ROTVECS)), jso3.exp_rotvec(
        jnp.asarray(ROTVECS)))


@pytest.mark.parametrize("i", range(len(ROTVECS)))
def test_se3_matches_jax(i):
    tw = np.concatenate([ROTVECS[i], [0.5, -1.2, 2.0]]).astype(np.float32)
    p_j = jse3.exp_twist(jnp.asarray(tw))
    p_p = se3.exp_twist(_t(tw))
    _close(p_p, p_j, atol=1e-5)
    _close(se3.log_pose(p_p), jse3.log_pose(p_j), atol=2e-5)
    _close(se3.inv(p_p), jse3.inv(p_j), atol=1e-5)
    pts = np.random.default_rng(i).uniform(-30, 30, (64, 3)).astype(
        np.float32)
    _close(se3.transform(p_p, _t(pts)),
           jse3.transform(p_j, jnp.asarray(pts)), atol=1e-5)


def test_solve_spd6_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    spd = (a @ a.T + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    bk = rng.normal(size=(6, 4)).astype(np.float32)
    _close(linalg.solve_spd6(_t(spd), _t(b)),
           jlinalg.solve_spd6(jnp.asarray(spd), jnp.asarray(b)), atol=1e-5)
    _close(linalg.solve_spd6(_t(spd), _t(bk)),
           jlinalg.solve_spd6(jnp.asarray(spd), jnp.asarray(bk)), atol=1e-5)
    # semidefinite system: the eps floor keeps both finite and equal
    z = np.zeros((6, 6), np.float32)
    np.testing.assert_allclose(
        linalg.solve_spd6(_t(z), _t(b)).numpy(),
        np.asarray(jlinalg.solve_spd6(jnp.asarray(z), jnp.asarray(b))),
        rtol=1e-6)
