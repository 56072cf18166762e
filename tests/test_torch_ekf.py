"""PyTorch port: the EKF kernels' twins against the JAX package.

K1's twin (the "unroll" predict block, reached here through the K1
wrapper with CPU tensors) against ``predict_block_pallas(interpret=True)``
and against the JAX "unroll" form, at the bench (K = 12) and CLI (K = 16)
block sizes, with invalid samples in the middle and a timestamp out of
order; K1's own decomposition (``csrc/ekf_predict.cu``: the clock as a
max-scan, held to the serial latch rule bit for bit, the per-step terms,
the attitude chain and the block-sparse step, F_o P F_n^T from F's
nonzeros on a P symmetrised once), transcribed into torch here, against
the dense twin and JAX; K2's twin (the "xla" pose update) against
``update_pose_pallas(interpret=True)`` in both Joseph forms. The bars are
those of tests/test_esekf.py: predict state 1e-6 and cov rtol/atol 1e-5
(kernel vs unrolled chain), twist 2e-5, clock and latch exact; update
state 1e-5, cov rtol 1e-4 atol 1e-5.
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
from ptudes_tpu_torch.geom import se3, so3
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


# (state, K, valid, timestamps out of order): the CLI block size, holes in
# the middle with one sample 5 ms before its predecessor (dt clamped to 0),
# a fresh filter whose first valid sample only latches the clock
_HOLES = [i not in (3, 7, 8) for i in range(16)]
BLOCKS = {
    "cli": ("generic", 16, [i < 14 for i in range(16)], False),
    "holes_late": ("generic", 16, _HOLES, True),
    "fresh_holes": ("fresh", 12, [False, True, True, False] + [True] * 6
                    + [False] * 2, False),
}


def _block(name):
    start, k, valid, late = BLOCKS[name]
    js = generic_state(1) if start == "generic" else jesekf.init_state(
        JEkfConfig())
    lacc, avel, ts = imu_block(2, k, float(js.imu_ts))
    if late:
        ts[10] = ts[9] - np.float32(0.005)
    return js, lacc, avel, ts, np.array(valid)


def _check_predict(got, got_tw, ref, ref_tw):
    """The bars of tests/test_esekf.py: state 1e-6, cov rtol/atol 1e-5,
    twist 2e-5, clock and latch exact."""
    _close(got.pos, ref.pos, 1e-6)
    _close(got.vel, ref.vel, 1e-6)
    q0, q1 = np.asarray(got.quat), np.asarray(ref.quat)
    assert min(np.abs(q0 - q1).max(), np.abs(q0 + q1).max()) < 1e-6
    _close(got.cov, ref.cov, 1e-5, 1e-5)
    _close(got_tw, ref_tw, 2e-5)
    assert float(got.imu_ts) == float(ref.imu_ts)
    assert bool(got.initialized) == bool(ref.initialized)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_predict_twin_matches_pallas_at_cli_shape_and_holes(block):
    js, lacc, avel, ts, valid = _block(block)
    jimu = jesekf.Imu(jnp.asarray(lacc), jnp.asarray(avel), jnp.asarray(ts))
    jcfg = JEkfConfig(predict_batch="pallas")
    s_k, tw_k = predict_block_pallas(js, jimu, jnp.asarray(valid), cfg=jcfg,
                                     interpret=True, want_twist=True)
    s_u, tw_u = jesekf.process_imu_batch(
        js, jimu, jnp.asarray(valid),
        cfg=dataclasses.replace(jcfg, predict_batch="unroll"),
        want_twist=True)
    kernels.reset_launches()
    s_p, tw_p = cuda_ekf.predict_block(
        to_torch(js), esekf.Imu(torch.from_numpy(lacc),
                                torch.from_numpy(avel), torch.from_numpy(ts)),
        torch.from_numpy(valid), cfg=EkfConfig(predict_batch="cuda"),
        want_twist=True)
    assert kernels.LAUNCHES["ekf_predict"] == 0
    for ref, ref_tw in ((s_k, tw_k), (s_u, tw_u)):
        _check_predict(s_p, tw_p, ref, ref_tw)


# ------------------------------------------------- K1's decomposition

_POS, _VEL, _PHI, _BG, _BA = 0, 3, 6, 9, 12


def _term_col(j, m):
    """csrc/ekf_predict.cu:term_col: the column of term m of F's row j."""
    if j < _VEL:
        return _VEL + j if m == 1 else j
    if j < _PHI:
        return j if m == 0 else (_PHI + m - 1 if m <= 3 else _BA + m - 4)
    if j < _BG:
        return _PHI + m if m < 3 else (_BG + j - _PHI if m == 3 else j)
    return j


def _coef_rows(dt, fa, fb, rd):
    """F's rows 0-8 as the kernel's 7 coefficients each (zero-padded)."""
    c = torch.zeros((9, 7))
    for i in range(3):
        c[_POS + i, :2] = torch.stack([torch.ones(()), dt])
        c[_VEL + i] = torch.cat([torch.ones(1), fa[i], fb[i]])
        c[_PHI + i, :4] = torch.cat([rd[:, i], (-dt).reshape(1)])
    return c


def _row_terms(j):
    """csrc/ekf_predict.cu:row_terms: F's nonzeros in row j."""
    return 2 if j < _VEL else 7 if j < _PHI else 4 if j < _BG else 1


def _coef(coef, j):
    """F's row j as 7 coefficients (rows 9-17 are I's)."""
    return coef[j] if j < 9 else torch.eye(7)[0]


def _f_rows(m, coef):
    """``m @ F^T`` from F's terms: column j is F's row j applied to each
    row of ``m``; rows 9-17 of F are I's."""
    out = m.clone()
    for j in range(9):
        out[:, j] = sum(coef[j, t] * m[:, _term_col(j, t)] for t in range(7))
    return out


def _fpf(p, coef, i, j):
    """The kernel's F_o P F_n^T for the pair (i, j): o the row with fewer
    terms, one term a of it at a time times row n's 7 terms."""
    o, n = (j, i) if _row_terms(j) < _row_terms(i) else (i, j)
    fo, fn = _coef(coef, o), _coef(coef, n)
    x = torch.zeros(())
    for a in range(_row_terms(o)):
        y = sum(fn[m] * p[_term_col(o, a), _term_col(n, m)]
                for m in range(7))
        x = x + fo[a] * y
    return x


def _dense_f(dt, fa, fb, rd):
    """F as esekf.process_imu builds it."""
    f = torch.eye(18)
    eye3 = torch.eye(3)
    f[_POS:_POS + 3, _VEL:_VEL + 3] = dt * eye3
    f[_VEL:_VEL + 3, _PHI:_PHI + 3] = fa
    f[_VEL:_VEL + 3, _BA:_BA + 3] = fb
    f[_PHI:_PHI + 3, _PHI:_PHI + 3] = rd.T
    f[_PHI:_PHI + 3, _BG:_BG + 3] = -dt * eye3
    return f


def k1_decomposed(s, lacc, avel, ts, valid, cfg):
    """csrc/ekf_predict.cu's decomposition in torch (f32): the clock
    max-scan, the per-step terms, the attitude chain, F's rows as 7-term
    coefficient rows and the one-phase F_o P F_n^T steps; returns the
    state, the twist and each step's F for the checks."""
    ok = valid.to(torch.float32)
    k_steps = valid.shape[0]
    # 1. the clock as a max-scan: ts before step k is the largest valid
    # timestamp so far (with the carried ts once initialised), init the
    # largest valid flag; held to the serial latch rule bit for bit
    t, init = s.imu_ts.to(torch.float32), s.initialized.to(torch.float32)
    neg = torch.tensor(float("-inf"))
    t_valid = torch.where(ok > 0, ts, neg)
    ok_ex = torch.cat([torch.zeros(1), torch.cummax(ok, 0).values])
    t_ex = torch.cat([neg.reshape(1), torch.cummax(t_valid, 0).values])

    def ts_before(t_max):
        if init > 0:
            return torch.maximum(t_max, t)
        return t_max if t_max > neg else t

    dts, effs = [], []
    for k in range(k_steps):
        eff = ok[k] * torch.maximum(init, ok_ex[k])
        effs.append(eff)
        dts.append(torch.clamp(ts[k] - ts_before(t_ex[k]), min=0.0) * eff)
    t_ser, init_ser = t, init            # the serial chain, for the check
    for k in range(k_steps):
        if ok[k] > 0:
            t_ser = torch.maximum(ts[k], t_ser) if init_ser > 0 else ts[k]
        init_ser = torch.maximum(init_ser, ok[k])
    t, init = ts_before(t_ex[k_steps]), torch.maximum(init, ok_ex[k_steps])
    assert float(t) == float(t_ser) and float(init) == float(init_ser)
    # 2. the per-step terms (lanes k < K), free of the attitude chain
    ab = [lacc[k] - s.bias_acc for k in range(k_steps)]
    rd = [so3.exp_rotvec((avel[k] - s.bias_gyr) * dts[k])
          for k in range(k_steps)]
    # 3. the attitude chain, then the terms at the attitude before step k
    r = [so3.quat_to_mat(s.quat)]
    for k in range(k_steps):
        r.append(r[k] @ rd[k] if effs[k] > 0 else r[k])
    acc = [r[k] @ ab[k] + s.grav for k in range(k_steps)]
    fa = [-dts[k] * (r[k] @ so3.hat(ab[k])) for k in range(k_steps)]
    fb = [-dts[k] * r[k] for k in range(k_steps)]
    pos, vel = s.pos.clone(), s.vel.clone()
    for k in range(k_steps):
        pos = pos + vel * dts[k] + 0.5 * acc[k] * dts[k] * dts[k]
        vel = vel + acc[k] * dts[k]
    # 4. the block-sparse covariance steps: P symmetrised once, then each
    # pair (i <= j) gets F_o P F_n^T + W from F's nonzeros and both of its
    # entries
    coefs = [_coef_rows(dts[k], fa[k], fb[k], rd[k]) for k in range(k_steps)]
    p = 0.5 * (s.cov + s.cov.T) if k_steps else s.cov.clone()
    for k in range(k_steps):
        dt = dts[k]
        w = torch.cat([torch.zeros(3),
                       ((dt * cfg.acc_bias_std) ** 2).expand(3),
                       ((dt * cfg.gyr_bias_std) ** 2).expand(3),
                       (dt * cfg.gyr_arw * cfg.gyr_arw).expand(3),
                       (dt * cfg.acc_vrw * cfg.acc_vrw).expand(3),
                       torch.zeros(3)])
        pn = torch.empty((18, 18))
        for i in range(18):
            for j in range(i, 18):
                pn[i, j] = pn[j, i] = _fpf(p, coefs[k], i, j) + (
                    w[i] if i == j else 0.0)
        p = pn
    out = s._replace(pos=pos, vel=vel, quat=so3.mat_to_quat(r[-1]), cov=p,
                     imu_ts=t, initialized=init > 0)
    twist = se3.log_pose(se3.inv(se3.make_pose(r[0], s.pos))
                         @ se3.make_pose(r[-1], pos))
    return out, twist, [(dts[k], fa[k], fb[k], rd[k], coefs[k])
                        for k in range(k_steps)]


@pytest.mark.parametrize("block", sorted(BLOCKS) + ["bench", "empty",
                                                    "all_invalid", "k64"])
def test_k1_decomposition_matches_dense_twin_and_jax(block):
    if block in BLOCKS:
        js, lacc, avel, ts, valid = _block(block)
    else:
        k = {"bench": 12, "empty": 0, "all_invalid": 12, "k64": 64}[block]
        js = generic_state(1)
        lacc, avel, ts = imu_block(2, k, float(js.imu_ts))
        valid = np.arange(k) < (10 if block == "bench" else
                                0 if block == "all_invalid" else k)
    cfg = EkfConfig()
    s = to_torch(js)
    imus = esekf.Imu(torch.from_numpy(lacc), torch.from_numpy(avel),
                     torch.from_numpy(ts))
    got, got_tw, steps = k1_decomposed(s, *imus, torch.from_numpy(valid),
                                       cfg)
    refs = [cuda_ekf.predict_block(s, imus, torch.from_numpy(valid),
                                   cfg=cfg, want_twist=True)]
    if 0 < len(valid) <= 16:       # the interpreted TPU kernel, unrolled
        refs.append(predict_block_pallas(
            js, jesekf.Imu(*map(jnp.asarray, (lacc, avel, ts))),
            jnp.asarray(valid), cfg=JEkfConfig(predict_batch="pallas"),
            interpret=True, want_twist=True))
    for ref, ref_tw in refs:
        _check_predict(got, got_tw, ref, ref_tw)
    # F's terms hold the dense F: m @ F^T from the terms, any m
    m = torch.from_numpy(np.random.default_rng(3).normal(
        size=(18, 18)).astype(np.float32))
    for dt, fa, fb, rd, coef in steps:
        torch.testing.assert_close(_f_rows(m, coef),
                                   m @ _dense_f(dt, fa, fb, rd).T,
                                   rtol=1e-6, atol=1e-6)


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
