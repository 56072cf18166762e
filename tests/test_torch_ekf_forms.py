"""PyTorch port: the EKF's predict forms, filter history and filter run
against the JAX package.

The ``"assoc"`` predict (plain torch: the nav chain step by step, the
covariance as a log-depth scan of batched products) against JAX's
``"assoc"`` and the port's ``"unroll"`` at tests/test_esekf.py:222-239's
bars (pos/vel 1e-5, quat 1e-6, cov rtol 1e-3 atol 2e-3: f32
reassociation), clock and latch exact, at K = 12 and 16 with holes, a late
sample, a fresh filter and an all-invalid block; its suffix products
against a direct fold (descending: F_K ... F_k); the deskew twist of the
three forms at 2e-5 (test_esekf.py:379-405); the state priors; the
IMU-rate history of each form (``log=True``) against JAX's at
test_esekf.py:364-376's bars (state 1e-5, cov rtol 1e-4 atol 1e-5) with
the carried state bit-equal to ``log=False``; ``run_filter`` on ``ekf-bench
sim``'s defaults against JAX's at the same bars; ``sim_imu_arrays`` bit for
bit. CPU tensors, so the ``"cuda"`` forms run their twins.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.config import EkfConfig as JEkfConfig
from ptudes_tpu.models import esekf as jesekf
from ptudes_tpu.models import sim as jsim
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.config import EkfConfig
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.models import esekf, lio, sim
from test_torch_ekf import generic_state, imu_block, to_torch

torch.set_num_threads(2)

# (state, K, valid, a late sample): the bench and CLI block sizes, holes
# with one sample 5 ms before its predecessor, a fresh filter whose first
# valid sample only latches the clock, a block with no valid sample
BLOCKS = {
    "k12": ("generic", 12, [i < 10 for i in range(12)], False),
    "k16_holes_late": ("generic", 16, [i not in (3, 7, 8)
                                       for i in range(16)], True),
    "k12_fresh": ("fresh", 12, [False, True, True, False] + [True] * 6
                  + [False] * 2, False),
    "k12_all_invalid": ("generic", 12, [False] * 12, False),
    "k16": ("generic", 16, [i < 14 for i in range(16)], False),
}


def block(name):
    """(JAX state, lacc, avel, ts, valid) of a block, from seeds."""
    start, k, valid, late = BLOCKS[name]
    js = generic_state(1) if start == "generic" else jesekf.init_state(
        JEkfConfig())
    lacc, avel, ts = imu_block(2, k, float(js.imu_ts))
    if late:
        ts[10] = ts[9] - np.float32(0.005)
    return js, lacc, avel, ts, np.array(valid)


def both(js, lacc, avel, ts, valid):
    """The block's inputs for JAX and for the port."""
    jimu = jesekf.Imu(jnp.asarray(lacc), jnp.asarray(avel), jnp.asarray(ts))
    imu = esekf.Imu(torch.from_numpy(lacc), torch.from_numpy(avel),
                    torch.from_numpy(ts))
    return (jimu, jnp.asarray(valid)), (to_torch(js), imu,
                                        torch.from_numpy(valid))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _quat_close(a, b, atol):
    q0, q1 = np.asarray(a), np.asarray(b)
    assert min(np.abs(q0 - q1).max(), np.abs(q0 + q1).max()) <= atol


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_assoc_matches_jax_assoc_and_unroll(name):
    js, *inputs = block(name)
    (jimu, jvalid), (s, imu, valid) = both(js, *inputs)
    j_a = jesekf.process_imu_batch(js, jimu, jvalid,
                                   cfg=JEkfConfig(predict_batch="assoc"))
    p_a = esekf.process_imu_batch(s, imu, valid,
                                  cfg=EkfConfig(predict_batch="assoc"))
    p_u = esekf.process_imu_batch(s, imu, valid,
                                  cfg=EkfConfig(predict_batch="unroll"))
    for ref in (j_a, p_u):
        _close(p_a.pos, ref.pos, 1e-5)
        _close(p_a.vel, ref.vel, 1e-5)
        _quat_close(p_a.quat, ref.quat, 1e-6)
        _close(p_a.cov, ref.cov, 2e-3, 1e-3)
        assert float(p_a.imu_ts) == float(ref.imu_ts)
        assert bool(p_a.initialized) == bool(ref.initialized)
    assert torch.equal(p_a.cov, p_a.cov.T)      # symmetrised once
    if not valid.any():
        for a, b in zip(p_a, s):
            assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_suffix_products_descend(k):
    """G_k = F_K @ ... @ F_k, as a direct fold from the last factor; the
    ascending product F_k @ ... @ F_K is far off."""
    f = torch.from_numpy(np.random.default_rng(k).normal(
        0, 0.1, (k, 18, 18)).astype(np.float32)) + torch.eye(18)
    got = esekf.suffix_products(f)
    acc = torch.eye(18)
    for i in reversed(range(k)):
        acc = acc @ f[i]
        torch.testing.assert_close(got[i], acc, rtol=1e-5, atol=1e-5)
    if k > 1:
        asc = f[0]
        for i in range(1, k):
            asc = asc @ f[i]
        assert (asc - got[0]).abs().max() > 1e-2


@pytest.mark.parametrize("start", ["generic", "fresh"])
def test_twist_forms_agree(start):
    """want_twist gives log(T_in^-1 T_out) in every form; the forms agree
    with each other and with JAX's assoc form at 2e-5."""
    js = generic_state(3) if start == "generic" else jesekf.init_state(
        JEkfConfig())
    lacc, avel, ts = imu_block(9, 12, float(js.imu_ts))
    valid = np.arange(12) < 10
    (jimu, jvalid), (s, imu, v) = both(js, lacc, avel, ts, valid)
    _, j_tw = jesekf.process_imu_batch(
        js, jimu, jvalid, cfg=JEkfConfig(predict_batch="assoc"),
        want_twist=True)
    twists = {}
    for form in ("unroll", "assoc", "cuda"):
        st, tw = esekf.process_imu_batch(s, imu, v,
                                         cfg=EkfConfig(predict_batch=form),
                                         want_twist=True)
        _close(tw, se3.log_pose(se3.inv(esekf.pose_mat(s))
                                @ esekf.pose_mat(st)), 2e-5)
        _close(tw, j_tw, 2e-5)
        twists[form] = tw
    _close(twists["assoc"], twists["cuda"], 2e-5)
    _close(twists["unroll"], twists["cuda"], 2e-5)


def test_init_state_priors_match_jax():
    grav = np.array([0.1, -0.2, -9.7])
    bacc, bgyr = np.array([0.9, -0.2, -0.4]), np.array([0.01, 0.03, -0.012])
    js = jesekf.init_state(JEkfConfig(), init_grav=grav, init_bacc=bacc,
                           init_bgyr=bgyr)
    cfg = config.PipelineConfig()
    for prior in (np.asarray, torch.from_numpy):
        s = esekf.init_state(cfg.ekf, "cpu", init_grav=prior(grav),
                             init_bacc=prior(bacc), init_bgyr=prior(bgyr))
        for f, a, b in zip(esekf.EkfState._fields, s, js):
            assert a.dtype == torch.from_numpy(np.array(b)).dtype
            if f == "cov":     # test_torch_ekf.py's init_cov bar
                _close(a, b, 1e-7)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ls = lio.init_state(cfg, "cpu", init_grav=grav, init_bacc=bacc,
                        init_bgyr=bgyr)
    np.testing.assert_array_equal(ls.ekf.grav.numpy(), np.asarray(js.grav))
    np.testing.assert_array_equal(ls.ekf.bias_acc.numpy(),
                                  np.asarray(js.bias_acc))
    np.testing.assert_array_equal(ls.ekf.bias_gyr.numpy(),
                                  np.asarray(js.bias_gyr))


def _check_log(got, ref, k):
    """test_esekf.py:364-376's bars on every slot of a history (pos, vel,
    quat, bias_gyr, grav 1e-5; cov rtol 1e-4 atol 1e-5). Those bars leave
    out bias_acc; it is held at 3e-5 here (the filter run's 19 updates
    move it 1.7e-5 from JAX's through the f32 gains, of 0.88)."""
    assert got.pos.shape == (k, 3) and got.cov_diag.shape == (k, 18)
    np.testing.assert_array_equal(np.asarray(got.ts), np.asarray(ref.ts))
    for f in ("pos", "vel", "bias_gyr", "grav"):
        _close(getattr(got, f), getattr(ref, f), 1e-5)
    _close(got.bias_acc, ref.bias_acc, 3e-5)
    for q0, q1 in zip(np.asarray(got.att_q), np.asarray(ref.att_q)):
        _quat_close(q0, q1, 1e-5)
    _close(got.cov_diag, ref.cov_diag, 1e-5, 1e-4)
    np.testing.assert_array_equal(np.asarray(got.updated),
                                  np.asarray(ref.updated))


@pytest.mark.parametrize("form", ["unroll", "assoc", "cuda"])
@pytest.mark.parametrize("name", ["k12_fresh", "k16_holes_late",
                                  "k12_all_invalid"])
def test_history_matches_jax(form, name):
    """``log=True`` gives one entry per padded slot (the slot's timestamp;
    a padded slot repeats the carried state) holding JAX's history, while
    the carried state stays the ``log=False`` one bit for bit."""
    js, *inputs = block(name)
    (jimu, jvalid), (s, imu, valid) = both(js, *inputs)
    # JAX's history is the unrolled chain's in every form
    _, jlog = jesekf.process_imu_batch(
        js, jimu, jvalid, cfg=JEkfConfig(predict_batch="unroll"), log=True)
    cfg = EkfConfig(predict_batch=form)
    kernels.reset_launches()
    st, tw, flog = esekf.process_imu_batch(s, imu, valid, cfg=cfg,
                                           want_twist=True, log=True)
    plain, plain_tw = esekf.process_imu_batch(s, imu, valid, cfg=cfg,
                                              want_twist=True)
    assert sum(kernels.LAUNCHES.values()) == 0
    for a, b in zip((*st, tw), (*plain, plain_tw)):
        assert torch.equal(a, b)
    _check_log(flog, jlog, valid.shape[0])
    if form != "assoc":
        # the history ends where the carried state is
        for f, g in (("pos", "pos"), ("vel", "vel"), ("att_q", "quat")):
            assert torch.equal(getattr(flog, f)[-1], getattr(st, g))
        torch.testing.assert_close(flog.cov_diag[-1],
                                   torch.diagonal(st.cov), rtol=0, atol=0)


@pytest.mark.parametrize("update_form", ["xla", "cuda"])
def test_run_filter_matches_jax(update_form):
    """``ekf-bench sim``'s defaults (cli/main.py:204-240: 2 s at 100 Hz,
    noise 0.4 / 0.4, seed 42, a correction every 10 steps at the poses of
    the noise-free run). Both filters get JAX's noise-free poses: the two
    noise-free runs themselves drift 2.6e-6 m apart over the 200 steps,
    which the corrections would carry into the comparison."""
    n = 200
    ideal, noisy = jsim.sim_imu_arrays(42, n, acc_noise_std=0.4,
                                       gyr_noise_std=0.4)
    jcfg = JEkfConfig()
    _, jlog_gt = jesekf.run_filter(
        jesekf.init_state(jcfg), ideal, jnp.zeros(n, bool),
        jnp.tile(jnp.eye(4), (n, 1, 1)), cfg=jcfg)
    gt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    gt[:, :3, :3] = np.asarray(jesekf.so3.quat_to_mat(jlog_gt.att_q))
    gt[:, :3, 3] = np.asarray(jlog_gt.pos)
    corr = (np.arange(n) % 10 == 0) & (np.arange(n) > 0)
    js, jlog = jesekf.run_filter(jesekf.init_state(jcfg), noisy,
                                 jnp.asarray(corr), jnp.asarray(gt), cfg=jcfg)

    _, p_noisy = sim.sim_imu_arrays(42, n, acc_noise_std=0.4,
                                    gyr_noise_std=0.4, device="cpu")
    cfg = EkfConfig(update_form=update_form)
    kernels.reset_launches()
    s, flog = esekf.run_filter(esekf.init_state(cfg, "cpu"), p_noisy,
                               torch.from_numpy(corr), torch.from_numpy(gt),
                               cfg=cfg)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert int(flog.updated.sum()) == 19
    _check_log(flog, jlog, n)
    for f in ("pos", "vel", "bias_gyr", "grav"):
        _close(getattr(s, f), getattr(js, f), 1e-5)
    _close(s.bias_acc, js.bias_acc, 3e-5)
    _quat_close(s.quat, js.quat, 1e-5)
    _close(s.cov, js.cov, 1e-5, 1e-4)


@pytest.mark.parametrize("seed,n", [(42, 200), (5, 16)])
def test_sim_imu_arrays_match_jax(seed, n):
    for got, ref in zip(sim.sim_imu_arrays(seed, n, device="cpu"),
                        jsim.sim_imu_arrays(seed, n)):
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
