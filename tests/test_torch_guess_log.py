"""PyTorch port: the guess and deskew options, the associative predict and
the filter log of the LIO sequence against the JAX package.

tests/test_torch_lio.py's 12-scan 32 x 256 scene and configuration
(``bench_config``'s structure cut to the scan size), the port's twins on
the CPU against the JAX package's XLA forms, in the variants the CLI's
EKF-facing paths use: ``guess="kiss"`` (constant velocity, ``ekf-bench
ouster`` with no guess flag), ``guess="gt"`` (the ground-truth guesses,
here the exact mid-sweep poses), ``deskew_mode="kiss"`` (KISS's own
deskew), ``deskew=False`` and ``predict_batch="assoc"`` (on both sides).
Every ``kiss_pose`` and ``ekf_pose`` within 0.02 m of JAX's (the bar of
``__graft_entry__.py``'s parity checks), ``scan_valid`` equal. With
``log=True``: the knot markers equal JAX's exactly, the history's
positions within 0.02 m of JAX's, the carried poses bit-equal to the
port's run without the log, and ``flatten_filter_log`` keeps the valid
slots.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.models import lio
from ptudes_tpu_torch.utils import convert
from test_torch_lio import N_SCANS, POSE_BAR_M, jax_config, port_config, \
    render_scene

torch.set_num_threads(2)

R = dataclasses.replace

# case -> PipelineConfig changes for both packages (kiss / ekf: the
# sub-config's fields)
CASES = {
    "guess_kiss": dict(guess="kiss"),
    "guess_gt": dict(guess="gt"),
    "deskew_kiss": dict(guess="kiss", deskew_mode="kiss"),
    "no_deskew": dict(kiss=dict(deskew=False)),
    "assoc": dict(ekf=dict(predict_batch="assoc")),
}


def _apply(cfg, change):
    for part in ("kiss", "ekf"):
        if part in change:
            change = dict(change, **{part: R(getattr(cfg, part),
                                             **change[part])})
    return R(cfg, **change)


@pytest.fixture(scope="module")
def scene():
    sensor, scans, scan_ts, imu_ts, imu, gt_mid = render_scene()
    guess = np.einsum("ij,njk->nik", np.linalg.inv(gt_mid[0]), gt_mid)
    args = (scans, scan_ts, imu.lacc, imu.avel, imu_ts)
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    return dict(args=args, guess=guess, jlut=jlut,
                lut=convert.lut_from_numpy(sensor.lut, "cpu"))


def run_jax(scene, change, log=False):
    jcfg = _apply(jax_config(), change)
    jb = jlio.build_batches(jcfg, *scene["args"], guess_poses=scene["guess"])
    return jlio.run_sequence(jlio.init_state(jcfg), jb, scene["jlut"],
                             cfg=jcfg, log=log)[1]


def run_port(scene, change, log=False):
    """(port out, port batches) of the scene at ``change``."""
    cfg = _apply(port_config(), change)
    batches = lio.build_batches(cfg, *scene["args"],
                                guess_poses=scene["guess"], device="cpu")
    kernels.reset_launches()
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches,
                              scene["lut"], cfg=cfg, log=log)
    assert sum(kernels.LAUNCHES.values()) == 0   # CPU tensors: the twins
    return out, batches


def _pose_err(a, b):
    return np.linalg.norm(np.asarray(a)[..., :3, 3]
                          - np.asarray(b)[..., :3, 3], axis=-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_variant_matches_jax(scene, case):
    jout, (out, _) = run_jax(scene, CASES[case]), run_port(scene, CASES[case])
    valid = out.scan_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jout.scan_valid))
    assert valid.all()
    for key in ("kiss_pose", "ekf_pose"):
        got = getattr(out, key).double().numpy()
        assert got.shape == (N_SCANS, 4, 4) and np.isfinite(got).all()
        err = _pose_err(got, np.asarray(getattr(jout, key), np.float64))
        assert err.max() <= POSE_BAR_M, (key, err)


@pytest.mark.parametrize("case", ["bench", "assoc"])
def test_filter_log_matches_jax(scene, case):
    """``log=True`` on the bench configuration (K1's twin) and with the
    associative predict."""
    change = {"bench": {}, "assoc": CASES["assoc"]}[case]
    jout = run_jax(scene, change, log=True)
    out, batches = run_port(scene, change, log=True)
    plain, _ = run_port(scene, change)
    for key in ("kiss_pose", "ekf_pose", "ekf_cov_diag"):
        assert torch.equal(getattr(out, key), getattr(plain, key)), key
    flog, jflog = out.flog, jout.flog
    k = batches.imu_valid.shape[1]
    assert flog.pos.shape == (N_SCANS, k, 3)
    assert flog.cov_diag.shape == (N_SCANS, k, 18)
    np.testing.assert_array_equal(flog.updated.numpy(),
                                  np.asarray(jflog.updated))
    np.testing.assert_array_equal(flog.ts.numpy(), np.asarray(jflog.ts))
    pos_err = np.linalg.norm(flog.pos.numpy() - np.asarray(jflog.pos),
                             axis=-1)
    assert pos_err.max() <= POSE_BAR_M, pos_err
    # one knot a scan with samples, at its last valid slot, holding the
    # scan's post-update pose
    upd = flog.updated.numpy()
    valid = batches.imu_valid.numpy()
    assert (upd.sum(1) == valid.any(1)).all()
    last = valid.sum(1) - 1
    assert upd[np.arange(N_SCANS), last].all()
    assert torch.equal(flog.pos[torch.arange(N_SCANS), torch.from_numpy(last)],
                       out.ekf_pose[:, :3, 3])
    flat = lio.flatten_filter_log(flog, batches.imu_valid)
    assert len(flat.ts) == int(valid.sum()) == len(flat.pos)
    assert (np.diff(flat.ts) > 0).all()
    assert flat.updated.sum() == N_SCANS


def test_default_configs_are_supported():
    """A default ``PipelineConfig()`` (constant-velocity guess, associative
    predict) and the CLI's configuration at every guess flag run in the
    port."""
    for cfg in [config.PipelineConfig()] + [
            config.cli_config(64, 512, guess=g)
            for g in ("ekf", "kiss", "gt")]:
        config.check_supported(cfg)
    with pytest.raises(ValueError, match="guess"):
        config.check_supported(R(config.PipelineConfig(), guess="imu"))
    assert config.twin_config(config.PipelineConfig()).ekf.predict_batch \
        == "assoc"
