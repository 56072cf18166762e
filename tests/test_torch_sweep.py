"""PyTorch port: multi-bag replay (``parallel.replay``), device grids
(``parallel.mesh``) and ``ekf-bench sweep`` against the JAX package.

- ``stack_bags`` stacks states and batches; ``replay_bags`` gives each bag
  ``lio.run_sequence``'s result bit for bit (the same steps on the same
  inputs), for a frozen-candidate and a candidate-refresh configuration.
- ``make_mesh``: its [n_bags, n_pt] grid (the ``pt`` axis too, which
  ``parallel.sharded`` runs), and ``ValueError`` for a device count that
  does not fill the grid.
- ``ekf-bench sweep --device cpu`` with ``--replicas 2``, ``--bacc-z
  -0.1,0,0.1`` and ``--beams 16,8`` on tests/test_torch_cli.py's recording
  (``tools/make_fixture.generate(n_scans=8, h=16, w=128, seed=7)``)
  against the JAX command on the same file: the same variant lines, each
  variant's drift within 0.02 m of JAX's (the sequence bar) and its ATE
  within 0.005 m (the CLI tests' bar); the ``bacc_z=+0.000`` row equals
  the ``--replicas`` rows, which equal each other. On the CPU (one device)
  the command runs its variants as one program through
  ``parallel.batched.run_sequence_batched``: each variant's poses within
  1e-4 m of ``replay_bags``' on the same inputs.
"""
import dataclasses
import io
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from ptudes_tpu.cli.main import ptudes_cli
from ptudes_tpu_torch.cli import main as pcli
from ptudes_tpu_torch.models import lio
from ptudes_tpu_torch.parallel import batched, mesh, replay
from ptudes_tpu_torch.utils import convert
from test_torch_batched import N_SCANS, _render_bags, port_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIFT_BAR_M = 0.02
ATE_BAR_M = 0.005
ROW = re.compile(r"^\s*((?:replica \d+)|(?:bacc_z=\S+)|(?:beams=\d+))"
                 r"\s+(-?\d+\.\d+)(?:\s+(\d+\.\d+)\s+(\d+\.\d+))?\s*$",
                 re.M)


def _eq(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("refresh", [0.0, 0.5])
def test_replay_bags_is_run_sequence_per_bag(refresh):
    """Each bag of ``replay_bags`` is its own ``run_sequence``, bit for
    bit: final states and outputs (tests/test_batched.py's two bags at
    32 x 256, the twins of bench_config cut to that size, with frozen
    candidates and with the candidate-refresh loop)."""
    sensor, raw = _render_bags()
    cfg = port_config()
    cfg = dataclasses.replace(cfg, kiss=dataclasses.replace(
        cfg.kiss, nn_refresh_drift=refresh))
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    batches = [lio.build_batches(cfg, *r, device="cpu") for r in raw]
    states = [lio.init_state(cfg, "cpu") for _ in raw]
    st, bt = replay.stack_bags(states), replay.stack_bags(batches)
    assert st.kiss.local_map.meta.shape == (2, 1 << 14, 8)
    assert bt.range_m.shape == (2, N_SCANS, 32, 256)
    assert bt.imu.lacc.shape[:2] == (2, N_SCANS)
    fin, out = replay.replay_bags(st, bt, lut, cfg)
    assert out.kiss_pose.shape == (2, N_SCANS, 4, 4)
    for i in range(2):
        sfin, sout = lio.run_sequence(states[i], batches[i], lut, cfg=cfg)
        for a, b in zip(convert.lio_state_leaves(fin),
                        convert.lio_state_leaves(sfin)):
            _eq(a[i], b)
        for name in ("kiss_pose", "ekf_pose", "scan_valid", "ekf_cov_diag"):
            _eq(getattr(out, name)[i], getattr(sout, name))
        for a, b in zip(out.aux, sout.aux):
            _eq(a[i], b)
    # dealt over a list of devices (here the CPU twice): the same bits
    _, out2 = replay.replay_bags(st, bt, lut, cfg,
                                 devices=[torch.device("cpu")] * 2)
    _eq(out2.kiss_pose, out.kiss_pose)


def test_make_mesh():
    cpu = torch.device("cpu")
    g = mesh.make_mesh(3, devices=[cpu] * 3)
    assert g.shape == (3, 1) and all(d == cpu for d in g[:, 0])
    assert mesh.make_mesh(1, 1, devices=["cpu"]).shape == (1, 1)
    g = mesh.make_mesh(2, 2, devices=[cpu] * 4)
    assert g.shape == (2, 2) and all(d == cpu for d in g.ravel())
    with pytest.raises(ValueError, match="3x1 != 2 devices"):
        mesh.make_mesh(3, devices=[cpu] * 2)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_fixture import generate
    d = tmp_path_factory.mktemp("sweepfix")
    pcap, meta, gt = generate(str(d), n_scans=8, h=16, w=128, seed=7)
    return pcap, meta, gt


def _rows(text):
    """{variant: (drift, ate, kiss ate)} of a sweep's printed table."""
    return {m[0]: tuple(float(x) for x in m[1:] if x)
            for m in ROW.findall(text)}


@pytest.fixture(scope="module")
def sweeps(rec):
    """Each flag's JAX output, the port's output and result, and the
    arguments of the port's last ``run_sequence_batched`` call."""
    pcap, meta, gt = rec
    out = {}
    run_batched = batched.run_sequence_batched
    calls = []

    def recorded(*args, **kw):
        calls.append((args, kw))
        return run_batched(*args, **kw)

    for flag in (["--replicas", "2"], ["--bacc-z", "-0.1,0,0.1"],
                 ["--beams", "16,8"]):
        args = ["ekf-bench", "sweep", pcap, "-m", meta, "-g", gt, *flag]
        r = CliRunner().invoke(ptudes_cli, args, catch_exceptions=False)
        assert r.exit_code == 0, r.output
        buf = io.StringIO()
        batched.run_sequence_batched = recorded
        try:
            with redirect_stdout(buf):
                res = pcli.run(args + ["--device", "cpu"])
        finally:
            batched.run_sequence_batched = run_batched
        out[flag[0]] = (r.output, buf.getvalue(), res, calls[-1])
    return out


@pytest.mark.parametrize("flag", ["--replicas", "--bacc-z", "--beams"])
def test_sweep_matches_jax(sweeps, flag):
    """The port's printed lines against the JAX command's: the variants
    line, the aggregate line, each variant's row; drift within 0.02 m and
    ATE within 0.005 m of JAX's."""
    jtext, ptext, res, _ = sweeps[flag]
    jrows, prows = _rows(jtext), _rows(ptext)
    assert list(prows) == list(jrows) and len(prows) >= 2, (jrows, prows)
    nb = len(prows)
    assert f"variants: {nb}, devices: 1, mesh: single device" in ptext
    assert re.search(rf"{nb} x 8 scans in \S+ s steady-state \(\S+ "
                     r"scans/s aggregate; compile \S+ s\)", ptext)
    for name, (dj, aj, kj) in jrows.items():
        dp, ap, kp = prows[name]
        print(f"{flag} {name}: drift {dp} vs JAX {dj}, ATE {ap} vs {aj}")
        assert abs(dp - dj) <= DRIFT_BAR_M
        assert abs(ap - aj) <= ATE_BAR_M and abs(kp - kj) <= ATE_BAR_M
    assert res["ekf_poses"].shape == (nb, 8, 4, 4)
    assert np.isfinite(res["ekf_poses"]).all()


def test_sweep_replicas_and_zero_prior_agree(sweeps):
    """Identical replicas give identical rows and poses, and the
    ``bacc_z=+0.000`` variant (the default prior) is the same run."""
    rep = sweeps["--replicas"][2]
    bz = sweeps["--bacc-z"][2]
    np.testing.assert_array_equal(rep["ekf_poses"][0], rep["ekf_poses"][1])
    assert rep["rows"][0]["drift"] == rep["rows"][1]["drift"]
    k = bz["variants"].index("bacc_z=+0.000")
    np.testing.assert_array_equal(bz["ekf_poses"][k], rep["ekf_poses"][0])
    assert bz["rows"][k] == {**rep["rows"][0], "variant": "bacc_z=+0.000"}
    assert not np.array_equal(bz["ekf_poses"][0], bz["ekf_poses"][k])


@pytest.mark.parametrize("flag", ["--replicas", "--bacc-z", "--beams"])
def test_sweep_batched_matches_replay_bags(sweeps, flag):
    """On one device the command runs its variants through the batched
    driver; each variant's EKF and KISS poses are within 1e-4 m of
    ``replay_bags`` (each bag through ``run_sequence``) on the same
    states, batches and configuration (JAX's bar between its batched and
    single runs), with the same GN iterations."""
    _, _, res, ((states, batches, lut), kw) = sweeps[flag]
    _, out = replay.replay_bags(states, batches, lut, kw["cfg"])
    assert res["ekf_poses"].shape[0] == out.ekf_pose.shape[0] >= 2
    for name in ("ekf_poses", "kiss_poses"):
        want = getattr(out, name[:-1]).double().numpy()
        d = np.abs(res[name][..., :3, 3] - want[..., :3, 3]).max()
        print(f"{flag} {name}: {d:.3g} m from replay_bags")
        assert d <= 1e-4
    np.testing.assert_array_equal(res["iterations"],
                                  out.aux.iterations.numpy())


def test_sweep_flag_errors(rec):
    pcap, meta, _ = rec
    for flags in ([], ["--replicas", "2", "--beams", "8"]):
        with pytest.raises(pcli.CliError, match="exactly one"):
            pcli.run(["ekf-bench", "sweep", pcap, "-m", meta, *flags,
                      "--device", "cpu"])
