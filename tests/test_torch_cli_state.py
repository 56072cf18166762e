"""PyTorch port: ``ekf-bench ouster --save-state``, ``--resume-state
--start-scan`` and ``--frozen-map`` with ``--device cpu`` against the JAX
command, on tests/test_cli.py's recording at its small capacities.

Each package maps scans 0-3 and saves its state, then resumes from its own
checkpoint on scans 4-7, once mapping and once localising on the frozen
map. Every stage's saved KITTI poses lie within 0.02 m of the JAX
command's and its printed ATE within 0.005 m; the port also resumes from
the JAX command's checkpoint (the two packages write the same file), and
its frozen-map configuration is the JAX command's field by field.
"""
import dataclasses

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from ptudes_tpu.cli.main import ptudes_cli
from ptudes_tpu_torch.cli import main as pcli
from ptudes_tpu_torch.io import metadata
from ptudes_tpu_torch.utils import checkpoint

from test_torch_cli import ATE, ATE_BAR_M, POSE_BAR_M, SMALL_CAPS, jax_cli, \
    port_cli, rec  # noqa: F401 (the module fixture)

torch.set_num_threads(2)

STAGES = {"save": ["--end-scan", "3"],
          "resume": ["--start-scan", "4"],
          "frozen": ["--start-scan", "4", "--frozen-map"]}


def _args(rec, stage, tag, ckpt):
    d, pcap, meta, gt = rec
    args = ["ekf-bench", "ouster", pcap, "-m", meta, "--use-imu-prediction",
            "-g", gt, "--save-kitti-poses", str(d / f"{tag}_{stage}.txt")]
    args += STAGES[stage] + SMALL_CAPS
    return args + (["--save-state", ckpt] if stage == "save"
                   else ["--resume-state", ckpt])


@pytest.fixture(scope="module")
def jax_runs(rec):
    """The JAX command's three stages: {stage: (poses, output)}."""
    d = rec[0]
    ckpt = str(d / "jax_state.npz")
    runs = {}
    for stage in STAGES:
        out = jax_cli(_args(rec, stage, "jax", ckpt))
        runs[stage] = (np.loadtxt(d / f"jax_{stage}.txt").reshape(-1, 3, 4),
                       out)
    return runs, ckpt


def _close(rec, stage, tag, out, jax_runs):
    jposes, jout = jax_runs[0][stage]
    p = np.loadtxt(rec[0] / f"{tag}_{stage}.txt").reshape(-1, 3, 4)
    assert p.shape == jposes.shape == (4, 3, 4) and np.isfinite(p).all()
    err = np.linalg.norm(p[:, :, 3] - jposes[:, :, 3], axis=1)
    assert err.max() <= POSE_BAR_M, (stage, err)
    got, want = ATE.findall(out), ATE.findall(jout)
    assert len(got) == len(want) == 2
    for (_, a), (_, b) in zip(got, want):
        assert abs(float(a) - float(b)) <= ATE_BAR_M, (stage, a, b)


def test_save_resume_frozen(rec, capsys, jax_runs):
    ckpt = str(rec[0] / "port_state.npz")
    results = {}
    for stage in STAGES:
        res, out = port_cli(capsys, _args(rec, stage, "port", ckpt))
        _close(rec, stage, "port", out, jax_runs)
        results[stage] = res
        if stage != "save":
            assert "resumed pipeline state from" in out
    extra = checkpoint.checkpoint_extra(ckpt)
    assert extra["scans"] == 4 and extra["time_origin"] > 1.7e9
    assert extra == checkpoint.checkpoint_extra(jax_runs[1])
    # the frozen run leaves the saved map as it was
    saved = checkpoint.load_state(ckpt, results["save"]["state"])
    for a, b in zip(results["frozen"]["state"].kiss.local_map,
                    saved.kiss.local_map):
        assert torch.equal(a, b)
    assert results["frozen"]["cfg"].map_frozen


@pytest.mark.parametrize("stage", ["resume", "frozen"])
def test_resume_from_the_jax_checkpoint(rec, capsys, jax_runs, stage):
    _, out = port_cli(capsys, _args(rec, stage, "cross", jax_runs[1]))
    _close(rec, stage, "cross", out, jax_runs)


class _Captured(Exception):
    pass


def test_frozen_config_matches_the_jax_command(rec, monkeypatch, jax_runs):
    import ptudes_tpu.models.lio as jlio
    seen = []

    def capture(state, batches, lut, *, cfg, **kw):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jlio, "run_sequence", capture)
    args = _args(rec, "frozen", "cfg", jax_runs[1])
    r = CliRunner().invoke(ptudes_cli, args)
    assert isinstance(r.exception, _Captured), r.output
    p = pcli.build_config(pcli.build_parser().parse_args(
        args + ["--device", "cpu"]), metadata.read_metadata_json(rec[2]))
    a = dataclasses.asdict(p)
    b = dataclasses.asdict(seen[0])
    for part, keys in (("kiss", ("icp_form", "gn_backend", "gn_unroll")),
                       ("ekf", ("predict_batch", "update_form"))):
        for k in keys:
            a[part].pop(k, None)
            b[part].pop(k, None)
    b.pop("scan_unroll")
    assert a == b and p.map_frozen
