"""PyTorch port: LIO checkpoints across the two packages, and localisation
on a saved map.

tests/test_torch_lio.py's 12-scan 32 x 256 scene: scans 0-5 map, the state
is saved, and scans 6-11 continue from the loaded state, as ``ekf-bench
ouster --save-state`` and ``--resume-state`` do. A JAX checkpoint resumes
in the port and a port checkpoint in JAX, each within 0.02 m of the
unbroken run of the other package; with ``map_frozen=True`` (``--frozen-map``)
the continued run leaves the loaded map as it was, its poses within 0.02 m
of JAX's frozen run. The file layout is the JAX package's (same keys,
``FORMAT`` and ``extra``), and a template that does not match raises
``ValueError`` (tests/test_checkpoint.py:84).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptudes_tpu.models import lio as jlio
from ptudes_tpu.ops.projection import XyzLut as JXyzLut
from ptudes_tpu.utils import checkpoint as jcheckpoint
from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.models import lio
from ptudes_tpu_torch.utils import checkpoint, convert
from test_torch_lio import N_SCANS, POSE_BAR_M, jax_config, port_config, \
    render_scene

torch.set_num_threads(2)

SPLIT = 6     # scans mapped before the checkpoint


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64))[..., :3, 3].max())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages' unbroken runs, their runs of the first SPLIT scans and
    a checkpoint of each after those (``extra`` as the CLI writes it)."""
    sensor, scans, scan_ts, imu_ts, imu, gt_mid = render_scene()
    args = (scans, scan_ts, imu.lacc, imu.avel, imu_ts)
    origin = lio.time_origin(scan_ts, imu_ts)
    extra = {"file": "scene", "scans": SPLIT,
             "end_scan_ts": float(scan_ts[SPLIT - 1]),
             "time_origin": float(origin)}
    tmp = tmp_path_factory.mktemp("ckpt")
    jcfg, cfg = jax_config(), port_config()
    jlut = JXyzLut(jnp.asarray(sensor.lut.direction),
                   jnp.asarray(sensor.lut.offset))
    lut = convert.lut_from_numpy(sensor.lut, "cpu")

    jb = jlio.build_batches(jcfg, *args)
    _, jout = jlio.run_sequence(jlio.init_state(jcfg), jb, jlut, cfg=jcfg)
    jhead, _ = jlio.run_sequence(jlio.init_state(jcfg),
                                 jax.tree.map(lambda x: x[:SPLIT], jb), jlut,
                                 cfg=jcfg)
    jpath = str(tmp / "jax.npz")
    jcheckpoint.save_state(jpath, jhead, extra=extra)

    batches = lio.build_batches(cfg, *args, device="cpu")
    _, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches, lut,
                              cfg=cfg)
    head, _ = lio.run_sequence(lio.init_state(cfg, "cpu"),
                               lio.scan_at(batches, slice(0, SPLIT)), lut,
                               cfg=cfg)
    ppath = str(tmp / "port.npz")
    checkpoint.save_state(ppath, head, extra=extra)
    return dict(args=args, jlut=jlut, lut=lut, jout=jout, out=out,
                jpath=jpath, ppath=ppath, head=head, extra=extra)


def _tail_batches(run, cfg, path, jax_side=False):
    """Scans SPLIT.. batched as ``--resume-state`` does: on the
    checkpoint's clock, IMU after its last scan only."""
    scans, scan_ts, lacc, avel, imu_ts = run["args"]
    extra = (jcheckpoint if jax_side else checkpoint).checkpoint_extra(path)
    kw = dict(time_origin=extra["time_origin"],
              prev_scan_ts=extra["end_scan_ts"])
    tail = (scans[SPLIT:], scan_ts[SPLIT:], lacc, avel, imu_ts)
    if jax_side:
        return jlio.build_batches(cfg, *tail, **kw)
    return lio.build_batches(cfg, *tail, device="cpu", **kw)


def test_file_layout_matches_jax(run):
    """Same keys, dtypes, shapes and ``FORMAT``; ``extra`` round-trips; the
    port's file holds the state it saved, bit for bit."""
    with np.load(run["jpath"]) as zj, np.load(run["ppath"]) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        assert len(zp.files) == len(convert.LEAVES) + 1
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            if k != "__meta__":
                assert zj[k].shape == zp[k].shape, k
        import json
        mj, mp = (json.loads(bytes(z["__meta__"]).decode())
                  for z in (zj, zp))
    assert mp["format"] == mj["format"] == checkpoint.FORMAT \
        == jcheckpoint.FORMAT
    assert mp["n_leaves"] == mj["n_leaves"] == len(convert.LEAVES)
    assert checkpoint.checkpoint_extra(run["ppath"]) == run["extra"] \
        == jcheckpoint.checkpoint_extra(run["ppath"]) \
        == checkpoint.checkpoint_extra(run["jpath"])
    back = checkpoint.load_state(run["ppath"],
                                 lio.init_state(port_config(), "cpu"))
    for a, b in zip(convert.lio_state_leaves(back),
                    convert.lio_state_leaves(run["head"])):
        assert torch.equal(a, b)


def test_jax_checkpoint_resumes_in_the_port(run):
    cfg = port_config(bootstrap_scans=0)
    state = checkpoint.load_state(run["jpath"], lio.init_state(cfg, "cpu"))
    batches = _tail_batches(run, cfg, run["jpath"])
    # the checkpoint's clock and IMU window give the unbroken run's batches
    for a, b in zip(batches, lio.scan_at(lio.build_batches(
            cfg, *run["args"], device="cpu"), slice(SPLIT, N_SCANS))):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert torch.equal(x, y)
    _, out = lio.run_sequence(state, batches, run["lut"], cfg=cfg)
    gap = _gap(out.kiss_pose.numpy(), run["jout"].kiss_pose[SPLIT:])
    assert gap <= POSE_BAR_M, gap
    print(f"JAX save -> port load -> continue: {gap:.2e} m from JAX's "
          "unbroken run")


def test_port_checkpoint_resumes_in_jax(run):
    jcfg = jax_config(bootstrap_scans=0)
    state = jcheckpoint.load_state(run["ppath"], jlio.init_state(jcfg))
    batches = _tail_batches(run, jcfg, run["ppath"], jax_side=True)
    _, jout = jlio.run_sequence(state, batches, run["jlut"], cfg=jcfg)
    gap = _gap(jout.kiss_pose, run["out"].kiss_pose.numpy()[SPLIT:])
    assert gap <= POSE_BAR_M, gap
    # and the port's own resume is its unbroken run, bit for bit
    cfg = port_config(bootstrap_scans=0)
    state = checkpoint.load_state(run["ppath"], lio.init_state(cfg, "cpu"))
    _, out = lio.run_sequence(state, _tail_batches(run, cfg, run["ppath"]),
                              run["lut"], cfg=cfg)
    assert torch.equal(out.kiss_pose, run["out"].kiss_pose[SPLIT:])
    print(f"port save -> JAX load -> continue: {gap:.2e} m from the port's "
          "unbroken run")


def test_frozen_map_after_checkpoint_matches_jax(run):
    """``--resume-state --frozen-map``: JAX's checkpoint loaded in both
    packages, scans SPLIT.. with ``map_frozen=True``; the map after the run
    is the loaded one, bit for bit, the pose statistics move."""
    jcfg = jax_config(map_frozen=True)
    jstate = jcheckpoint.load_state(run["jpath"], jlio.init_state(jcfg))
    jfin, jout = jlio.run_sequence(
        jstate, _tail_batches(run, jcfg, run["jpath"], jax_side=True),
        run["jlut"], cfg=jcfg)
    cfg = port_config(map_frozen=True)
    state = checkpoint.load_state(run["jpath"], lio.init_state(cfg, "cpu"))
    kernels.reset_launches()
    fin, out = lio.run_sequence(state, _tail_batches(run, cfg, run["jpath"]),
                                run["lut"], cfg=cfg)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert torch.equal(fin.kiss.local_map.meta, state.kiss.local_map.meta)
    assert torch.equal(fin.kiss.local_map.points,
                       state.kiss.local_map.points)
    np.testing.assert_array_equal(fin.kiss.local_map.meta.numpy(),
                                  np.asarray(jfin.kiss.local_map.meta))
    assert int(fin.kiss.num_scans) == N_SCANS
    assert (out.aux.map_points == out.aux.map_points[0]).all()
    gap = max(_gap(out.kiss_pose.numpy(), jout.kiss_pose),
              _gap(out.ekf_pose.numpy(), jout.ekf_pose))
    assert gap <= POSE_BAR_M, gap
    print(f"frozen map after a JAX checkpoint: {gap:.2e} m from JAX")


@pytest.mark.parametrize("change", ["capacity", "points_per_voxel",
                                    "format"])
def test_mismatched_checkpoint_raises(run, tmp_path, change):
    if change == "capacity":
        like = lio.init_state(port_config(), "cpu")
        like = like._replace(kiss=like.kiss._replace(
            local_map=like.kiss.local_map._replace(
                meta=like.kiss.local_map.meta[:1024])))
        path = run["ppath"]
    elif change == "points_per_voxel":
        cfg = port_config()
        like = lio.init_state(dataclasses.replace(cfg, kiss=dataclasses.replace(
            cfg.kiss, max_points_per_voxel=4)), "cpu")
        path = run["ppath"]
    else:
        like = lio.init_state(port_config(), "cpu")
        path = str(tmp_path / "other.npz")
        with np.load(run["ppath"]) as z:
            payload = {k: z[k] for k in z.files}
        payload["__meta__"] = np.frombuffer(b'{"format": "other"}', np.uint8)
        np.savez(path, **payload)
    with pytest.raises(ValueError):
        checkpoint.load_state(path, like)
