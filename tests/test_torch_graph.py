"""PyTorch port: the scan step's graph runner (``models.graph``) on the CPU.

A CUDA graph cannot be captured here, so each runner runs in its
capture-free mode (``capture=False``): the same static state buffers, scan
counter, ``index_select`` of the scan's inputs, ``index_copy_`` of its
outputs and in-graph copy of the new state as on the card, with only the
capture skipped. On the first 8 scans of tests/test_torch_lio.py's
32 x 256 scene at
its configuration (``bench_config``'s structure), with epoch-scale clocks
as a recording has them, the runner's rows and final state must equal the
drivers' eager loops bit for bit:

- ``lio.run_sequence`` with and without ``log`` (3 boot scans, then the
  steady step), and the schedules ``bootstrap_scans=-1`` (every scan
  boots), ``0`` (a resume after the boot scans: the steady step alone) and
  ``map_frozen`` (one step, no insert) on a map built by the first scans;
- ``parallel.batched.run_sequence_batched`` at B = 2 (the scene, and the
  scene with scan 5's IMU samples removed), the scan read on axis 1;
- ``LioOnline`` with its runner against the batch runner;
- a kept runner's later calls (``graph.RUNNERS``), loaded with a new start
  state and new batches; a point-sharded call (a gloo group of one rank
  in this process) of the same configuration and shapes takes a runner
  of its own, its rows bit-equal to the eager sharded loop's.

The eager loops these runs equal are held to JAX's: the runners' own
schedules against JAX's ``run_sequence`` on one module's JAX run in
tests/test_torch_lio.py (``test_graph_runner_matches_jax``), the frozen
map in tests/test_torch_online.py, the batched driver in
tests/test_torch_batched.py. ``graph=True`` raises on the CPU and for a
gloo process group; an NCCL group's step is capturable (the group's
backend read through ``dist.get_backend``). The conditional forms (the refresh loop, the every-
iteration query, the IF-gated insert chunks) are in
tests/test_torch_cond.py and tests/test_torch_refresh.py.
"""
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ptudes_tpu_torch.models import graph, lio
from ptudes_tpu_torch.models.online import LioOnline
from ptudes_tpu_torch.parallel import batched, replay
from ptudes_tpu_torch.utils import convert, replicas

from test_torch_lio import port_config, render_scene

torch.set_num_threads(2)

R = dataclasses.replace
EPOCH = 1.7e9
N_SCANS = 8          # the scene's first scans
BOOT = 3             # port_config()'s bootstrap scans
SPLIT = 4            # scans mapped before the frozen-map run


@pytest.fixture(scope="module")
def scene():
    sensor, scans, scan_ts, imu_ts, imu, _ = render_scene()
    raw = (scans[:N_SCANS], EPOCH + scan_ts[:N_SCANS],
           np.asarray(imu.lacc), np.asarray(imu.avel), EPOCH + imu_ts)
    cfg = port_config()
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    batches = lio.build_batches(cfg, *raw, device="cpu")
    fin, out = lio.run_sequence(lio.init_state(cfg, "cpu"), batches, lut,
                                cfg=cfg, graph=False)
    booted, _ = lio.run_sequence(lio.init_state(cfg, "cpu"),
                                 lio.scan_at(batches, slice(0, BOOT)), lut,
                                 cfg=cfg, graph=False)
    return dict(raw=raw, cfg=cfg, lut=lut, batches=batches, fin=fin,
                out=out, booted=booted)


@pytest.fixture
def gloo(tmp_path):
    """A gloo process group of one rank (this process), destroyed after
    the test with the runners that hold it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        graph.RUNNERS.clear()
        dist.destroy_process_group()


def _equal(a, b):
    la, lb = graph.leaves(a), graph.leaves(b)
    assert len(la) == len(lb) > 0
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _rows(out, rows):
    return graph.tree_map(lambda x: x[rows], out)


def _runner(cfg, lut, state, batches, log=False):
    """``lio.run_sequence``'s graph form without the capture."""
    return lio.graph_run(state, batches, lut, cfg=cfg, log=log,
                         capture=False)


def _eager(cfg, lut, state, batches, **kw):
    fin, out = lio.run_sequence(state, batches, lut, cfg=cfg, graph=False,
                                **kw)
    assert graph.LAST_RUN["form"] == "eager"
    return fin, out


@pytest.mark.parametrize("log", [False, True])
def test_runner_equals_eager_loop(scene, log):
    """3 boot scans then 5 steady ones: rows, filter history and final
    state bit for bit; the replays by step."""
    s = scene
    cfg, lut = s["cfg"], s["lut"]
    fin, out = (s["fin"], s["out"]) if not log else _eager(
        cfg, lut, lio.init_state(cfg, "cpu"), s["batches"], log=True)
    gfin, gout = _runner(cfg, lut, lio.init_state(cfg, "cpu"),
                         s["batches"], log=log)
    rec = dict(graph.LAST_RUN)
    assert rec["form"] == "static" and rec["capture_ms"] is None
    assert rec["replays"] == {"boot": BOOT, "steady": N_SCANS - BOOT}
    _equal(gout, out)
    _equal(gfin, fin)
    assert (gout.flog is not None) == log


@pytest.mark.parametrize("boot", [-1, 0])
def test_runner_bootstrap_schedules(scene, boot):
    """``bootstrap_scans=-1`` on the first 3 scans (every scan boots: the
    unbroken run's first 3) and ``0`` on scans 3-7 from the state after
    them (the steady step alone: the unbroken run's last 5 scans bit for
    bit)."""
    s = scene
    cfg, lut = R(s["cfg"], bootstrap_scans=boot), s["lut"]
    if boot < 0:
        rows, state = slice(0, BOOT), lio.init_state(cfg, "cpu")
    else:
        rows, state = slice(BOOT, N_SCANS), s["booted"]
    batches = lio.scan_at(s["batches"], rows)
    fin, out = _eager(cfg, lut, state, batches)
    gfin, gout = _runner(cfg, lut, state, batches)
    n = rows.stop - rows.start
    assert graph.LAST_RUN["replays"] == (
        {"boot": n} if boot < 0 else {"steady": n})
    _equal(gout, out)
    _equal(gfin, fin)
    _equal(gout.kiss_pose, s["out"].kiss_pose[rows])
    if boot == 0:
        _equal(gfin, s["fin"])


def test_runner_map_frozen(scene):
    """Scans 4-7 on the map of scans 0-3 with ``map_frozen``: one step,
    the map left as it is, bit for bit the eager loop (whose frozen-map
    poses tests/test_torch_online.py holds to JAX's)."""
    s = scene
    lut = s["lut"]
    state, _ = _eager(s["cfg"], lut, lio.init_state(s["cfg"], "cpu"),
                      lio.scan_at(s["batches"], slice(0, SPLIT)))
    cfg = R(s["cfg"], map_frozen=True)
    batches = lio.scan_at(s["batches"], slice(SPLIT, N_SCANS))
    fin, out = _eager(cfg, lut, state, batches)
    gfin, gout = _runner(cfg, lut, state, batches)
    assert graph.LAST_RUN["replays"] == {"steady": N_SCANS - SPLIT}
    _equal(gout, out)
    _equal(gfin, fin)
    _equal(gfin.kiss.local_map, state.kiss.local_map)


def test_runner_batched(scene):
    """``run_sequence_batched`` at B = 2 (the scene; the scene without
    scan 5's IMU samples): the batched steps through the runner on axis 1,
    bit for bit the eager loop (which tests/test_torch_batched.py holds to
    JAX's)."""
    s = scene
    cfg, lut = s["cfg"], s["lut"]
    gap = s["batches"]._replace(imu_valid=s["batches"].imu_valid.clone())
    gap.imu_valid[5] = False
    states = replay.stack_bags([lio.init_state(cfg, "cpu")] * 2)
    stacked = replay.stack_bags([s["batches"], gap])
    fin, out = batched.run_sequence_batched(states, stacked, lut, cfg=cfg,
                                            graph=False)
    assert graph.LAST_RUN["form"] == "eager"
    gfin, gout = batched.graph_run(states, stacked, lut, cfg=cfg,
                                   capture=False)
    assert graph.LAST_RUN["replays"] == {"boot": BOOT,
                                         "steady": N_SCANS - BOOT}
    _equal(gout, out)
    _equal(gfin, fin)
    assert not bool(gout.scan_valid[1, 5]) and bool(gout.scan_valid[0, 5])
    assert not torch.equal(gout.ekf_pose[0], gout.ekf_pose[1])
    _equal(_rows(gout, 0), s["out"])


def test_kept_runner_later_calls(scene):
    """A runner is kept under its key: a second call of the same shapes
    (scans 5-6 from the state after scans 3-4) is loaded into it and
    replayed, a third repeats the first; each call's rows the unbroken
    eager run's bit for bit, and the copies an earlier call returned are
    not overwritten by a later one. A new shape is a new runner."""
    s = scene
    cfg, lut = R(s["cfg"], bootstrap_scans=0), s["lut"]
    graph.RUNNERS.clear()
    calls = []
    for start in (3, 5, 3):
        state = calls[-1][0] if start == 5 else s["booted"]
        fin, out = _runner(cfg, lut, state,
                           lio.scan_at(s["batches"], slice(start, start + 2)))
        assert graph.LAST_RUN["cached"] == bool(calls)
        assert graph.LAST_RUN["replays"] == {"steady": 2}
        calls.append((fin, out))
    assert len(graph.RUNNERS) == 1
    _equal(calls[0], calls[2])
    for (_, out), start in zip(calls, (3, 5, 3)):
        _equal(out, _rows(s["out"], slice(start, start + 2)))
    _runner(cfg, lut, s["booted"], lio.scan_at(s["batches"], slice(3, 6)))
    assert not graph.LAST_RUN["cached"] and len(graph.RUNNERS) == 2


def test_kept_runner_not_reused_for_a_group(scene, gloo):
    """A kept single-card runner is not replayed for a point-sharded call
    of the same configuration and shapes: the group's backend, rank and
    world size are in the key (the rank's slice of the source is baked
    into the captured step). The sharded runner's rows and state equal the
    eager sharded loop's bit for bit, and a later sharded call reuses
    it."""
    s = scene
    cfg, lut = R(s["cfg"], bootstrap_scans=0), s["lut"]
    batches = lio.scan_at(s["batches"], slice(3, 5))
    graph.RUNNERS.clear()
    _runner(cfg, lut, s["booted"], batches)
    assert graph.group_key(gloo)[:3] == ("gloo", 0, 1)
    fin, out = _eager(cfg, lut, s["booted"], batches, group=gloo)
    for cached in (False, True):
        gfin, gout = lio.graph_run(s["booted"], batches, lut, cfg=cfg,
                                   group=gloo, capture=False)
        assert graph.LAST_RUN["cached"] == cached
        assert len(graph.RUNNERS) == 2
        assert graph.LAST_RUN["cond"]["allreduces"] == int(
            gout.aux.iterations.sum())
        _equal(gout, out)
        _equal(gfin, fin)


def test_online_runner_equals_batch_runner(scene):
    """``LioOnline`` with its runner (static inputs filled from the host
    buffers each scan), the IMU samples and scans pushed in time order:
    its rows and final state the batch runner's bit for bit."""
    s = scene
    cfg, lut = s["cfg"], s["lut"]
    scans, scan_ts, lacc, avel, imu_ts = s["raw"]
    odo = LioOnline(cfg, lut, graph=False)
    assert odo.form == "eager"
    odo._graph = odo._make_runner(capture=False)
    assert odo.form == "static"
    events = sorted([(t, 0, j) for j, t in enumerate(imu_ts)]
                    + [(t, 1, i) for i, t in enumerate(scan_ts)])
    outs = []
    for t, kind, j in events:
        if kind == 0:
            odo.push_imu(lacc[j], avel[j], t)
        else:
            outs.append(odo.push_scan(scans[j], t))
    assert odo._graph.replays == {"boot": BOOT, "steady": N_SCANS - BOOT}
    gfin, gout = _runner(cfg, lut, lio.init_state(cfg, "cpu"),
                         s["batches"])
    _equal(replicas.stack(outs), gout)
    _equal(odo.state, gfin)
    assert odo.state.kiss.pose is not odo._graph.state.kiss.pose


def test_graph_true_raises(scene, gloo):
    """``graph=True`` where no graph can run: on the CPU (each driver),
    and for a gloo process group; the refresh loop is capturable."""
    s = scene
    cfg, lut = s["cfg"], s["lut"]
    with pytest.raises(ValueError, match="CUDA device"):
        lio.run_sequence(lio.init_state(cfg, "cpu"), s["batches"], lut,
                         cfg=cfg, graph=True)
    states = replay.stack_bags([lio.init_state(cfg, "cpu")] * 2)
    with pytest.raises(ValueError, match="CUDA device"):
        batched.run_sequence_batched(
            states, replay.stack_bags([s["batches"]] * 2), lut, cfg=cfg,
            graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        LioOnline(cfg, lut, graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        graph.SequenceGraph(lio.init_state(cfg, "cpu"), s["batches"])
    cuda = torch.device("cuda", 0)
    refresh = R(cfg, kiss=R(cfg.kiss, nn_refresh_drift=0.15))
    assert graph.use_graph(True, cuda, refresh)
    with pytest.raises(ValueError, match="CUDA device"):
        lio.run_sequence(lio.init_state(refresh, "cpu"), s["batches"], lut,
                         cfg=refresh, graph=True)
    with pytest.raises(ValueError, match="gloo process group"):
        graph.use_graph(True, cuda, cfg, gloo)
    with pytest.raises(ValueError, match="gloo process group"):
        lio.run_sequence(lio.init_state(cfg, "cpu"), s["batches"], lut,
                         cfg=cfg, group=gloo, graph=True)


@pytest.mark.parametrize("kw, backend, capturable", [
    ({}, None, True),
    (dict(nn_refresh_drift=0.15), None, True),
    (dict(nn_mode="every"), None, True),
    ({}, "gloo", False),
    ({}, "nccl", True),
    (dict(nn_refresh_drift=0.15), "nccl", True),
])
def test_use_graph_resolves(kw, backend, capturable, request, monkeypatch):
    """None takes the graph on a card for every single-card configuration
    (the refresh loop and the every-iteration query too, as conditional
    nodes) and for an NCCL group's point-sharded step (its all-reduces
    captured in the GN loop's body), not for a gloo group, never on the
    CPU; False is always the eager loop. The backend is read from the
    group: a real gloo group of one rank, and for NCCL (which needs a
    card a rank) a group object whose backend ``dist.get_backend``
    reports as nccl."""
    group = None
    if backend == "gloo":
        group = request.getfixturevalue("gloo")
    elif backend == "nccl":
        group = object()
        real = dist.get_backend
        monkeypatch.setattr(dist, "get_backend", lambda g=None: (
            "nccl" if g is group else real(g)))
    cfg = port_config()
    cfg = R(cfg, kiss=R(cfg.kiss, **kw))
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert (graph.host_read_reason(cfg, group) is None) == capturable
    assert graph.use_graph(None, cuda, cfg, group) == capturable
    assert not graph.use_graph(None, cpu, cfg, group)
    assert not graph.use_graph(False, cuda, cfg, group)


class _Carry(NamedTuple):
    pose: torch.Tensor
    pose_prev: torch.Tensor
    count: torch.Tensor


def test_copy_back_aliasing():
    """The new state's ``pose_prev`` is the old ``pose`` buffer: it is
    cloned before the buffers are written; a leaf that is its own buffer
    is left alone; a wrong shape or dtype raises."""
    buf = _Carry(torch.full((4,), 1.0), torch.full((4,), 0.0),
                 torch.zeros((), dtype=torch.int32))
    new = _Carry(torch.full((4,), 2.0), buf.pose, buf.count)
    assert graph.copy_back(buf, new) == 3          # clone + two copies
    assert torch.equal(buf.pose, torch.full((4,), 2.0))
    assert torch.equal(buf.pose_prev, torch.full((4,), 1.0))
    with pytest.raises(ValueError, match="state tensor 2"):
        graph.copy_back(buf, new._replace(count=torch.zeros(())))
