"""PyTorch port: the program's tracing (``utils.trace``) and the stage clock
(``models.graph.StageClock``) on the CPU.

The stamp kernel cannot run here; its host twin (``StageClock._twin``,
the same accounts on the host's clock) stands in for it, as the runners'
capture-free form (``capture=False``) stands in for a replayed graph:

- tracing off records nothing, makes no clock and reads nothing, and a
  span is one shared null context;
- spans: parent, request and self time on a fake clock;
- the twin's accounts on given stamps (stages, the gap between steps and
  its ring, the first gap after the switch turns on not timed), the
  calibration of the card's timer and the attribution of gaps to spans,
  as pure functions;
- the runners' capture-free forms (``lio.run_sequence``'s,
  ``run_sequence_batched``'s, ``LioOnline``'s) and the eager loop, at the
  bench path's structure and at ``cli_config``'s (refresh loop and
  overflow chunks: WHILE and IF bodies): the stages in the tiling order
  once a step, each counted once a step, none inside a conditional body,
  and rows bit-equal with tracing on and off.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.models import graph, lio
from ptudes_tpu_torch.models.online import LioOnline
from ptudes_tpu_torch.parallel import batched, replay
from ptudes_tpu_torch.utils import convert, trace

from test_torch_lio import _cut, port_config, render_scene

R = dataclasses.replace
EPOCH = 1.7e9
N_SCANS = 5
START, END, NO_COUNT = graph._START, graph._END, graph._NO_COUNT
TILING = [(0, START), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (0, NO_COUNT),
          (0, END)]


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(2)
    sensor, scans, scan_ts, imu_ts, imu, _ = render_scene()
    raw = (scans[:N_SCANS], EPOCH + scan_ts[:N_SCANS],
           np.asarray(imu.lacc), np.asarray(imu.avel), EPOCH + imu_ts)
    lut = convert.lut_from_numpy(sensor.lut, "cpu")
    return dict(raw=raw, lut=lut)


@pytest.fixture(autouse=True)
def fresh_trace():
    """Each test from tracing off, no records and no clocks."""
    trace.enable(False)
    trace.check()
    trace.reset()
    graph._CLOCKS.clear()
    graph._LIVE = None
    yield
    trace.enable(False)
    trace.check()
    trace.reset()
    graph._CLOCKS.clear()
    graph._LIVE = None
    graph.RUNNERS.clear()


class _Stamps:
    """The stamps the twin takes, in order."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = graph.StageClock.stamp

        def stamp(clock, stage, flags):
            self.seen.append((stage, flags))
            real(clock, stage, flags)
        monkeypatch.setattr(graph.StageClock, "stamp", stamp)


def _equal(a, b):
    la, lb = graph.leaves(a), graph.leaves(b)
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def _cli_config():
    """``cli_config``'s structure at the scene's size: the refresh loop (a
    WHILE node, its re-gather an IF node) and the overflow chunks (IF
    nodes)."""
    cfg = _cut(config.cli_config(32, 256))
    return R(cfg, kiss=R(cfg.kiss, max_iterations=8), bootstrap_scans=2)


# ------------------------------------------------------------ switch off

def test_off_records_nothing(scene, monkeypatch):
    """Off: a span is the shared null context, a run keeps no span, stage
    or gap, makes no stage clock and reads none, and moves no launch
    count; on, the same run gives the same rows."""
    assert trace.span("a") is trace.span("b")
    cfg = port_config()
    batches = lio.build_batches(cfg, *scene["raw"], device="cpu")

    def no_read(*a, **k):
        raise AssertionError("the stage clock was read with tracing off")
    monkeypatch.setattr(graph.StageClock, "fold", no_read)
    monkeypatch.setattr(graph, "_read", no_read)
    kernels.reset_launches()
    before = dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES)
    off = lio.graph_run(lio.init_state(cfg, "cpu"), batches, scene["lut"],
                        cfg=cfg, capture=False)
    assert not trace.on()
    assert trace.spans() == [] and trace.stages() == {}
    assert trace.gaps_by_span() == {}
    assert graph._CLOCKS == {} and graph._LIVE is None
    assert (dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES)) == before
    monkeypatch.undo()
    trace.enable(True)
    on = lio.graph_run(lio.init_state(cfg, "cpu"), batches, scene["lut"],
                       cfg=cfg, capture=False)
    assert (dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES)) == before
    _equal(on, off)
    assert trace.stages()["frontend"][0] == N_SCANS


def test_switch_follows_the_profiler():
    """A ``torch.profiler`` session turns tracing on at the next entry; its
    end turns it off again."""
    assert not trace.check()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.check()
        with trace.span("x"):
            pass
    assert not trace.check()
    assert [s.name for s in trace.spans()] == ["x"]


# ------------------------------------------------------------------ spans

def test_span_parent_self_time_and_request(monkeypatch):
    """Nested spans on a clock that ticks 10 ns a read: each span's parent,
    its request (the outermost span's id), its length and self time."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks))
    trace.enable(True)
    trace.check()
    with trace.span("root"):             # 0 .. 70
        with trace.span("a"):            # 10 .. 40
            with trace.span("b"):        # 20 .. 30
                pass
        with trace.span("c"):            # 50 .. 60
            pass
    with trace.span("next"):             # 80 .. 90
        pass
    got = {s.name: s for s in trace.spans()}
    assert [s.name for s in trace.spans()] == ["b", "a", "c", "root", "next"]
    root = got["root"]
    assert root.parent is None and root.request == root.id
    assert got["a"].parent == root.id and got["c"].parent == root.id
    assert got["b"].parent == got["a"].id
    assert {got[k].request for k in "abc"} == {root.id}
    assert got["next"].request == got["next"].id != root.id
    assert (root.start_ns, root.end_ns) == (0, 70)
    own = trace.self_ns(trace.spans())
    assert own[root.id] == 70 - 30 - 10 and own[got["a"].id] == 30 - 10
    assert trace.span_table()["root"] == (1, 70, 30)
    with trace.span("t", timed=True) as sp:
        pass
    trace.enable(False)
    trace.check()
    with trace.span("u", timed=True) as sp2:
        pass
    assert sp.ns == sp2.ns == 10
    assert [s.name for s in trace.spans()][-1] == "t"


# -------------------------------------------------- clock, pure functions

def _twin(stamps):
    """A CPU clock switched on, fed ``stamps`` [(stage, flags, now)]."""
    clock = graph.StageClock(torch.device("cpu"))
    clock.switch(True)
    for stage, flags, now in stamps:
        clock._twin(stage, flags, now)
    return clock


def test_twin_times_stages_and_gaps():
    """Two steps: each stage's ns and executions; the first step's gap is
    not timed (the switch just turned on), the second's is, into the ring;
    the output row's ``graph.io`` is not counted again; a fold moves it
    all to ``utils.trace`` with the gap on the host's clock and zeroes the
    counts."""
    step = [(0, START, 0), (1, 0, 5), (2, 0, 12), (3, 0, 30), (4, 0, 70),
            (5, 0, 75), (0, NO_COUNT, 78), (0, END, 80)]
    second = [(s, f, t + 100) for s, f, t in step]
    clock = _twin(step + second)
    clock.offset = 7.0
    clock.fold()
    got = trace.stages()
    assert got["graph.io"] == (2, 2 * (5 + 2))
    assert got["ekf.predict"] == (2, 14) and got["frontend"] == (2, 36)
    assert got["icp"] == (2, 80) and got["map.insert"] == (2, 10)
    assert got["ekf.update"] == (2, 6)
    assert got[trace.BETWEEN] == (1, 20)
    assert sum(ns for _, ns in got.values()) == 180 - 0
    assert trace._S.gaps == [(80 - 7.0, 100 - 7.0)]
    clock.fold()
    assert trace.stages() == got


def test_twin_ring_keeps_the_last_gaps(monkeypatch):
    """More gaps between two folds than the ring holds: the last ones are
    kept, the rest counted as dropped; the accumulators keep them all."""
    monkeypatch.setattr(graph, "GAP_RING", 4)
    stamps = []
    for i in range(7):
        stamps += [(0, START, 100 * i + 1), (0, END, 100 * i + 50)]
    clock = _twin(stamps)
    clock.fold()
    assert trace.stages()[trace.BETWEEN] == (6, 6 * 51)
    assert trace._S.gaps == [(100 * i + 50, 100 * i + 101)
                             for i in range(2, 6)]
    assert trace._S.dropped_gaps == 2


def test_twin_off_and_switch_on_again():
    """Off, stamps change nothing; on again, counts restart and the first
    gap is not timed."""
    clock = _twin([(0, START, 1), (0, END, 2)])
    clock.switch(False)
    clock._twin(1, 0, 3)
    clock.fold()
    assert trace.stages() == {"graph.io": (1, 1)}
    clock.switch(True)
    clock._twin(0, START, 10)
    clock._twin(0, END, 11)
    clock.fold()
    assert trace.stages()["graph.io"] == (2, 2)
    assert trace.BETWEEN not in trace.stages()


def test_calibrate_takes_the_tightest_bracket():
    samples = [(100, 5000, 140), (200, 5110, 210), (300, 5190, 330)]
    offset, err = trace.calibrate(samples)
    assert offset == 5110 - 205 and err == 5


def test_gaps_go_to_the_innermost_span():
    """Each gap to the shortest span that holds its midpoint, in any order
    of gaps and spans; a midpoint outside every span to OUTSIDE."""
    spans = [(0, 100, "outer"), (10, 40, "mid"), (20, 30, "inner"),
             (60, 90, "late"), (200, 300, "other")]
    gaps = [(24, 26), (12, 16), (50, 56), (95, 99), (150, 160), (250, 270),
            (61, 63), (31, 39)]
    got = trace.attribute(gaps[::-1], spans[::-1])
    assert got == {"inner": (1, 2), "mid": (2, 4 + 8), "outer": (2, 6 + 4),
                   trace.OUTSIDE: (1, 10), "other": (1, 20),
                   "late": (1, 2)}
    assert trace.attribute([], spans) == {}


def test_gaps_by_span_counts_open_spans(monkeypatch):
    """A span still open when the gaps are read holds them up to now."""
    trace.enable(True)
    trace.check()
    with trace.span("done"):
        pass
    s = trace.spans()[0]
    with trace.span("open") as sp:
        mid = sp.start + 1
        trace.add_gaps([(s.start_ns, s.end_ns), (mid - 1, mid + 1)])
        got = trace.gaps_by_span()
    assert got["open"][0] == 1 and got["done"][0] == 1


# ------------------------------------------------------- the runners' tiling

def _tiled(seen, steps, gaps=None):
    """Each step's stamps in the tiling order, each stage counted once a
    step, and ``gaps`` gaps timed (the first after the switch turns on
    is not: ``steps - 1``)."""
    assert seen == TILING * steps, seen
    got = trace.stages()
    assert all(got[k][0] == steps for k in trace.STAGES), got
    assert got[trace.BETWEEN][0] == (steps - 1 if gaps is None else gaps)


@pytest.mark.parametrize("structure", ["bench", "cli"])
def test_sequence_runner_tiles_each_step(scene, structure, monkeypatch):
    """``lio.run_sequence``'s capture-free runner and its eager loop: the
    stages in order once a step (none inside the refresh loop's or the
    overflow chunks' bodies: such a stamp raises), counted once a step, the
    rows as with tracing off; the spans of the run."""
    cfg = port_config() if structure == "bench" else _cli_config()
    batches = lio.build_batches(cfg, *scene["raw"], device="cpu")
    off = lio.graph_run(lio.init_state(cfg, "cpu"), batches, scene["lut"],
                        cfg=cfg, capture=False)
    if structure == "cli":
        assert graph.LAST_RUN["cond"]["gn_iter"] > N_SCANS
    stamps = _Stamps(monkeypatch)
    trace.enable(True)
    batches = lio.build_batches(cfg, *scene["raw"], device="cpu")
    on = lio.graph_run(lio.init_state(cfg, "cpu"), batches, scene["lut"],
                       cfg=cfg, capture=False)
    _equal(on, off)
    _tiled(stamps.seen, N_SCANS)
    names = [s.name for s in trace.spans()]
    assert names == ["lio.build_batches", "graph.load", "graph.replay",
                     "graph.fold_counts", "graph.outputs", "graph.run_scans"]
    trace.reset()
    stamps.seen.clear()
    eager = lio.run_sequence(lio.init_state(cfg, "cpu"), batches,
                             scene["lut"], cfg=cfg, graph=False)
    _equal(eager, off)
    _tiled(stamps.seen, N_SCANS, gaps=N_SCANS)


def test_batched_runner_tiles_each_step(scene, monkeypatch):
    """``run_sequence_batched``'s capture-free runner at B = 2: one stamp
    of each stage a step for both replicas, and the glue's spans."""
    cfg = port_config()
    batches = lio.build_batches(cfg, *scene["raw"], device="cpu")
    states = replay.stack_bags([lio.init_state(cfg, "cpu")] * 2)
    stacked = replay.stack_bags([batches, batches])
    off = batched.graph_run(states, stacked, scene["lut"], cfg=cfg,
                            capture=False)
    stamps = _Stamps(monkeypatch)
    trace.enable(True)
    on = batched.graph_run(states, stacked, scene["lut"], cfg=cfg,
                           capture=False)
    _equal(on, off)
    _tiled(stamps.seen, N_SCANS)
    names = {s.name for s in trace.spans()}
    assert {"batched.flat_states", "batched.stacked_states",
            "graph.run_scans"} <= names


def test_online_runner_tiles_each_scan(scene, monkeypatch):
    """``LioOnline``'s capture-free runner: the stages in order once a
    scan, folded after each scan, and each scan's spans under one
    ``online.push_scan`` request."""
    cfg = port_config()
    scans, scan_ts, lacc, avel, imu_ts = scene["raw"]
    stamps = _Stamps(monkeypatch)
    trace.enable(True)
    odo = LioOnline(cfg, scene["lut"], graph=False)
    odo._graph = odo._make_runner(capture=False)
    j = 0
    for i in range(N_SCANS):
        while j < len(imu_ts) and imu_ts[j] <= scan_ts[i]:
            odo.push_imu(lacc[j], avel[j], imu_ts[j])
            j += 1
        odo.push_scan(scans[i], scan_ts[i])
        assert trace.stages()["frontend"][0] == i + 1
    _tiled(stamps.seen, N_SCANS)
    spans = trace.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["online.push_scan"] * N_SCANS
    for root in roots:
        names = {s.name for s in spans if s.request == root.id}
        assert {"online.imu_window", "online.wait_copy", "online.stage",
                "online.replay", "graph.fold_counts", "online.read_row",
                "online.push_scan"} == names
    gaps = trace.gaps_by_span()
    assert sum(n for n, _ in gaps.values()) == N_SCANS - 1


def test_stage_inside_a_conditional_body_raises():
    """A stage opened inside a WHILE body would time one repeat only: the
    runner refuses it."""
    go = torch.zeros(1, dtype=torch.int32)

    def body():
        graph.stage("icp")

    def step():
        graph.while_node("loop", go, body)

    with pytest.raises(RuntimeError, match="inside a conditional body"):
        graph.run_static(step)
