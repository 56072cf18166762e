"""The stage clock on the card: what its stamps cost, and whether its
times hold against clocks that do not depend on it.

    python3 tools/stage_clock_probe.py cost  [--json out.json]
    python3 tools/stage_clock_probe.py check [--json out.json]

Run from the root of a checkout: the program is imported from the current
directory, so a parent commit unpacked elsewhere (``git archive``) is
measured by running this file from its root (``cost`` runs on a tree
without the stage clock too). Scenes: the benchmark's circle recording
(seed 2147483747) at the two configurations of ``benchmark/configs``.

``cost``: a kept graph runner of each configuration replays one 250-scan
chunk from the same start state again and again; CUDA events around the
replays give the device ms a step, with tracing off (what the stamps cost
where nothing reads them) and, where the program has the stage clock, with
``trace.enable(True)`` and under ``torch.profiler``; the profiled run of
the bench step also gives its device operations a scan.

``check``: with tracing on, the six stages plus the gaps between steps
against CUDA events around the same replays (bench and cli chunks, a
four-replica fleet chunk, 200 online cli scans); the bench chunk's
in-step time against the device trace's busy time, the cli chunk's
``icp`` stage against K5's device time (the trace records each WHILE body
once a replay); and two whole chunk calls and the online scans with the
program's spans, for ``trace.gaps_by_span()``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import scene  # noqa: E402
from benchmark.harness import spec  # noqa: E402
from benchmark.harness import trace as bench_trace  # noqa: E402
from ptudes_tpu_torch.config import (Capacity, EkfConfig, KissConfig,  # noqa
                                     PipelineConfig)
from ptudes_tpu_torch.models import graph, lio  # noqa: E402
from ptudes_tpu_torch.parallel import batched, replay  # noqa: E402

try:
    from ptudes_tpu_torch.utils import trace
except ImportError:           # a tree without the stage clock
    trace = None

SEED = 2147483747
CHUNK = 250
DEV = torch.device("cuda", 0)


def config(name: str):
    c = spec.load_json(os.path.join("benchmark", "configs", f"{name}.json"))
    p = c["pipeline"]
    top = {k: v for k, v in p.items() if k not in ("kiss", "cap", "ekf")}
    return c, PipelineConfig(kiss=KissConfig(**p["kiss"]),
                             cap=Capacity(**p["cap"]),
                             ekf=EkfConfig(**p["ekf"]), **top)


def recording(c: dict, seed: int, n: int):
    sen = c["sensor"]
    geo = spec.load_json(os.path.join("benchmark", "traffic",
                                      "replay.json"))["scene"]
    sensor = scene.make_sensor(sen["h"], sen["w"], sen["fov_deg"])
    rec = scene.circle_recording(
        seed, sensor, n_scans=n, scan_dt=1.0 / sen["scan_hz"],
        imu_dt=1.0 / sen["imu_hz"], radius=geo["radius_m"],
        speed=geo["speed_mps"], ramp=geo["ramp_s"],
        extent=geo["world_extent_m"], n_boxes=geo["boxes"],
        world_seed=geo["world_seed"], max_range=sen["max_range_m"],
        noise_std=sen["range_noise_m"], device=DEV)
    lut = lio.XyzLut(*(torch.as_tensor(x, device=DEV)
                       for x in (sensor.direction, sensor.offset)))
    return rec, lut


def batches(cfg, rec, lo: int, hi: int):
    prev = float(rec.scan_ts[lo - 1]) if lo else None
    a = 0 if prev is None else int(np.searchsorted(rec.imu_ts, prev,
                                                   "right"))
    b = int(np.searchsorted(rec.imu_ts, rec.scan_ts[hi - 1], "right"))
    return lio.build_batches(cfg, rec.scans[lo:hi], rec.scan_ts[lo:hi],
                             rec.imu_lacc[a:b], rec.imu_avel[a:b],
                             rec.imu_ts[a:b], time_origin=0.0,
                             prev_scan_ts=prev, device=DEV)


def kept_runner(run, state, chunk):
    """The runner ``run(state, chunk)`` captured (its first call) and kept."""
    run(state, chunk)
    torch.cuda.synchronize()
    return next(reversed(graph.RUNNERS.values()))


def timed(g, state, chunk, fold=False, load=True) -> float:
    """Device ms of one replay of ``g``'s schedule from ``state`` (loaded
    first unless ``load`` is false), CUDA events around the replays (the
    counters folded after, with ``fold``)."""
    if load:
        g.load(state, chunk)
    g.begin_counts()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for name in g.schedule:
        g.step(name)
    e1.record()
    if fold:
        g.fold_counts()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def profiled(fn):
    """``fn()`` under ``torch.profiler``: (its result, the reduced trace)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, bench_trace.reduce(prof.events(), wall, CHUNK)


def entry():
    """A driver call's scope around hand-made replays (the program's
    tracing reads its switch there), where the program has one."""
    return graph.traced(DEV) if trace is not None else \
        contextlib.nullcontext()


def switch(on: bool) -> None:
    trace.enable(on)
    with entry():
        pass


def cost(reps: int) -> dict:
    out = {}
    for name in ("ouster128_bench", "ouster128_cli"):
        c, cfg = config(name)
        rec, lut = recording(c, SEED, CHUNK)
        chunk = batches(cfg, rec, 0, CHUNK)
        state = lio.init_state(cfg, DEV)
        g = kept_runner(lambda s, b: lio.run_sequence(s, b, lut, cfg=cfg),
                        state, chunk)
        timed(g, state, chunk)
        row = {"off_ms_a_step": [timed(g, state, chunk) / CHUNK
                                 for _ in range(reps)]}
        if trace is not None:
            switch(True)
            with entry():
                row["on_ms_a_step"] = [timed(g, state, chunk, True) / CHUNK
                                       for _ in range(reps)]
            switch(False)
        g.load(state, chunk)
        # the profiler turns the program's tracing on at a driver's entry
        ms, st = profiled(lambda: _in(entry, lambda: timed(
            g, state, chunk, fold=trace is not None, load=False)))
        if trace is not None:
            switch(False)
        row["profiled_ms_a_step"] = ms / CHUNK
        row["profiled_device_ops_a_scan"] = st.device_ops / CHUNK
        row["stamps_a_scan"] = bench_trace.kernel_time(
            st, "stage_stamp_kernel")[0] / CHUNK
        for k in ("off_ms_a_step", "on_ms_a_step"):
            if k in row:
                row[k.replace("_ms", "_median_ms")] = statistics.median(
                    row[k])
        out[name] = row
        graph.RUNNERS.clear()
        torch.cuda.empty_cache()
    return out


def _in(scope, fn):
    with scope():
        return fn()


def stage_sum(totals: dict) -> tuple[float, float]:
    """(in-step ms, gap ms) of stage totals."""
    step = sum(totals.get(k, (0, 0))[1] for k in trace.STAGES) * 1e-6
    return step, totals.get(trace.BETWEEN, (0, 0))[1] * 1e-6


def agree(totals: dict, events_ms: float) -> dict:
    step, gap = stage_sum(totals)
    return {"stages": totals, "in_step_ms": step, "between_ms": gap,
            "events_ms": events_ms,
            "rel_diff": (step + gap - events_ms) / events_ms}


def replay_check(g, state, chunk) -> dict:
    """Tracing switched on afresh, one replay run timed both ways."""
    switch(False)
    switch(True)
    trace.reset()
    with entry():
        ms = timed(g, state, chunk, fold=True)
    return agree(trace.stages(), ms)


def check() -> dict:
    out = {}
    c, cfg = config("ouster128_bench")
    rec, lut = recording(c, SEED, 2 * CHUNK)
    chunk = batches(cfg, rec, 0, CHUNK)
    state = lio.init_state(cfg, DEV)
    g = kept_runner(lambda s, b: lio.run_sequence(s, b, lut, cfg=cfg),
                    state, chunk)
    row = replay_check(g, state, chunk)
    trace.reset()
    g.load(state, chunk)
    ms, st = profiled(lambda: _in(entry, lambda: timed(
        g, state, chunk, fold=True, load=False)))
    step, gap = stage_sum(trace.stages())
    row.update(profiled_in_step_ms_a_scan=step / CHUNK,
               cupti_busy_ms_a_scan=st.busy_s * 1e3 / CHUNK,
               profiled_events_ms=ms,
               profiled_between_ms=gap)
    out["bench.replay"] = row
    out["bench.replay_chunks"] = chunk_calls(cfg, rec, lut)
    graph.RUNNERS.clear()

    c, cfg = config("ouster128_cli")
    rec, lut = recording(c, SEED, 2 * CHUNK)
    chunk = batches(cfg, rec, 0, CHUNK)
    state = lio.init_state(cfg, DEV)
    g = kept_runner(lambda s, b: lio.run_sequence(s, b, lut, cfg=cfg),
                    state, chunk)
    row = replay_check(g, state, chunk)
    trace.reset()
    launches = graph.kernels.LAUNCHES["gn_iter"]
    g.load(state, chunk)
    ms, st = profiled(lambda: _in(entry, lambda: timed(
        g, state, chunk, fold=True, load=False)))
    k5 = graph.kernels.LAUNCHES["gn_iter"] - launches
    n, secs = bench_trace.kernel_time(st, "gn_iter_kernel")
    row.update(icp_us_a_scan=trace.stages()["icp"][1] * 1e-3 / CHUNK,
               k5_us_a_scan=1e6 * secs / n * k5 / CHUNK if n else None,
               k5_launches=k5, k5_traced=n)
    out["cli.replay"] = row
    out["cli.replay_chunks"] = chunk_calls(cfg, rec, lut)
    graph.RUNNERS.clear()

    recs = [recording(c, 4 * SEED + i, CHUNK)[0] for i in range(4)]
    stacked = replay.stack_bags([batches(cfg, r, 0, CHUNK) for r in recs])
    states = replay.stack_bags([lio.init_state(cfg, DEV) for _ in recs])
    g = kept_runner(lambda s, b: batched.run_sequence_batched(
        s, b, lut, cfg=cfg), states, stacked)
    out["cli.fleet4"] = replay_check(g, batched.flat_states(states),
                                     stacked)
    graph.RUNNERS.clear()
    del recs, stacked, states
    torch.cuda.empty_cache()
    out["cli.online"] = online_check(cfg, rec, lut)
    switch(False)
    return out


def chunk_calls(cfg, rec, lut) -> dict:
    """Two chunk calls as the replay cell makes them (the batcher, the kept
    runner), tracing on: stages, spans and gaps by span."""
    switch(False)
    trace.enable(True)
    trace.reset()
    state = lio.init_state(cfg, DEV)
    for lo in (0, CHUNK):
        state, _ = lio.run_sequence(state, batches(cfg, rec, lo, lo + CHUNK),
                                    lut, cfg=cfg)
        torch.cuda.synchronize()
    res = {"stages": trace.stages(), "gaps_by_span": trace.gaps_by_span(),
           "spans": trace.span_table()}
    switch(False)
    return res


def online_check(cfg, rec, lut, warm: int = 8, n: int = 200) -> dict:
    from ptudes_tpu_torch.models.online import LioOnline
    switch(False)
    odo = LioOnline(cfg, lut)
    end = np.searchsorted(rec.imu_ts, rec.scan_ts, "right")

    def push(i):
        for j in range(end[i - 1] if i else 0, end[i]):
            odo.push_imu(rec.imu_lacc[j], rec.imu_avel[j], rec.imu_ts[j])
        return odo.push_scan(rec.scans[i], rec.scan_ts[i]).ekf_pose.cpu()

    n = min(n, len(rec.scan_ts) - warm)
    for i in range(warm):
        push(i)
    torch.cuda.synchronize()
    trace.enable(True)
    trace.reset()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    t0 = time.perf_counter()
    for i in range(warm, warm + n):
        push(i)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = agree(trace.stages(), e0.elapsed_time(e1))
    row.update(wall_ms_a_scan=wall * 1e3 / n,
               gaps_by_span=trace.gaps_by_span(),
               spans=trace.span_table())
    switch(False)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", choices=("cost", "check"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json")
    args = ap.parse_args()
    if args.part == "check" and trace is None:
        print("this tree has no stage clock", file=sys.stderr)
        return 2
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = {"tree": os.getcwd(), "card": card.strip(),
           "stage_clock": trace is not None,
           args.part: cost(args.reps) if args.part == "cost" else check()}
    line = json.dumps(res, default=str)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
