"""What the drivers share. A traffic file names its driver (its ``driver``
key, ``drivers/<driver>.py``) and its scene (``scene.kind``,
``scenes/<kind>.py``); both are found by name (``spec``). A driver makes
the cell's recordings, warms up and captures the program's steps as
set-up, then runs the measured window and keeps what the check and the
layer readers need. Drivers call only the program's public entry points:
``lio.init_state``, ``lio.build_batches``, ``lio.run_sequence``,
``models.online.LioOnline``, ``parallel.batched.run_sequence_batched`` and
``parallel.replay.stack_bags``.

A driver returns a :class:`Window`. Its ``checks`` list what the plain
reference recomputes after the window: each a run of consecutive scans of
one recording from a fresh state (``start`` None) or from the program's
state before them (its leaves), beside the program's outputs of those
scans. Its ``runs`` hold every recording the window replayed from a fresh
state, with the program's outputs of each scan, for the independent
filter check (``check.filter_gaps``). A traced run profiles a stretch (a
chunk call, or ``trace_scans`` online scans) after the window's seconds,
and the window ends there; the spans and latencies of the per-layer
metrics leave that stretch out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import time

import numpy as np
import torch

from . import spec


@dataclasses.dataclass
class Check:
    """Scans ``lo .. lo + n - 1`` of recording ``rec`` for the reference:
    ``start`` the leaves of the program's state before them (None: a fresh
    state), the first ``boot`` with the whole-frame insert, ``out`` the
    program's outputs (a ``LioOut`` whose leading scan axis starts at
    ``lo``, or a list of one ``LioOut`` a scan from the recording's first;
    ``replica`` picks a fleet's replica on the axis before the scans'), and
    the batcher's ``prev_scan_ts`` and ``time_origin``."""
    rec: int
    lo: int
    n: int
    start: list | None
    boot: int
    out: object
    prev_scan_ts: float | None
    time_origin: float | None
    replica: int | None = None


@dataclasses.dataclass
class Run:
    """One recording replayed from a fresh state: the program's outputs of
    its scans from the first on (``LioOut``s with a leading scan axis, in
    order; ``replica`` picks a fleet's replica), and the batcher's time
    origin."""
    rec: int
    outs: list
    origin: float
    replica: int | None = None


@dataclasses.dataclass
class Window:
    seconds: float = 0.0        # the window's host time
    scans: int = 0              # scans completed (every replica's)
    latencies: list = dataclasses.field(default_factory=list)   # s
    upload_s: float = 0.0       # the benchmark's upload spans (untraced)
    upload_scans: int = 0       # the scans they uploaded
    capture_ms: float | None = None
    stretch_aux: object = None  # KissAux of the stretch's scans
    chunk_s: list = dataclasses.field(default_factory=list)
    checks: list = dataclasses.field(default_factory=list)
    runs: list = dataclasses.field(default_factory=list)
    outs: list = dataclasses.field(default_factory=list)
    # the first recording's KISS poses from its first scan on, and the
    # program's K5 launches over the stretch (its own count)
    track: list = dataclasses.field(default_factory=list)
    stretch_k5: int | None = None


class Reservoir:
    """``k`` items drawn uniformly from a stream by the seed's RNG."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, make) -> None:
        """Keep ``make()`` in the sample, or not (called once an item)."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()


def recordings(ctx, seeds) -> list:
    """One recording per seed of ``seeds``, made by the traffic's scene
    kind (``scenes/<kind>.py``) on the device."""
    geo = ctx.traffic["scene"]
    make = spec.scene_kind(geo["kind"]).recording
    return [make(ctx, seed, geo) for seed in seeds]


def imu_window(rec, lo: int, hi: int):
    """The IMU samples of scans ``lo .. hi - 1``, the end of scan ``lo -
    1`` (None for the first scan) and the batcher's time origin: the
    recording's start for every chunk, as the carried state's clock
    needs."""
    prev = float(rec.scan_ts[lo - 1]) if lo else None
    a = 0 if prev is None else int(np.searchsorted(rec.imu_ts, prev, "right"))
    b = int(np.searchsorted(rec.imu_ts, rec.scan_ts[hi - 1], "right"))
    return (rec.imu_lacc[a:b], rec.imu_avel[a:b], rec.imu_ts[a:b], prev,
            0.0)


def chunk_batches(ctx, rec, lo: int, hi: int):
    """Scans ``lo .. hi - 1`` of ``rec`` through ``lio.build_batches``
    onto the device."""
    lacc, avel, its, prev, origin = imu_window(rec, lo, hi)
    return ctx.lio.build_batches(
        ctx.cfg, rec.scans[lo:hi], rec.scan_ts[lo:hi], lacc, avel, its,
        time_origin=origin, prev_scan_ts=prev, device=ctx.device)


@contextlib.contextmanager
def no_gc():
    """The window without the garbage collector's pauses (collected just
    before)."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def sync(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def leaves(state, replica: int | None = None) -> list:
    """The tensors of a program state (nested named tuples), depth first in
    field order, each a replica's row where ``replica`` is given."""
    if isinstance(state, torch.Tensor):
        return [state if replica is None else state[replica]]
    return [x for part in state for x in leaves(part, replica)]


def chunked(ctx, win: Window, run_chunk, n: int, chunk: int, fresh,
            check_of, replicas: int | None = None) -> None:
    """The window of the chunked drivers: chunk calls until the window's
    seconds have passed, each recording (set) from ``fresh()``; the first
    chunk's check from a fresh state (``check.fresh_scans`` scans), then a
    sample of chunk starts (``check.scans`` each). ``replicas``: a fleet's
    B recordings a set, each a :class:`Run` of its own."""
    with no_gc():
        _chunk_loop(ctx, win, run_chunk, n, chunk, fresh, check_of,
                    replicas)


def _chunk_loop(ctx, win, run_chunk, n, chunk, fresh, check_of,
                replicas) -> None:
    checks = ctx.traffic["check"]
    picks = Reservoir(checks["chunks"], ctx.rng)
    launches = ctx.kernels.LAUNCHES
    calls = 0
    t0 = time.perf_counter()
    while True:
        state = fresh()
        runs = ([Run(0, [], 0.0)] if replicas is None else
                [Run(i, [], 0.0, i) for i in range(replicas)])
        win.runs += runs
        for lo in range(0, n - chunk + 1, chunk):
            traced = win.seconds >= ctx.seconds
            if traced:
                ctx.profiler.start()
                k5 = launches["gn_iter"]
            start = state
            tc = time.perf_counter()
            state, out, scans = run_chunk(state, lo, traced)
            win.chunk_s.append(time.perf_counter() - tc)
            calls += 1
            if calls * chunk <= n:
                pose = out.kiss_pose
                win.track.append(pose if pose.dim() == 3 else pose[0])
            win.scans += scans
            win.outs.append(out)
            for r in runs:
                r.outs.append(out)
            # a check covers scans of one chunk call
            if calls == 1:
                win.checks += check_of(None, out, lo,
                                       min(checks["fresh_scans"], chunk))
            else:
                picks.offer(lambda: check_of(start, out, lo,
                                             min(checks["scans"], chunk)))
            if traced:
                ctx.profiler.stop(scans)
                win.stretch_aux = out.aux
                win.stretch_k5 = launches["gn_iter"] - k5
            else:
                win.seconds = time.perf_counter() - t0
            if traced or (win.seconds >= ctx.seconds
                          and not ctx.profiler.enabled):
                for item in picks.items:
                    win.checks += item
                return
