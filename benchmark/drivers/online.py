"""One recording pushed scan by scan into ``LioOnline`` in a closed loop: a
scan's IMU samples and range image go in once the last pose is on the
host, and its latency runs from there to its pose on the host. The first
``warmup_scans`` scans are set-up (they capture both steps); the window
runs on from there."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import trace
from benchmark.harness.window import (Check, Reservoir, Run, Window, leaves,
                                      no_gc, recordings, sync)


def run(ctx) -> Window:
    t = ctx.traffic
    (rec,) = ctx.recs = recordings(ctx, [ctx.seed])
    n, warm = t["recording_scans"], t["warmup_scans"]
    s, s0 = t["check"]["scans"], t["check"]["fresh_scans"]
    boot_n = ctx.cfg.bootstrap_scans
    ctx.mark("scene")
    odo = ctx.online.LioOnline(ctx.cfg, ctx.lut)
    imu_end = np.searchsorted(rec.imu_ts, rec.scan_ts, "right")
    outs = []

    def push(i):
        for j in range(imu_end[i - 1] if i else 0, imu_end[i]):
            odo.push_imu(rec.imu_lacc[j], rec.imu_avel[j], rec.imu_ts[j])
        out = odo.push_scan(rec.scans[i], rec.scan_ts[i])
        pose = out.ekf_pose.cpu()
        outs.append(out)
        return pose

    launches = ctx.kernels.LAUNCHES
    for i in range(warm):
        push(i)
    sync(ctx)
    win = Window(capture_ms=odo.capture_ms)
    ctx.end_setup()
    origin = odo.time_origin

    def check_at(i, start, k):
        return Check(0, i, k, start, max(0, min(boot_n - i, k)), None,
                     float(rec.scan_ts[i - 1]) if i else None, origin)

    win.checks.append(check_at(0, None, s0))
    picks = Reservoir(t["check"]["picks"], ctx.rng)
    i = warm
    trace_n = t["trace_scans"]
    with no_gc():
        t0 = time.perf_counter()
        while i + s <= n:
            traced = win.seconds >= ctx.seconds
            if traced and not ctx.profiler.running:
                ctx.profiler.start()
                k5, i0 = launches["gn_iter"], i
            picks.offer(lambda: check_at(i, leaves(odo.state), s))
            with trace.span("scan"):
                ts = time.perf_counter()
                push(i)
                lat = time.perf_counter() - ts
            i += 1
            if not traced:
                win.latencies.append(lat)
                win.seconds = time.perf_counter() - t0
            elif i - i0 == trace_n:
                ctx.profiler.stop(trace_n)
                win.stretch_aux = type(outs[-1].aux)(*map(torch.stack, zip(
                    *(o.aux for o in outs[-trace_n:]))))
                win.stretch_k5 = launches["gn_iter"] - k5
            if (traced and ctx.profiler.stretch) or (
                    win.seconds >= ctx.seconds and not ctx.profiler.enabled):
                break
        else:
            raise RuntimeError(f"the recording's {n} scans ran out before "
                               f"the window's {ctx.seconds} s")
    # the checks need the program's outputs of the scans that follow their
    # starts: run those on (outside the window) where they are not
    while i < min(n, max(c.lo + c.n for c in picks.items + win.checks)):
        push(i)
        i += 1
    win.scans = i - warm
    win.checks += picks.items
    for c in win.checks:
        c.out = outs
    win.outs = outs[warm:warm + win.scans]
    win.track = [o.kiss_pose[None] for o in outs]
    win.runs.append(Run(0, [_scan_axis(o) for o in outs], origin))
    return win


def _scan_axis(out):
    """One scan's ``LioOut`` with a leading scan axis of one."""
    return type(out)(*(None if x is None else (
        type(x)(*(y[None] for y in x)) if isinstance(x, tuple) else x[None])
        for x in out))
