"""B recordings (seeds ``seed * B + i``) replayed together in chunks of
steps through ``parallel.batched.run_sequence_batched``, the states
carried, from fresh states again when they end."""
from __future__ import annotations

import time

from benchmark.harness import trace
from benchmark.harness.window import (Check, Window, chunk_batches, chunked,
                                      imu_window, leaves, recordings, sync)


def run(ctx) -> Window:
    t, lio = ctx.traffic, ctx.lio
    b = t["replicas"]
    ctx.recs = recordings(ctx, [ctx.seed * b + i for i in range(b)])
    n, chunk = t["recording_scans"], t["chunk_scans"]
    ctx.mark("scene")

    def fresh():
        return ctx.replay.stack_bags(
            [lio.init_state(ctx.cfg, ctx.device) for _ in range(b)])

    def upload(lo):
        return ctx.replay.stack_bags(
            [chunk_batches(ctx, r, lo, lo + chunk) for r in ctx.recs])

    ctx.batched.run_sequence_batched(fresh(), upload(0), ctx.lut,
                                     cfg=ctx.cfg)
    sync(ctx)
    win = Window(capture_ms=ctx.graph.LAST_RUN.get("capture_ms"))
    ctx.end_setup()

    def run_chunk(states, lo, traced):
        with trace.span("upload"):
            tu = time.perf_counter()
            batches = upload(lo)
            sync(ctx)
            if not traced:
                win.upload_s += time.perf_counter() - tu
                win.upload_scans += b * chunk
        with trace.span("run_sequence_batched"):
            states, out = ctx.batched.run_sequence_batched(
                states, batches, ctx.lut, cfg=ctx.cfg)
            sync(ctx)
        return states, out, b * chunk

    def check_of(start, out, lo, s):
        return [Check(i, lo, s, None if start is None else leaves(start, i),
                      min(ctx.cfg.bootstrap_scans, s), out,
                      *imu_window(ctx.recs[i], lo, lo + s)[3:], replica=i)
                for i in range(b)]

    chunked(ctx, win, run_chunk, n, chunk, fresh, check_of, replicas=b)
    return win
