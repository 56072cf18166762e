"""A recording replayed in chunks through ``lio.run_sequence`` on one kept
graph runner, the state carried, again from a fresh state when it ends;
the set-up call captures."""
from __future__ import annotations

import time

from benchmark.harness import trace
from benchmark.harness.window import (Check, Window, chunk_batches, chunked,
                                      imu_window, leaves, recordings, sync)


def run(ctx) -> Window:
    t, lio = ctx.traffic, ctx.lio
    (rec,) = ctx.recs = recordings(ctx, [ctx.seed])
    n, chunk = t["recording_scans"], t["chunk_scans"]
    ctx.mark("scene")
    lio.run_sequence(lio.init_state(ctx.cfg, ctx.device),
                     chunk_batches(ctx, rec, 0, chunk), ctx.lut, cfg=ctx.cfg)
    sync(ctx)
    win = Window(capture_ms=ctx.graph.LAST_RUN.get("capture_ms"))
    ctx.end_setup()

    def run_chunk(state, lo, traced):
        with trace.span("upload"):
            tu = time.perf_counter()
            batches = chunk_batches(ctx, rec, lo, lo + chunk)
            sync(ctx)
            if not traced:
                win.upload_s += time.perf_counter() - tu
                win.upload_scans += chunk
        with trace.span("run_sequence"):
            state, out = lio.run_sequence(state, batches, ctx.lut,
                                          cfg=ctx.cfg)
            sync(ctx)
        return state, out, chunk

    def check_of(start, out, lo, s):
        return [Check(0, lo, s, None if start is None else leaves(start),
                      min(ctx.cfg.bootstrap_scans, s), out,
                      *imu_window(rec, lo, lo + s)[3:])]

    chunked(ctx, win, run_chunk, n, chunk,
            lambda: lio.init_state(ctx.cfg, ctx.device), check_of)
    return win
