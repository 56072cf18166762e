"""Device time of K4, the whole frozen-candidate GN loop (one launch a
step: a scan, or a scan of every replica), in us a scan (every
replica's) over the traced stretch: the mean device time of its launches
that the trace holds, by its kernel's name, times the stretch's steps (the
profiler can drop a record)."""
from benchmark.harness import trace


def read(run):
    s = run.stretch
    if s is None or not s.scans:
        return None
    n, secs = trace.kernel_time(s, run.kernel("k4").SYMBOL)
    steps = s.scans // run.ctx.traffic.get("replicas", 1)
    return 1e6 * secs / n * steps / s.scans if n else None
