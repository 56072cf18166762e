"""Device time of K5, one GN build (one launch a GN iteration, in the
graph form inside the refresh loop's WHILE node), in us a scan (every
replica's) over the traced stretch: the mean device time of its launches
that the trace holds, by its kernel's name, times the launches the program
counted (``kernels.LAUNCHES["gn_iter"]``). The trace holds each
conditional body's kernels once a replay, not once an execution, so it
sees the first build of each scan's loop and not the rest."""
from benchmark.harness import trace


def read(run):
    s, k5 = run.stretch, run.window.stretch_k5
    if s is None or not s.scans or not k5:
        return None
    n, secs = trace.kernel_time(s, run.kernel("k5").SYMBOL)
    return 1e6 * secs / n * k5 / s.scans if n else None
