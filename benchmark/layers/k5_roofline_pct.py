"""K5's share of its roofline over its launches that the traced stretch
holds: the least time a launch could take (``kernels/k5.py`` at each
scan's own source points and the cell's candidates a point, against
``harness/peaks.py``) over the held launches' mean device time, in %.
Where the trace holds every launch (as many as the program counted), a
launch's work is that of its active replicas: one build a GN iteration of
each scan of each replica. Otherwise the trace holds the first build of
each scan's loop (a conditional body is recorded once a replay, not once
an execution; the profiler can also drop a record), which builds for
every replica of its step, all active then."""
import numpy as np

from benchmark.harness import peaks, trace


def read(run):
    s = run.stretch
    if s is None:
        return None
    k = run.kernel("k5")
    n_launch, secs = trace.kernel_time(s, k.SYMBOL)
    if not n_launch or not secs:
        return None
    kiss = run.ctx.cfg.kiss
    c = kiss.nn_voxels * kiss.max_points_per_voxel
    kind = run.ctx.device_kind
    one = np.array([peaks.bound_s(k.n_bytes(int(n), c), k.flops(int(n), c),
                                  kind) for n in run.aux("source_count")])
    if n_launch == run.window.stretch_k5:
        per_launch = float((one * run.aux("iterations")).sum()) / n_launch
    else:
        per_launch = one.mean() * run.ctx.traffic.get("replicas", 1)
    return 100.0 * per_launch / (secs / n_launch)
