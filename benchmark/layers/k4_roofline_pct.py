"""K4's share of its roofline over its launches that the traced stretch
holds: the least time a launch could take (``kernels/k4.py`` at each
scan's own source points and GN iterations and the cell's candidates a
point, against ``harness/peaks.py``; a launch of a fleet's step counts
every replica's), averaged over the stretch's launches, over the held
launches' mean device time, in %."""
import numpy as np

from benchmark.harness import peaks, trace


def read(run):
    s = run.stretch
    if s is None:
        return None
    k = run.kernel("k4")
    n_launch, secs = trace.kernel_time(s, k.SYMBOL)
    if not n_launch or not secs:
        return None
    kiss = run.ctx.cfg.kiss
    c = kiss.nn_voxels * kiss.max_points_per_voxel
    kind = run.ctx.device_kind
    one = np.array([peaks.bound_s(k.n_bytes(int(n), c),
                                  k.flops(int(n), c, int(it)), kind)
                    for n, it in zip(run.aux("source_count"),
                                     run.aux("iterations"))])
    per_launch = one.mean() * run.ctx.traffic.get("replicas", 1)
    return 100.0 * per_launch / (secs / n_launch)
