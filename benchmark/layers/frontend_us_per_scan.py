"""Device time of the scan step's front end (the program's ``frontend``
stage: the range image to points, deskew, the voxel passes and the
compacted ICP source), in us a scan (every replica's) over the traced
stretch, from the program's stage clock (``utils.trace.stages()``, which
a ``torch.profiler`` session turns on). None where the program keeps no
stage clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got, s = trace.stages(), run.stretch
    if s is None or not s.scans or "frontend" not in got:
        return None
    return got["frontend"][1] * 1e-3 / s.scans
