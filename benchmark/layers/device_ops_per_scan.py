"""Device records (kernels, copies, sets) of the traced stretch over the
scans it completed (every replica's)."""


def read(run):
    s = run.stretch
    return s.device_ops / s.scans if s and s.device_ops and s.scans else None
