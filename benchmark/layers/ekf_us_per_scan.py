"""Device time of the EKF (the program's ``ekf.predict`` and ``ekf.update``
stages: the IMU block's predict with K1, the pose update with K2 or its op
chain), in us a scan (every replica's) over the traced stretch, from the
program's stage clock (``utils.trace.stages()``). None where the program
keeps no stage clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got, s = trace.stages(), run.stretch
    parts = ("ekf.predict", "ekf.update")
    if s is None or not s.scans or any(k not in got for k in parts):
        return None
    return sum(got[k][1] for k in parts) * 1e-3 / s.scans
