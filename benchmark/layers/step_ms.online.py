"""Device time of one online scan's replayed step (the program's six
stages together, on its stage clock: ``utils.trace.stages()``), in ms a
scan over the traced stretch. None where the program keeps no stage
clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got, s = trace.stages(), run.stretch
    if s is None or not s.scans or any(k not in got for k in trace.STAGES):
        return None
    return sum(got[k][1] for k in trace.STAGES) * 1e-6 / s.scans
