"""Device time of the registration (the program's ``icp`` stage: the
candidate gather, K3/K4 or K6, the refresh loop's WHILE node with every
GN iteration's K5, its re-gathers), in us a scan (every replica's) over
the traced stretch, from the program's stage clock
(``utils.trace.stages()``): the stage's interval holds every repeat of its
conditional nodes, which the device trace records once a replay. None
where the program keeps no stage clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got, s = trace.stages(), run.stretch
    if s is None or not s.scans or "icp" not in got:
        return None
    return got["icp"][1] * 1e-3 / s.scans
