"""Device time of the map insert (the program's ``map.insert`` stage: the
deduplicated insert with its overflow chunks, the eviction and the map's
counts), in us a scan (every replica's) over the traced stretch, from the
program's stage clock (``utils.trace.stages()``). None where the program
keeps no stage clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got, s = trace.stages(), run.stretch
    if s is None or not s.scans or "map.insert" not in got:
        return None
    return got["map.insert"][1] * 1e-3 / s.scans
