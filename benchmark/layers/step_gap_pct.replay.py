"""The card's wait between replayed steps: the program's stage clock's
``between_steps`` (from one step's end to the next one's start, on the
card) over it plus the steps' own time (the six stages), in %, over the
traced stretch (``utils.trace.stages()``). None where the program keeps
no stage clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got = trace.stages()
    if run.stretch is None or trace.BETWEEN not in got:
        return None
    gap = got[trace.BETWEEN][1]
    step = sum(got[k][1] for k in trace.STAGES if k in got)
    return 100.0 * gap / (gap + step) if gap + step else None
