"""The card's wait between two online scans' steps: the program's stage
clock's ``between_steps`` (from one step's end to the next one's start on
the card: the host's pose read, staging and copies), in ms a gap, the
mean over the gaps it timed in the traced stretch
(``utils.trace.stages()``). None where the program keeps no stage
clock."""


def read(run):
    try:
        from ptudes_tpu_torch.utils import trace
    except ImportError:
        return None
    got = trace.stages()
    if run.stretch is None or not got.get(trace.BETWEEN, (0, 0))[0]:
        return None
    n, ns = got[trace.BETWEEN]
    return ns * 1e-6 / n
