"""The share of the traced stretch in which no device operation ran: one
minus the union of the device records' intervals over the stretch's host
time, in %."""


def read(run):
    s = run.stretch
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s and s.busy_s else None
