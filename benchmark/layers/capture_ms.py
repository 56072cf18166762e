"""The program's own record of its graph runner's set-up (warm-up and
capture, host ms) in the set-up call: ``graph.LAST_RUN["capture_ms"]``,
or ``LioOnline.capture_ms``."""


def read(run):
    return run.window.capture_ms
