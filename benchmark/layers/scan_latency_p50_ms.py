"""The median of the window's per-scan latencies (host clock, ms), the
scans of the traced stretch left out."""
import statistics


def read(run):
    lat = run.window.latencies
    return 1e3 * statistics.median(lat) if lat else None
