"""The traced stretch of a run: ``torch.profiler`` over a bounded part of
the window, reduced to the numbers the per-layer readers take.

Device work is every CUDA record of the trace (kernels, copies, sets);
busy time is the length of the union of their intervals, the idle share
one minus busy over the stretch. The benchmark marks its own spans with
``record_function`` (names starting ``bench.``), so an idle gap is named
by the innermost benchmark span the host was in at the gap's middle.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import NamedTuple

import torch

SPAN_PREFIX = "bench."


class Stretch(NamedTuple):
    """What one profiled stretch held."""
    window_s: float            # host clock, start to a synchronize at the end
    busy_s: float              # union of device intervals
    device_ops: int            # device records
    by_name: dict              # device op name -> (count, seconds)
    gaps: list                 # [(seconds, host span name)] longest first
    scans: int                 # scans the stretch completed


def span(name: str):
    """A benchmark span: a ``record_function`` range in a trace (costs
    nothing measurable when no profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _union(intervals) -> tuple[float, list]:
    """Length of the union of ``intervals`` [(start, end)] and the gaps
    between its pieces [(start, end)]."""
    total, gaps, cur_s, cur_e = 0.0, [], None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, a))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _innermost(spans, t) -> str:
    """The name of the shortest span in ``spans`` [(start, end, name)]
    that holds ``t``, else "outside benchmark spans"."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "outside benchmark spans"


def reduce(events, window_s: float, scans: int) -> Stretch:
    """``prof.events()`` of a stretch of ``window_s`` host seconds that
    completed ``scans`` scans, reduced (times in seconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            # a benchmark span, on the host or mirrored on the device's
            # timeline (a user annotation, no device work)
            if e.device_type != cuda:
                spans.append((a, b, e.name[len(SPAN_PREFIX):]))
        elif e.device_type == cuda:
            dev.append((a, b))
            rec = by_name[e.name]
            rec[0] += 1
            rec[1] += (b - a) * 1e-6
    busy_us, gaps_us = _union(dev)
    gaps_us.sort(key=lambda g: g[0] - g[1])
    named = [((b - a) * 1e-6, _innermost(spans, (a + b) / 2))
             for a, b in gaps_us[:10]]
    return Stretch(window_s=window_s, busy_s=busy_us * 1e-6,
                   device_ops=len(dev),
                   by_name={k: (v[0], v[1]) for k, v in by_name.items()},
                   gaps=named, scans=scans)


def kernel_time(stretch: Stretch, symbol: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``symbol`` (a ``__global__`` function's name)."""
    n, s = 0, 0.0
    for name, (count, secs) in stretch.by_name.items():
        if symbol in name:
            n += count
            s += secs
    return n, s


def breakdown(stretch: Stretch) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten longest idle gaps by host span."""
    top = sorted(stretch.by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name, secs] for name, (_, secs) in top],
            "idle_gaps": [[name, secs] for secs, name in stretch.gaps]}


class Profiler:
    """Profiles the stretch between :meth:`start` and :meth:`stop` of a
    run on ``device``; a no-op where ``enabled`` is false."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = enabled and device.type == "cuda"
        self.stretch: Stretch | None = None
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._prof is not None and self.stretch is None

    def stop(self, scans: int) -> None:
        """End the stretch after a synchronize; ``scans`` it completed."""
        if not self.running:
            return
        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.stretch = reduce(self._prof.events(), window_s, scans)
        self._prof = None

