"""The program's tracing: host spans, and the totals of the stage clock on
the card (``models.graph.StageClock``), on one clock.

Off by default. It is on while :func:`enable` has set it (an operator's
switch) or while a ``torch.profiler`` session records. The drivers read
the switch once at each entry (:func:`check`: ``lio.build_batches``,
``models.graph.run_scans``, the eager loops, ``LioOnline.push_scan``),
never inside a span or once a replay. Off, :func:`span` returns one
shared null context, nothing is recorded and nothing is read from the
card.

On:

- :func:`span` keeps each span in memory, as a :class:`Span` (its name,
  its parent's id, the request it belongs to: the id of the outermost span
  open around it, and its start and end in ``time.perf_counter_ns``), and
  on a CUDA build marks it as an NVTX range named ``ptudes.<name>`` (for
  tools that read NVTX; ``torch.profiler`` records no NVTX range, so a
  span adds nothing to its device timeline);
- the stage clock times each stage of the scan step on the card, every
  repeat of a WHILE or IF node inside its stage, and the gap from one
  step's end to the next step's start (:data:`BETWEEN`); the drivers add
  its totals here after each run (:func:`stages`) with the gaps' ends,
  which :func:`calibrate` puts on the host's clock;
- :func:`gaps_by_span` charges each gap to the innermost span that was
  open on the host at the gap's midpoint.

One thread: the spans of a process nest in the order they are opened.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

import torch

# the scan step's stages, in the order a step runs them (its first stage
# opens again, uncounted, for the output row at its end)
STAGES = ("graph.io", "ekf.predict", "frontend", "icp", "map.insert",
          "ekf.update")
BETWEEN = "between_steps"    # from a step's end to the next step's start
NVTX_PREFIX = "ptudes."
OUTSIDE = "outside program spans"
MAX_RECORDS = 1 << 20        # spans and gaps kept, the oldest dropped


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None       # the enclosing span's id
    request: int             # the outermost enclosing span's id (or its own)
    start_ns: int            # time.perf_counter_ns
    end_ns: int


class _Null:
    """The span of tracing off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _State:
    def __init__(self):
        self.user = False        # enable()'s switch
        self.on = False          # the switch as the last check() read it
        self.nvtx = False
        self.next_id = 0
        self.stack: list[_Span] = []
        self.spans: list[Span] = []
        self.stages: dict = defaultdict(lambda: [0, 0])
        self.gaps: list[tuple[int, int]] = []
        self.dropped_gaps = 0


_S = _State()


class _Span:
    """An open span; ``ns`` its length once closed. Kept only if tracing
    was on when it opened (a ``timed`` span is measured either way)."""
    __slots__ = ("name", "keep", "id", "parent", "request", "start", "ns")

    def __init__(self, name: str, keep: bool):
        self.name, self.keep, self.ns = name, keep, 0

    def __enter__(self):
        if self.keep:
            st = _S.stack
            self.id = _S.next_id
            _S.next_id += 1
            self.parent = st[-1].id if st else None
            self.request = st[-1].request if st else self.id
            st.append(self)
            if _S.nvtx:
                torch.cuda.nvtx.range_push(NVTX_PREFIX + self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.ns = end - self.start
        if self.keep:
            if _S.nvtx:
                torch.cuda.nvtx.range_pop()
            if _S.stack and _S.stack[-1] is self:
                _S.stack.pop()
            _keep(_S.spans, Span(self.id, self.name, self.parent,
                                 self.request, self.start, end))
        return False


def _keep(records: list, item) -> None:
    if len(records) >= MAX_RECORDS:
        del records[:len(records) // 2]
    records.append(item)


def enable(on: bool = True) -> None:
    """The operator's switch: trace from the next driver entry on (or stop,
    unless a ``torch.profiler`` session records)."""
    _S.user = bool(on)


def check() -> bool:
    """Read the switch (a driver's entry): on while :func:`enable` is set
    or a ``torch.profiler`` session records. Returns it."""
    on = _S.user or torch._C._autograd._profiler_enabled()
    if on and not _S.on:
        _S.nvtx = torch.cuda.is_available()
    _S.on = on
    return on


def on() -> bool:
    """The switch as the last driver entry read it."""
    return _S.on


def span(name: str, *, timed: bool = False):
    """A span named ``name`` around a ``with`` block: recorded while
    tracing is on, else the shared null context. ``timed``: the block's
    host ns are measured either way (the span's ``ns``; set-up timers)."""
    if _S.on:
        return _Span(name, True)
    return _Span(name, False) if timed else _NULL


def spans() -> list[Span]:
    """The spans recorded so far, in the order they closed."""
    return list(_S.spans)


def self_ns(records: list[Span]) -> dict[int, int]:
    """Each span's self time by id: its length less its children's."""
    own = {s.id: s.end_ns - s.start_ns for s in records}
    for s in records:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def span_table(records: list[Span] | None = None) -> dict[str, tuple]:
    """(count, total ns, self ns) by span name."""
    records = _S.spans if records is None else records
    own = self_ns(records)
    table = defaultdict(lambda: [0, 0, 0])
    for s in records:
        row = table[s.name]
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += own[s.id]
    return {k: tuple(v) for k, v in table.items()}


def add_stages(totals: dict) -> None:
    """Add a run's stage-clock totals, ``{stage: (executions, ns)}``."""
    for name, (n, ns) in totals.items():
        row = _S.stages[name]
        row[0] += int(n)
        row[1] += int(ns)


def stages() -> dict[str, tuple[int, int]]:
    """The stage clock's totals since the last :func:`reset`:
    ``{stage: (executions, device ns)}`` for :data:`STAGES` and
    :data:`BETWEEN` (its executions the gaps timed; a step's first gap
    after tracing turns on is not)."""
    return {k: tuple(v) for k, v in _S.stages.items()}


def add_gaps(gaps: list[tuple[int, int]], dropped: int = 0) -> None:
    """Gaps between steps, ``(start, end)`` on the host's clock (ns), for
    :func:`gaps_by_span`; ``dropped`` gaps were timed but not kept."""
    for g in gaps:
        _keep(_S.gaps, g)
    _S.dropped_gaps += dropped


def calibrate(samples: list[tuple[int, int, int]]) -> tuple[float, float]:
    """The card's timer against the host's: ``samples`` of (host ns before
    a timer read on the card, the card's ns, host ns once the read is back).
    The tightest bracket sets it: returns (offset, uncertainty) in ns, the
    card's time less the host's at the bracket's middle, and half the
    bracket."""
    t0, dev, t1 = min(samples, key=lambda s: s[2] - s[0])
    return dev - (t0 + t1) / 2, (t1 - t0) / 2


def attribute(gaps, records) -> dict[str, tuple[int, int]]:
    """``{span name: (gaps, ns)}``: each gap ``(start, end)`` (host ns)
    charged to the innermost of ``records`` (``(start, end, name)``, or
    :class:`Span`) that holds its midpoint, else to :data:`OUTSIDE`."""
    ivs = sorted((r.start_ns, r.end_ns, r.name) if isinstance(r, Span)
                 else tuple(r) for r in records)
    starts = [iv[0] for iv in ivs]
    out = defaultdict(lambda: [0, 0])
    open_: list = []      # spans that started before t, by start
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        t = (a + b) / 2
        k = bisect.bisect_right(starts, t)
        open_ += ivs[j:k]
        j = max(j, k)
        open_ = [iv for iv in open_ if iv[1] >= t]
        best = min(open_, key=lambda iv: iv[1] - iv[0], default=None)
        row = out[best[2] if best else OUTSIDE]
        row[0] += 1
        row[1] += b - a
    return {k: tuple(v) for k, v in out.items()}


def gaps_by_span() -> dict[str, tuple[int, int]]:
    """The gaps between steps so far by the program span the host was in
    at each gap's middle (:func:`attribute`); spans still open count as
    open until now."""
    now = time.perf_counter_ns()
    open_ = [(s.start, now, s.name) for s in _S.stack]
    return attribute(_S.gaps, [*_S.spans, *open_])


def reset() -> None:
    """Forget every span, stage total and gap (the switch stays)."""
    _S.spans, _S.gaps, _S.dropped_gaps = [], [], 0
    _S.stages.clear()
