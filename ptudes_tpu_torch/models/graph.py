"""The scan step captured as a CUDA graph and replayed once a scan: the
counterpart of ``ptudes_tpu.models.lio.run_sequence``'s compiled scan
(``jax.jit`` around ``lax.scan(step, state, batches)``) and of the JAX
online driver's jitted step.

The port's drivers run a step op by op from Python, ~1800 launches a bench
scan. Here one step is captured once over static buffers and replayed:

- the carried state lives in static buffers: the input state is copied in
  once, and inside the graph the step's new state is copied back into them
  (the step's ``NamedTuple`` carry rebinds its tensors every scan);
- :class:`SequenceGraph` keeps a scan counter on the card: the step reads
  scan ``i`` of the stacked batches with an ``index_select`` on it, writes
  its packed row (and with ``log`` its filter history) into preallocated
  [N, ...] outputs with ``index_copy_`` and bumps it, so each replay is one
  graph launch and the host copies nothing between scans; the stacked
  batches must stay alive and unmoved while the graph lives;
- :class:`OnlineGraph` reads static input buffers instead, which its
  caller fills before each replay, and writes one row;
- the boot and the steady step are two graphs over the same buffers and
  one memory pool; each is warmed up on the capture stream first (the
  caching allocator, cuBLAS's workspace and any buffer a wrapper allocates
  at first use are then outside the graph's pool), with the buffers put
  back as they were before the capture;
- :func:`run_scans` keeps its runners, as ``jax.jit`` keeps its compiled
  programs: a call with the key of a kept runner (the configuration, the
  tensors the steps close over, the shapes, strides and dtypes of the
  state and the batches, the device) copies its start state and batches
  into that runner's buffers and replays, with no warm-up or capture.
  The last ``CACHE_SIZE`` runners are kept, each with its pool (73 MB at
  ``bench_config``, 280 MB with four replicas, on an H100).

The step's loops and branches whose trip count or path depend on the data
(the JAX package's ``lax.while_loop``, ``lax.cond`` and ``fori_loop`` in
the scan program) are CUDA graph conditional nodes
(``csrc/graph_cond.cu``): the ops call :func:`while_node` and
:func:`if_node` where :func:`conditional_form` says a runner runs them,
with the loop's carry in tensors allocated before the loop and updated in
place. Inside a capture each opens a WHILE or IF node whose body is
captured on a body stream of its own (one a nesting depth, created once),
its allocations routed to a memory pool of the runner's (one a depth);
the predicate kernel sets the node from a flag on the card (the last node
of a WHILE body, the node before an IF node), so a replay reads nothing
from the card. In the warm-up each body runs on its body stream, IF bodies
whatever their flag says (both branches warmed up: any buffer a body
allocates at first use exists before the capture), WHILE bodies until the
host reads their flag false. With ``capture=False`` they are a host
``while`` and ``if`` on the same flags and the same body code.

The point-sharded step (a process group, ``parallel.sharded``) is
captured too where its group is NCCL's: each all-reduce of the GN system
sits in the GN loop's WHILE body, on the card like the rest of the body,
and every rank replays the same number of iterations, since the loop's
flag comes from the all-reduced system and the shared pose. A gloo group
stages each all-reduce through host memory, which no graph can hold:
:func:`host_read_reason` keeps that step eager. With ``capture=False`` a
runner runs the same code on the same buffers, counter, ``index_select``
and ``index_copy_`` with only the capture skipped (the CPU tests, with a
gloo group too); the drivers never use it on a card.

``kernels.LAUNCHES`` counts on the host, so a replay counts nothing
itself: each graph's launches are taken at its capture and added once a
replay. A conditional body runs a number of times a replay that only the
card knows, so its launches are taken apart at its capture and the
predicate kernel counts the body's executions in an int32 on the card
(:func:`count` adds other counts there, such as the re-gathered
replicas); the runner reads those counters once after a run and adds
each body's launches times its executions (``LAUNCHES["gn_iter"]``, the
K5 builds, among them), the re-gathers and the sharded step's
all-reduces to ``ops.icp.REFRESH_COUNTS`` and all of them to
``LAST_RUN["cond"]``. The warm-up's and the capture's own
launches are not counted.

The stage clock (:class:`StageClock`, ``utils.trace``) times the step by
layer on the card. The step's code opens each of ``trace.STAGES`` with
:func:`stage` (a runner's :meth:`StepGraph._body` its start and end), never
inside a conditional body, so a stage's interval holds every repeat of
its WHILE and IF nodes; a stamp is a node of the graph, always captured,
that does nothing while the clock's switch on the card is off. The drivers
turn the switch at their entry (:func:`traced`, a ``fill_`` when it
changes), and with tracing on add the clock's totals to ``utils.trace``
with the read that :meth:`Conditionals.fold_counts` makes. Eagerly the
stamps are launched only inside a traced driver call (on the CPU a host
twin keeps the same accounts on the host's clock).
"""
from __future__ import annotations

import contextlib
import ctypes
import time
from collections import Counter, OrderedDict

import torch
import torch.distributed as dist

from .. import kernels
from ..config import PipelineConfig
from ..utils import trace

# which form the last driver call ran: "graph" or "eager"; a graph run
# also gives its runner's set-up host ms (warm-up and capture, which the
# JAX package's compile would take), the pool's MB (the largest capture's
# peak allocation), this call's replays by step, and whether it reused a
# kept runner ("cached": then it paid no set-up)
LAST_RUN: dict = {"form": None}

CACHE_SIZE = 4   # runners run_scans keeps, the least recently used dropped
RUNNERS: OrderedDict = OrderedDict()   # run_scans' runners by key


def host_read_reason(cfg: PipelineConfig, group=None) -> str | None:
    """Why the step of ``cfg`` cannot be captured, or None when it can:
    every single-card configuration can (its loops and branches are
    conditional nodes), and so can the point-sharded step of an NCCL
    group (its all-reduces are captured in the GN loop's body); a group of
    any other backend (gloo) cannot."""
    if group is None:
        return None
    backend = dist.get_backend(group)
    if backend == "nccl":
        return None
    return (f"a {backend} process group (it stages each all-reduce of the "
            f"point-sharded step through host memory)")


def group_key(group) -> tuple | None:
    """The part of a runner's key a process group makes: its backend, this
    process's rank and the world size (the rank's slice of the source is
    baked into the captured step) and the group itself, which the kept
    runner's steps hold alive; None without a group."""
    if group is None:
        return None
    return (dist.get_backend(group), dist.get_rank(group),
            dist.get_world_size(group), id(group))


def use_graph(graph: bool | None, device: torch.device,
              cfg: PipelineConfig, group=None) -> bool:
    """A driver's ``graph`` argument resolved: None means a graph on a CUDA
    device for a step without a host read (every single-card step, the
    step of an NCCL group); True raises ``ValueError`` where a graph cannot
    run (the CPU, a gloo group); False is the eager loop."""
    reason = host_read_reason(cfg, group)
    if graph is None:
        return device.type == "cuda" and reason is None
    if graph:
        if reason is not None:
            raise ValueError(f"graph=True: this step cannot be captured: it "
                             f"reads the card from the host, {reason}")
        if device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device, not {device}")
    return bool(graph)


def ran_eagerly() -> None:
    """Record that the last driver call ran its step op by op."""
    LAST_RUN.clear()
    LAST_RUN["form"] = "eager"


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of named tuples and tuples, in order (None and
    other values skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return []


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        parts = [tree_map(fn, x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def copy_back(dst_tree, src_tree) -> int:
    """Copy the step's new state ``src_tree`` into the static buffers
    ``dst_tree`` in place; returns the device operations issued. A new
    leaf that is its own buffer is left alone; one that aliases another
    buffer (``pose_prev`` is the old ``pose``) is cloned before any
    buffer is written."""
    dst, src = leaves(dst_tree), leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"the step's state has {len(src)} tensors, the "
                         f"static buffers {len(dst)}")
    owned = {d.untyped_storage().data_ptr() for d in dst}
    todo, ops = [], 0
    for i, (d, s) in enumerate(zip(dst, src)):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(
                f"state tensor {i}: the step returns {s.dtype} "
                f"{tuple(s.shape)} for a buffer of {d.dtype} "
                f"{tuple(d.shape)}")
        if _same_view(s, d):
            continue
        if s.untyped_storage().data_ptr() in owned:
            s = s.clone()
            ops += 1
        todo.append((d, s))
    for d, s in todo:
        d.copy_(s)
    return ops + len(todo)


# ------------------------------------------------------ the stage clock

_START, _END, _NO_COUNT, _READ = 1, 2, 4, 8    # csrc/graph_cond.cu's flags
# the clock's words: its switch, the last stamp, the open stage, the last
# step's end, the gaps written, the calibration read; from _ACC the ns and
# executions by stage (the gap between steps last), then the gaps' ring
_ENABLED, _LAST, _OPEN, _STEP_END, _GAPS, _READ_AT, _ACC = 0, 1, 2, 3, 4, 5, 8
GAP_RING = 1024           # gaps between steps kept on the card between reads
CALIBRATION_READS = 8
_CLOCKS: dict = {}        # by device
_LIVE = None              # the clock of the driver call running, traced


class StageClock:
    """The stage clock of one device: ns and executions by stage of the
    scan step, and the gaps between steps, kept on the card by the stamp
    kernel (``csrc/graph_cond.cu``: ``stage_stamp_kernel``); on the CPU its
    host twin keeps the same buffer on the host's clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.n = len(trace.STAGES)
        self.buf = torch.zeros(_ACC + 2 * (self.n + 1) + 2 * GAP_RING,
                               dtype=torch.int64, device=device)
        self.buf[_OPEN:_OPEN + 1].fill_(-1)
        self.on = False
        self.offset, self.offset_err = 0.0, 0.0
        self._gaps_read = 0

    def stamp(self, stage: int, flags: int) -> None:
        """Open ``stage`` (with ``flags``) on the current stream, a node
        where the stream captures; not counted in ``kernels.LAUNCHES``."""
        if self.device.type == "cuda":
            kernels.launch("stage_stamp", self.buf.data_ptr(), stage, flags,
                           self.n, GAP_RING)
        else:
            self._twin(stage, flags, time.perf_counter_ns())

    def _twin(self, stage: int, flags: int, now: int) -> None:
        """``stage_stamp_kernel`` on the host."""
        c, n = self.buf.tolist(), self.n
        if flags & _READ:
            c[_READ_AT] = now
        elif c[_ENABLED]:
            acc, cnt, ring = _ACC, _ACC + n + 1, _ACC + 2 * (n + 1)
            if c[_OPEN] >= 0:
                c[acc + c[_OPEN]] += now - c[_LAST]
            if flags & _START and c[_STEP_END] > 0:
                c[acc + n] += now - c[_STEP_END]
                c[cnt + n] += 1
                slot = ring + 2 * (c[_GAPS] % GAP_RING)
                c[slot], c[slot + 1] = c[_STEP_END], now
                c[_GAPS] += 1
            if flags & _END:
                c[_STEP_END], c[_OPEN] = now, -1
            else:
                c[_OPEN] = stage
                if not flags & _NO_COUNT:
                    c[cnt + stage] += 1
            c[_LAST] = now
        self.buf.copy_(torch.tensor(c))

    def switch(self, on: bool) -> None:
        """Turn the clock's switch (only where it changes): on, its counts
        start again from zero, the next step's gap is not timed, and the
        card's timer is calibrated against the host's."""
        if on == self.on:
            return
        self.on = on
        if on:
            self._gaps_read = 0
            self.buf[_LAST:_ACC + 2 * (self.n + 1)].zero_()
            self.buf[_OPEN:_OPEN + 1].fill_(-1)
        self.buf[_ENABLED:_ENABLED + 1].fill_(int(on))
        if on and self.device.type == "cuda":
            samples = []
            for _ in range(CALIBRATION_READS):
                t0 = time.perf_counter_ns()
                self.stamp(0, _READ)
                dev = _read(self.buf[_READ_AT:_READ_AT + 1])[0]
                samples.append((t0, dev, time.perf_counter_ns()))
            self.offset, self.offset_err = trace.calibrate(samples)

    def fold(self, vals: list | None = None) -> None:
        """Add the counts since the last fold to ``utils.trace`` (``vals``:
        the buffer as read; else it is read here) and zero them."""
        vals = _read(self.buf) if vals is None else vals
        n = self.n
        names = (*trace.STAGES, trace.BETWEEN)
        acc, cnt = vals[_ACC:_ACC + n + 1], vals[_ACC + n + 1:_ACC + 2 * n + 2]
        trace.add_stages({k: (cnt[i], acc[i]) for i, k in enumerate(names)
                          if cnt[i] or acc[i]})
        ring, written = _ACC + 2 * (n + 1), vals[_GAPS]
        first = max(self._gaps_read, written - GAP_RING)
        trace.add_gaps([
            (vals[ring + 2 * (j % GAP_RING)] - self.offset,
             vals[ring + 2 * (j % GAP_RING) + 1] - self.offset)
            for j in range(first, written)], first - self._gaps_read)
        self._gaps_read = written
        self.buf[_ACC:_ACC + 2 * (n + 1)].zero_()


def _read(t: torch.Tensor) -> list:
    """``t`` as a list; on the card one host read, which the sync check
    (``set_sync_debug_mode``) lets pass."""
    if t.device.type != "cuda":
        return t.tolist()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return t.tolist()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _device_key(device: torch.device) -> tuple:
    if device.type == "cuda":
        return ("cuda", torch.cuda.current_device() if device.index is None
                else device.index)
    return (device.type, 0)


def stage_clock(device: torch.device) -> StageClock:
    """The stage clock of ``device``, made at first use."""
    key = _device_key(torch.device(device))
    if key not in _CLOCKS:
        _CLOCKS[key] = StageClock(torch.device(key[0], key[1])
                                  if key[0] == "cuda" else torch.device("cpu"))
    return _CLOCKS[key]


@contextlib.contextmanager
def traced(device: torch.device, *, fold: bool = False):
    """A driver call: at its entry tracing's switch is read once
    (``utils.trace.check``) and set on ``device``'s stage clock where it
    changed (a clock is made only when tracing is on, or by a capture).
    While tracing is on, the call's eager steps stamp that clock, its
    runner's :meth:`Conditionals.fold_counts` reads it, and with ``fold``
    it is read at the call's end (the eager loops); outside a driver call
    nothing stamps or reads it. Yields the switch."""
    global _LIVE
    on = trace.check()
    key = _device_key(torch.device(device))
    clock = stage_clock(device) if on else _CLOCKS.get(key)
    if clock is not None:
        clock.switch(on)
    outer, _LIVE = _LIVE, (clock if on else None)
    try:
        yield on
        if fold and _LIVE is not None:
            _LIVE.fold()
    finally:
        _LIVE = outer


def stage(name: str, *, count: bool = True) -> None:
    """Open the step's stage ``name`` (one of ``utils.trace.STAGES``),
    closing the one open: a stamp node in a capture (always captured), a
    stamp while tracing is on otherwise, nothing in a runner's warm-up.
    ``count=False`` opens it again without counting an execution (the
    output row's part of ``graph.io``). Never inside a conditional body."""
    _stamp(trace.STAGES.index(name), 0 if count else _NO_COUNT)


def step_start() -> None:
    """A step's first stamp: opens ``graph.io`` and times the gap since the
    last step's end."""
    _stamp(0, _START)


def step_end() -> None:
    """A step's last stamp: closes its open stage."""
    _stamp(0, _END)


def _stamp(idx: int, flags: int) -> None:
    r = _ACTIVE
    if r is not None:
        if r._mode == "warm":
            return
        if r._depth:
            raise RuntimeError("a stage opened inside a conditional body")
        if r._mode == "capture":
            r.clock.stamp(idx, flags)
            r._stamps += 1
            return
    if _LIVE is not None:
        _LIVE.stamp(idx, flags)


# ------------------------------------------------- conditional nodes

IF, WHILE = 0, 1          # csrc/graph_cond.cu's node kinds
MAX_COUNTERS = 64         # int32 counters on the card a runner
_ACTIVE = None            # the runner running a step now, if any
_BODY_STREAMS: dict[int, list] = {}   # by device: a body stream a depth


def conditional_form() -> bool:
    """True while a runner runs a step (its warm-up, its capture, or its
    run with ``capture=False``): the ops then keep their loop carries in
    tensors updated in place and run their data-dependent loops and
    branches through :func:`while_node` and :func:`if_node`."""
    return _ACTIVE is not None


def _active() -> "Conditionals":
    if _ACTIVE is None:
        raise RuntimeError("a conditional node outside a graph runner's step")
    return _ACTIVE


def while_node(name: str, go: torch.Tensor, body) -> None:
    """``body()`` at least once, then again while the flag ``go`` (a bool
    or int32 tensor of one element, which the body updates in place) is
    true: a WHILE node in a capture, a host loop otherwise. Its executions
    are counted under ``name``. The body writes its results into tensors
    that exist before it (nothing it allocates outlives it)."""
    _active()._cond(WHILE, name, go, body)


def if_node(name: str, pred: torch.Tensor, body) -> None:
    """``body()`` where the flag ``pred`` (a bool or int32 tensor of one
    element) is true: an IF node in a capture, a host ``if`` otherwise
    (the warm-up runs it whatever ``pred`` says). Its executions are
    counted under ``name``. The body writes its results in place, into
    tensors that exist before it: a body not taken leaves them as they
    were."""
    _active()._cond(IF, name, pred, body)


def count(name: str, amount) -> None:
    """Add ``amount`` (an int, or an int32 tensor of one element on the
    card) to the running step's counter ``name`` (on the card in a
    capture, so a body adds it each time it runs)."""
    _active()._count(name, amount)


def body_stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream the bodies at nesting ``depth`` are captured on, created
    once a process (``cudaStreamCreateWithFlags``, not PyTorch's stream
    pool, whose streams come round again and could be the capturing
    one)."""
    streams = _BODY_STREAMS.setdefault(device.index or 0, [])
    while len(streams) <= depth:
        raw = ctypes.c_void_p()
        kernels.host_call("stream_create", ctypes.byref(raw))
        streams.append(torch.cuda.ExternalStream(raw.value, device=device))
    return streams[depth]


def _route_to_pool(device_index: int, pool) -> None:
    """The current stream's allocations go to ``pool`` until
    :func:`_unroute`: the caching allocator serves a capture only from the
    pool of a capture it knows, and a body's capture is not one."""
    torch._C._cuda_beginAllocateCurrentStreamToPool(device_index, pool.id)


def _unroute(device_index: int, pool) -> None:
    torch._C._cuda_endAllocateToPool(device_index, pool.id)
    torch._C._cuda_releasePool(device_index, pool.id)


def _counts() -> tuple[dict, dict]:
    return dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES)


def _set_counts(saved: tuple[dict, dict]) -> None:
    kernels.LAUNCHES.update(saved[0])
    kernels.VARIANT_LAUNCHES.update(saved[1])


class Conditionals:
    """The conditional nodes of the steps run on ``device``: while a step
    runs (``_mode`` "warm", "capture" or "static") :func:`while_node`,
    :func:`if_node` and :func:`count` come here; the counters on the card
    and the captured nodes' launches are kept for :meth:`fold_counts`."""

    def __init__(self, device: torch.device, capture: bool):
        self.device = device
        self.capture = capture
        self._mode = None     # "warm", "capture" or "static" in a step
        self._depth = 0       # conditional bodies open around the op now
        self._slots: dict = {}      # counter key -> slot of self.counters
        self._nodes: list = []      # captured nodes: name, slot, launches
        self._body_pools: list = []  # a memory pool a nesting depth
        self.cond_nodes: dict[str, int] = {}   # conditional nodes a graph
        self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.int32,
                                    device=device)
        self._host_counts: Counter = Counter()
        self.cond: dict[str, int] = {}   # the last run's counts by name
        self.clock = stage_clock(device) if capture else None
        self._stamps = 0      # stamps of the step being captured

    def _slot(self, key) -> int:
        if key not in self._slots:
            if len(self._slots) == MAX_COUNTERS:
                raise RuntimeError(f"more than {MAX_COUNTERS} conditional "
                                   "counters in one runner")
            self._slots[key] = len(self._slots)
        return self._slots[key]

    def _count(self, name: str, amount) -> None:
        if self._mode == "capture":
            slot = self._slot(("count", name))
            self.counters[slot:slot + 1].add_(amount)
        elif self._mode == "static":
            self._host_counts[name] += int(amount)

    def _cond(self, kind: int, name: str, pred, body) -> None:
        if pred.numel() != 1 or pred.dtype not in (torch.bool, torch.int32):
            raise ValueError(f"{name}: a flag is one bool or int32, not "
                             f"{pred.dtype} {tuple(pred.shape)}")
        if self._mode == "capture":
            self._capture_cond(kind, name, pred, body)
        elif self._mode == "warm":
            self._warm_cond(kind, pred, body)
        else:
            self._depth += 1
            try:
                self._static_cond(kind, name, pred, body)
            finally:
                self._depth -= 1

    def _static_cond(self, kind: int, name: str, pred, body) -> None:
        if kind == IF:
            if bool(pred):
                self._host_counts[name] += 1
                body()
        else:
            while True:
                body()
                self._host_counts[name] += 1
                if not bool(pred):
                    break

    def _warm_cond(self, kind: int, pred, body) -> None:
        """Set-up: the body on its body stream, an IF body whatever its
        flag says, a WHILE body until the host reads its flag false."""
        cur = torch.cuda.current_stream(self.device)
        bs = body_stream(self.device, self._depth)
        bs.wait_stream(cur)
        self._depth += 1
        try:
            with torch.cuda.stream(bs):
                body()
                while kind == WHILE and bool(pred):
                    body()
        finally:
            self._depth -= 1
            cur.wait_stream(bs)

    def _set_cond(self, pred, slot: int, kind: int, handle: int) -> None:
        kernels.launch(
            "graph_cond", kernels.ptr(pred, "pred", pred.dtype),
            int(pred.dtype == torch.int32),
            self.counters.data_ptr() + 4 * slot, kind, handle)

    def _capture_cond(self, kind: int, name: str, pred, body) -> None:
        """A WHILE or IF node in the graph being captured, its body
        captured on the body stream of this depth with its allocations in
        this depth's pool; the body's launches are taken out of the
        graph's and kept with the node. A failure raises."""
        idx = self.device.index or 0
        cur = torch.cuda.current_stream(self.device)
        bs = body_stream(self.device, self._depth)
        while len(self._body_pools) <= self._depth:
            self._body_pools.append(torch.cuda.MemPool())
        pool = self._body_pools[self._depth]
        slot = self._slot(("node", len(self._slots)))
        handle = ctypes.c_ulonglong()
        kernels.host_call("cond_handle", cur.cuda_stream, kind,
                          ctypes.byref(handle))
        if kind == IF:
            self._set_cond(pred, slot, kind, handle.value)
        saved = _counts()
        kernels.host_call("cond_open", cur.cuda_stream, bs.cuda_stream, kind,
                          handle.value)
        self._depth += 1
        ok = False
        try:
            with torch.cuda.stream(bs):
                _route_to_pool(idx, pool)
                try:
                    body()
                    if kind == WHILE:
                        self._set_cond(pred, slot, kind, handle.value)
                finally:
                    _unroute(idx, pool)
            ok = True
        finally:
            self._depth -= 1
            try:
                kernels.host_call("cond_close", bs.cuda_stream)
            except RuntimeError:
                if ok:
                    raise
        got = _counts()
        self._nodes.append(dict(
            name=name, slot=slot,
            delta=({k: v - saved[0][k] for k, v in got[0].items()},
                   {k: v - saved[1][k] for k, v in got[1].items()})))
        _set_counts(saved)

    def begin_counts(self) -> None:
        """Zero the conditional counters before a run."""
        if self._slots:
            self.counters.zero_()
        self._host_counts = Counter()

    def fold_counts(self) -> None:
        """After a run: read the counters on the card once (a host sync,
        which ``set_sync_debug_mode`` allows here), add each captured
        body's launches times its executions to ``kernels.LAUNCHES``, the
        re-gathers and all-reduces to ``ops.icp.REFRESH_COUNTS``, and keep
        the counts by name in ``self.cond``. While tracing is on the same
        read takes the stage clock's counts to ``utils.trace``."""
        with trace.span("graph.fold_counts"):
            self._fold_counts()

    def _fold_counts(self) -> None:
        from ..ops import icp
        cond = Counter(self._host_counts)
        clock = _LIVE if _LIVE is not None and _LIVE.device == self.device \
            else None
        read = self.capture and bool(self._slots)
        if clock is not None or read:
            parts = ([clock.buf] if clock is not None else []) + (
                [self.counters.to(torch.int64)] if read else [])
            vals = _read(torch.cat(parts) if len(parts) > 1 else parts[0])
            if clock is not None:
                clock.fold(vals[:len(clock.buf)])
                vals = vals[len(clock.buf):]
        if read:
            for key, slot in self._slots.items():
                if key[0] == "count":
                    cond[key[1]] += vals[slot]
            for node in self._nodes:
                n = vals[node["slot"]]
                cond[node["name"]] += n
                for counts, delta in zip(
                        (kernels.LAUNCHES, kernels.VARIANT_LAUNCHES),
                        node["delta"]):
                    for k, v in delta.items():
                        counts[k] += n * v
        for name in ("regathers", "allreduces"):
            icp.REFRESH_COUNTS[name] += cond[name]
        self.cond = dict(cond)


def run_static(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the ops in their conditional forms and
    every loop and branch a host ``while`` and ``if`` (a runner's
    ``capture=False`` form), outside a runner: returns (``fn``'s result,
    the counts by name, as ``LAST_RUN["cond"]``)."""
    global _ACTIVE
    dev = next((x.device for x in leaves(tuple(args))), torch.device("cpu"))
    runner = Conditionals(dev, capture=False)
    runner._mode, _ACTIVE = "static", runner
    try:
        out = fn(*args, **kwargs)
    finally:
        runner._mode, _ACTIVE = None, None
    runner.fold_counts()
    return out, runner.cond


class StepGraph(Conditionals):
    """Static buffers for one carried state and the steps captured over
    them; :meth:`scan_inputs` and :meth:`emit` (in the subclasses) say where
    a scan's inputs come from and where its outputs go. ``state`` is
    copied, never written."""

    def __init__(self, state, *, capture: bool = True):
        dev = leaves(state)[0].device
        if capture and dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        super().__init__(dev, capture)
        self.state = tree_map(torch.clone, state)
        self._steps: dict = {}
        self._graphs: dict = {}
        self._pool = self._stream = None
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays: dict[str, int] = {}
        self.own_ops = None   # device operations of the runner a scan

    def scan_inputs(self):
        """The step's batch, inside the graph: (batch, device ops)."""
        raise NotImplementedError

    def emit(self, outs) -> int:
        """Write the step's outputs inside the graph; returns device ops."""
        raise NotImplementedError

    def mutable(self) -> list[torch.Tensor]:
        """The buffers a step writes and its warm-up must give back."""
        return leaves(self.state)

    def own_outputs(self) -> None:
        """Allocate again on the current stream the output buffers that the
        first warm-up allocated on the capture stream (every graph then
        writes the same ones)."""

    def _body(self, step, mode: str) -> None:
        global _ACTIVE
        self._mode, _ACTIVE = mode, self
        self._stamps = 0
        try:
            step_start()
            batch, ops = self.scan_inputs()
            new_state, *outs = step(self.state, batch)
            ops += copy_back(self.state, new_state)
            ops += self.emit(outs)
            step_end()
        finally:
            self._mode, _ACTIVE = None, None
        self.own_ops = ops + self._stamps

    def add(self, name: str, step) -> None:
        """Make ``step`` the graph ``name``: warmed up on the capture stream
        with every buffer given back, then captured (with ``capture=False``
        only kept). Host syncs are allowed here: this is set-up. The pool's
        size is the card's peak allocation over the capture (its peak
        counter is reset first). A failed capture raises. ``capture_ms``
        adds the host time of the ``graph.capture`` span."""
        if not self.capture:
            self._steps[name] = step
            return
        with trace.span("graph.capture", timed=True) as sp:
            self._add(name, step)
        self.capture_ms += sp.ns * 1e-6

    def _add(self, name: str, step) -> None:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        saved = _counts()
        try:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            kernels.host_call("graph_cond_load")
            snap = [x.clone() for x in self.mutable()]
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self._body(step, "warm")
            torch.cuda.current_stream().wait_stream(self._stream)
            for x, s in zip(self.mutable(), snap):
                x.copy_(s)
            del snap
            if not self._graphs:
                self.own_outputs()
            torch.cuda.synchronize(self.device)
            _set_counts(saved)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            g = torch.cuda.CUDAGraph()
            nodes = len(self._nodes)
            with torch.cuda.graph(g, pool=self._pool, stream=self._stream):
                self._body(step, "capture")
            self.cond_nodes[name] = len(self._nodes) - nodes
            got = _counts()
            delta = ({k: v - saved[0][k] for k, v in got[0].items()},
                     {k: v - saved[1][k] for k, v in got[1].items()})
            self.pool_bytes = max(
                self.pool_bytes,
                torch.cuda.max_memory_allocated(self.device) - base)
            self._graphs[name] = (g, delta)
            self._steps[name] = step
        finally:
            _set_counts(saved)
            torch.cuda.set_sync_debug_mode(mode)

    def has(self, name: str) -> bool:
        return name in self._steps

    def step(self, name: str) -> None:
        """One scan: replay graph ``name`` on the current stream and count
        its launches (with ``capture=False``, run its body)."""
        if self.capture:
            g, (delta, var) = self._graphs[name]
            g.replay()
            for k, v in delta.items():
                kernels.LAUNCHES[k] += v
            for k, v in var.items():
                kernels.VARIANT_LAUNCHES[k] += v
        else:
            self._body(self._steps[name], "static")
        self.replays[name] = self.replays.get(name, 0) + 1

    def record(self) -> dict:
        """This runner's entry of ``LAST_RUN``."""
        return dict(form="graph" if self.capture else "static",
                    capture_ms=self.capture_ms if self.capture else None,
                    pool_mb=self.pool_bytes / 2 ** 20 if self.capture
                    else None, replays=dict(self.replays),
                    own_ops_per_scan=self.own_ops,
                    cond_nodes=dict(self.cond_nodes), cond=dict(self.cond))


class SequenceGraph(StepGraph):
    """A whole sequence: scan ``i`` of ``batches`` (stacked on ``axis``: 0
    for one sequence, 1 for the batched driver's [B, N, ...]) read at the
    counter on the card, the outputs written at it. ``batches`` is read in
    place: it must stay alive and unmoved while the graph lives (copy it
    in first where it may not)."""

    def __init__(self, state, batches, *, axis: int = 0,
                 capture: bool = True):
        super().__init__(state, capture=capture)
        self.batches = batches
        self.axis = axis
        self.n = leaves(batches)[0].shape[axis]
        self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.outs = None

    def scan_inputs(self):
        a = self.axis
        batch = tree_map(
            lambda x: x.index_select(a, self.counter).squeeze(a),
            self.batches)
        return batch, len(leaves(batch))

    def emit(self, outs) -> int:
        a = self.axis
        if self.outs is None:
            self.outs = tree_map(
                lambda x: x.new_empty(x.shape[:a] + (self.n,) + x.shape[a:]),
                tuple(outs))
        for dst, src in zip(leaves(self.outs), leaves(tuple(outs))):
            dst.index_copy_(a, self.counter, src.unsqueeze(a))
        self.counter.add_(1)
        return len(leaves(self.outs)) + 1

    def mutable(self) -> list[torch.Tensor]:
        return [*leaves(self.state), self.counter]

    def own_outputs(self) -> None:
        self.outs = tree_map(torch.empty_like, self.outs)

    def run(self, schedule) -> tuple:
        """Replay the named steps of ``schedule`` in turn, one a scan;
        returns the outputs stacked on the scan axis. ``replays`` counts
        this call's."""
        self.replays = {}
        self.begin_counts()
        with trace.span("graph.replay"):
            for name in schedule:
                self.step(name)
        self.fold_counts()
        return self.outs

    def load(self, state, batches) -> None:
        """A new call's start state and batches copied into the buffers,
        the counter set to 0."""
        for dst, src in ((self.state, state), (self.batches, batches)):
            for d, s in zip(leaves(dst), leaves(src)):
                d.copy_(s)
        self.counter.zero_()


def signature(tree) -> tuple:
    """The shapes, strides and dtypes of ``tree``'s tensors."""
    return tuple((tuple(x.shape), x.stride(), x.dtype)
                 for x in leaves(tree))


def tensor_key(tree) -> tuple:
    """``tree``'s tensors by address and :func:`signature`: the key part of
    tensors a step closes over, which its kept runner keeps alive."""
    return (tuple(x.data_ptr() for x in leaves(tree)),) + signature(tree)


def run_scans(key, build, state, batches, *, axis: int = 0,
              capture: bool = True):
    """A sequence through a :class:`SequenceGraph`: ``build()`` gives
    (boot, steady, k), the boot step for the first ``k`` scans of
    ``batches`` and the steady step for the rest (either None where no
    scan takes it). ``key`` names everything the steps close over (the
    configuration, ``log``, :func:`tensor_key` of the tensors); with the
    device, ``axis``, ``capture`` and the signatures of ``state`` and
    ``batches`` it finds a kept runner, which is loaded and replayed, else
    ``build()``'s steps are captured over copies of ``state`` and
    ``batches`` and the runner kept (``RUNNERS``, the last ``CACHE_SIZE``).
    Records the run in ``LAST_RUN``; returns copies of the final state and
    of the outputs stacked on the scan axis. A driver call
    (:func:`traced`); its spans: ``graph.run_scans`` around
    ``graph.load`` (or ``graph.capture``), ``graph.replay``,
    ``graph.fold_counts`` and ``graph.outputs``."""
    device = leaves(state)[0].device
    with traced(device), trace.span("graph.run_scans"):
        full = (key, capture, axis, str(device), signature(state),
                signature(batches))
        g = RUNNERS.pop(full, None)
        cached = g is not None
        if cached:
            with trace.span("graph.load"):
                g.load(state, batches)
        else:
            boot, steady, k = build()
            g = SequenceGraph(state, tree_map(torch.clone, batches),
                              axis=axis, capture=capture)
            if k:
                g.add("boot", boot)
            if g.n > k:
                g.add("steady", steady)
            g.schedule = ["boot"] * k + ["steady"] * (g.n - k)
        RUNNERS[full] = g
        while len(RUNNERS) > CACHE_SIZE:
            RUNNERS.popitem(last=False)
        outs = g.run(g.schedule)
        LAST_RUN.clear()
        LAST_RUN.update(g.record(), cached=cached)
        with trace.span("graph.outputs"):
            return (tree_map(torch.clone, g.state),
                    tree_map(torch.clone, outs))


class OnlineGraph(StepGraph):
    """One scan a call: the step reads the static ``inputs`` (shaped like
    ``template``, one scan's batch), which the caller fills before each
    :meth:`step`, and writes its row into ``row``."""

    def __init__(self, state, template, *, capture: bool = True):
        super().__init__(state, capture=capture)
        self.inputs = tree_map(torch.zeros_like, template)
        self.row = None

    def scan_inputs(self):
        return self.inputs, 0

    def step(self, name: str) -> None:
        """One scan, its conditional counts read after it (a host sync
        where the graph has conditional nodes; the caller reads the scan's
        row anyway)."""
        self.begin_counts()
        super().step(name)
        self.fold_counts()

    def own_outputs(self) -> None:
        self.row = torch.empty_like(self.row)

    def emit(self, outs) -> int:
        (row,) = outs
        if self.row is None:
            self.row = torch.empty_like(row)
        self.row.copy_(row)
        return 1
