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

A step can be captured only if it never reads the card from the host:
:func:`host_read_reason` names the configurations that do, which run
eagerly. With ``capture=False`` a runner runs the same code on the same
buffers, counter, ``index_select`` and ``index_copy_`` with only the
capture skipped (the CPU tests); the drivers never use it on a card.

``kernels.LAUNCHES`` counts on the host, so a replay counts nothing
itself: each graph's launches are taken at its capture and added once a
replay. The warm-up's and the capture's own launches are not counted.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import torch

from .. import kernels
from ..config import PipelineConfig

# which form the last driver call ran: "graph" or "eager"; a graph run
# also gives its runner's set-up host ms (warm-up and capture, which the
# JAX package's compile would take), the pool's MB (the largest capture's
# peak allocation), this call's replays by step, and whether it reused a
# kept runner ("cached": then it paid no set-up)
LAST_RUN: dict = {"form": None}

CACHE_SIZE = 4   # runners run_scans keeps, the least recently used dropped
RUNNERS: OrderedDict = OrderedDict()   # run_scans' runners by key


def host_read_reason(cfg: PipelineConfig, group=None) -> str | None:
    """Why the step of ``cfg`` reads the card from the host, or None when it
    never does and can be captured."""
    if group is not None:
        return "a process group (the point-sharded step's all-reduces)"
    if cfg.kiss.nn_mode == "every":
        return ("nn_mode='every' (a convergence flag read every GN "
                "iteration)")
    if cfg.kiss.nn_refresh_drift > 0:
        return ("nn_refresh_drift > 0 (the candidate-refresh loop reads its "
                "flags every GN iteration)")
    return None


def use_graph(graph: bool | None, device: torch.device,
              cfg: PipelineConfig, group=None) -> bool:
    """A driver's ``graph`` argument resolved: None means a graph on a CUDA
    device for a configuration without a host read; True raises
    ``ValueError`` where a graph cannot run; False is the eager loop."""
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


def _counts() -> tuple[dict, dict]:
    return dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES)


def _set_counts(saved: tuple[dict, dict]) -> None:
    kernels.LAUNCHES.update(saved[0])
    kernels.VARIANT_LAUNCHES.update(saved[1])


class StepGraph:
    """Static buffers for one carried state and the steps captured over
    them; :meth:`scan_inputs` and :meth:`emit` (in the subclasses) say where
    a scan's inputs come from and where its outputs go. ``state`` is
    copied, never written."""

    def __init__(self, state, *, capture: bool = True):
        dev = leaves(state)[0].device
        if capture and dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        self.device = dev
        self.capture = capture
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

    def _body(self, step) -> None:
        batch, ops = self.scan_inputs()
        new_state, *outs = step(self.state, batch)
        ops += copy_back(self.state, new_state)
        ops += self.emit(outs)
        self.own_ops = ops

    def add(self, name: str, step) -> None:
        """Make ``step`` the graph ``name``: warmed up on the capture stream
        with every buffer given back, then captured (with ``capture=False``
        only kept). Host syncs are allowed here: this is set-up. The pool's
        size is the card's peak allocation over the capture (its peak
        counter is reset first). A failed capture raises."""
        if not self.capture:
            self._steps[name] = step
            return
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        saved = _counts()
        try:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            snap = [x.clone() for x in self.mutable()]
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self._body(step)
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
            with torch.cuda.graph(g, pool=self._pool, stream=self._stream):
                self._body(step)
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
        self.capture_ms += (time.perf_counter() - t0) * 1e3

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
            self._body(self._steps[name])
        self.replays[name] = self.replays.get(name, 0) + 1

    def record(self) -> dict:
        """This runner's entry of ``LAST_RUN``."""
        return dict(form="graph" if self.capture else "static",
                    capture_ms=self.capture_ms if self.capture else None,
                    pool_mb=self.pool_bytes / 2 ** 20 if self.capture
                    else None, replays=dict(self.replays),
                    own_ops_per_scan=self.own_ops)


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
        for name in schedule:
            self.step(name)
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
    of the outputs stacked on the scan axis."""
    full = (key, capture, axis, str(leaves(state)[0].device),
            signature(state), signature(batches))
    g = RUNNERS.pop(full, None)
    cached = g is not None
    if cached:
        g.load(state, batches)
    else:
        boot, steady, k = build()
        g = SequenceGraph(state, tree_map(torch.clone, batches), axis=axis,
                          capture=capture)
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
    return tree_map(torch.clone, g.state), tree_map(torch.clone, outs)


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

    def own_outputs(self) -> None:
        self.row = torch.empty_like(self.row)

    def emit(self, outs) -> int:
        (row,) = outs
        if self.row is None:
            self.row = torch.empty_like(row)
        self.row.copy_(row)
        return 1
