"""Streaming (scan-by-scan) LIO (``ptudes_tpu.models.online``).

The batch pipeline (``lio.run_sequence``) takes the whole recording at
once; live deployments receive packets as they arrive. :class:`LioOnline`
runs the same scan step as the batch path, one scan a call, with the state
kept on the device between calls and the IMU windowed on the host as
``lio.build_batches`` windows it:

    odo = LioOnline(cfg, lut)               # lut on the card
    for msg in sensor_stream:
        if msg.is_imu:
            odo.push_imu(msg.lacc, msg.avel, msg.ts)
        else:
            out = odo.push_scan(msg.range_m, msg.ts)
            publish(out.ekf_pose)

Timestamps may be epoch-scale: the first pushed sample fixes the float64
origin (or pass ``time_origin``, e.g. from a state checkpoint, to continue
an earlier run's clock). The rebase is a float64 subtraction on the
host, and only the rebased time becomes a float32 tensor: float32 spacing
at 1.7e9 s is 128 s. The state can be checkpointed at any scan boundary
with ``utils.checkpoint``.

On a card every configuration runs as the JAX online driver's jitted step
does: each step (boot and steady) is captured as a CUDA graph at the first
scan that takes it (``models.graph.OnlineGraph``; the refresh loop and the
overflow chunks as conditional nodes) and replayed once a scan over static
input buffers, which each scan fills from pinned host memory without a
host sync; a graph with conditional nodes reads its counters on the card
after each scan (one small read, beside the caller's read of the pose).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.projection import XyzLut
from ..utils import trace
from . import graph as graph_mod
from . import lio
from .esekf import Imu


class LioOnline:
    """Stateful per-scan runner around ``lio.make_scan_step``, on the
    device of ``lut``."""

    def __init__(self, cfg: PipelineConfig, lut: XyzLut,
                 state: lio.LioState | None = None,
                 time_origin: float | None = None,
                 prev_scan_ts: float | None = None,
                 graph: bool | None = None):
        """``prev_scan_ts`` (absolute clock, like ``time_origin``): when
        resuming from a checkpoint, the checkpoint's last scan timestamp —
        IMU samples at or before it are ignored instead of re-integrated
        (the seam rule of ``lio.build_batches(prev_scan_ts=...)``).

        ``graph``: as in ``lio.run_sequence``: None captures the steps on a
        CUDA device, True raises ``ValueError`` where they cannot be
        captured (the CPU), False runs them op by op."""
        self.cfg = cfg
        self.lut = lut
        self.device = lut.direction.device
        self._state = (lio.init_state(cfg, self.device) if state is None
                       else state)
        self._origin = time_origin
        self._imu_buf: list[tuple] = []
        self._prev_scan_ts = -np.inf
        if prev_scan_ts is not None:
            if time_origin is None:
                raise ValueError("prev_scan_ts requires time_origin")
            self._prev_scan_ts = float(prev_scan_ts) - float(time_origin)
        self._n_dropped_imu = 0
        # the JAX LioOnline's step choice (ptudes_tpu/models/online.py): the
        # first cfg.bootstrap_scans scans insert the whole frame, the steady
        # step takes cfg.steady_insert_mode — with map_frozen too, where
        # run_sequence builds its one step with insert_overflow=False (a
        # frozen map inserts nothing, so the two steps compute the same)
        self._n_scans = 0
        self._boot_scans = cfg.bootstrap_scans
        self._step_steady = lio.make_scan_step(
            lut, cfg, insert_overflow=cfg.steady_insert_mode)
        self._step_boot = self._step_steady if cfg.map_frozen else \
            lio.make_scan_step(lut, cfg, insert_overflow=True)
        self._graph = None
        if graph_mod.use_graph(graph, self.device, cfg):
            self._graph = self._make_runner(capture=True)
            graph_mod.LAST_RUN.clear()
            graph_mod.LAST_RUN.update(self._graph.record())
        else:
            graph_mod.ran_eagerly()

    def _make_runner(self, capture: bool) -> graph_mod.OnlineGraph:
        """The graph form's runner over the current state: static inputs
        of one scan on the device and their staging buffers on the host
        (pinned when it captures). ``capture=False`` runs the same buffers
        without capturing (the CPU tests)."""
        h, w = self.lut.direction.shape[:2]
        k = self.cfg.max_imu_per_scan

        def empty(*shape, dtype=torch.float32, **kw):
            return torch.empty(shape, dtype=dtype, **kw)

        def scan(**kw):
            return lio.ScanBatch(
                range_m=empty(h, w, **kw), scan_ts=empty(**kw),
                imu=Imu(lacc=empty(k, 3, **kw), avel=empty(k, 3, **kw),
                        ts=empty(k, **kw)),
                imu_valid=empty(k, dtype=torch.bool, **kw), guess_pose=None)

        runner = graph_mod.OnlineGraph(self._state, scan(device=self.device),
                                       capture=capture)
        runner.inputs = runner.inputs._replace(guess_pose=torch.eye(
            4, dtype=torch.float32, device=self.device))
        self._staging = scan(pin_memory=capture)
        self._copied = None
        self._state = None
        return runner

    @property
    def state(self) -> lio.LioState:
        """The state after the last pushed scan (a copy in the graph
        form)."""
        if self._graph is None:
            return self._state
        return graph_mod.tree_map(torch.clone, self._graph.state)

    @property
    def form(self) -> str:
        """How the steps run: "graph", "eager", or "static" (the graph
        form's buffers without the capture)."""
        if self._graph is None:
            return "eager"
        return "graph" if self._graph.capture else "static"

    @property
    def capture_ms(self) -> float | None:
        """Host ms of the graph form's warm-ups and captures so far."""
        return None if self._graph is None else self._graph.capture_ms

    @property
    def n_dropped_imu(self) -> int:
        """IMU samples discarded because a scan interval held more than
        ``cfg.max_imu_per_scan`` (the ``build_batches`` accounting)."""
        return self._n_dropped_imu

    @property
    def time_origin(self) -> float | None:
        """The float64 clock origin (for checkpoint metadata)."""
        return self._origin

    def _rebase(self, ts: float) -> float:
        if self._origin is None:
            self._origin = float(ts)
        return float(ts) - self._origin

    def push_imu(self, lacc, avel, ts: float) -> None:
        """Buffer one IMU sample (SI units, seconds; epoch-scale ok)."""
        self._imu_buf.append(
            (np.asarray(lacc, np.float32), np.asarray(avel, np.float32),
             self._rebase(ts)))

    def push_scan(self, range_m: np.ndarray, ts: float) -> lio.LioOut:
        """Register one range image [H, W] (meters, 0 = no return).

        Consumes the buffered IMU samples in (prev_scan_ts, ts] — the
        reference's interleaving and ``lio.build_batches``' windowing — and
        advances the state on the device. Returns the scan's ``LioOut``,
        its tensors on the device (read them only when needed). Reads
        tracing's switch; its span is ``online.push_scan``, around
        ``online.imu_window`` and, in the graph form, ``online.wait_copy``,
        ``online.stage``, ``online.replay`` and ``online.read_row``."""
        with graph_mod.traced(self.device, fold=self._graph is None), \
                trace.span("online.push_scan"):
            with trace.span("online.imu_window"):
                host, boot = self._window(range_m, ts)
            if self._graph is not None:
                return self._replay("boot" if boot else "steady", host)
            return self._eager(host, boot)

    def _window(self, range_m, ts) -> tuple[tuple, bool]:
        """The scan's host arrays (range image, time, IMU window) and
        whether it takes the boot step."""
        t1 = self._rebase(ts)
        k = self.cfg.max_imu_per_scan
        sel = [s for s in self._imu_buf if self._prev_scan_ts < s[2] <= t1]
        self._imu_buf = [s for s in self._imu_buf if s[2] > t1]
        if len(sel) > k:
            self._n_dropped_imu += len(sel) - k
            sel = sel[-k:]
        m = len(sel)
        lacc = np.zeros((k, 3), np.float32)
        avel = np.zeros((k, 3), np.float32)
        its = np.zeros((k,), np.float32)
        valid = np.zeros((k,), bool)
        if m:
            lacc[:m] = [s[0] for s in sel]
            avel[:m] = [s[1] for s in sel]
            its[:m] = [s[2] for s in sel]
            valid[:m] = True
        self._prev_scan_ts = t1
        boot = not self.cfg.map_frozen and (
            self._boot_scans < 0 or self._n_scans < self._boot_scans)
        self._n_scans += 1
        return (np.asarray(range_m, np.float32), np.float32(t1), lacc, avel,
                its, valid), boot

    def _eager(self, host: tuple, boot: bool) -> lio.LioOut:
        """The eager form of one scan."""
        range_m, t1, lacc, avel, its, valid = host

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        batch = lio.ScanBatch(
            range_m=t(range_m), scan_ts=t(t1),
            imu=Imu(lacc=t(lacc), avel=t(avel), ts=t(its)),
            imu_valid=t(valid, torch.bool),
            guess_pose=torch.eye(4, dtype=torch.float32, device=self.device))
        graph_mod.step_start()
        self._state, row = (self._step_boot if boot
                            else self._step_steady)(self._state, batch)
        graph_mod.step_end()
        return lio.unpack_out(row)

    def _replay(self, name: str, host: tuple) -> lio.LioOut:
        """The graph form of one scan: the host arrays into the staging
        buffers (once the previous scan's copies out of them are done),
        copied to the static inputs without a host sync, then the step
        ``name`` replayed (captured first at its first scan)."""
        g = self._graph
        with trace.span("online.wait_copy"):
            if self._copied is not None:
                self._copied.synchronize()
        with trace.span("online.stage"):
            staging = graph_mod.leaves(self._staging)
            for dst, src in zip(staging, host):
                dst.numpy()[...] = src
            for dst, src in zip(graph_mod.leaves(
                    g.inputs._replace(guess_pose=None)), staging):
                dst.copy_(src, non_blocking=True)
            if g.capture:
                self._copied = torch.cuda.Event()
                self._copied.record()
        if not g.has(name):
            g.add(name, self._step_boot if name == "boot"
                  else self._step_steady)
            graph_mod.LAST_RUN.update(g.record())
        with trace.span("online.replay"):
            g.step(name)
        with trace.span("online.read_row"):
            return lio.unpack_out(g.row.clone())
