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
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.projection import XyzLut
from . import lio
from .esekf import Imu


class LioOnline:
    """Stateful per-scan runner around ``lio.make_scan_step``, on the
    device of ``lut``."""

    def __init__(self, cfg: PipelineConfig, lut: XyzLut,
                 state: lio.LioState | None = None,
                 time_origin: float | None = None,
                 prev_scan_ts: float | None = None):
        """``prev_scan_ts`` (absolute clock, like ``time_origin``): when
        resuming from a checkpoint, the checkpoint's last scan timestamp —
        IMU samples at or before it are ignored instead of re-integrated
        (the seam rule of ``lio.build_batches(prev_scan_ts=...)``)."""
        self.cfg = cfg
        self.lut = lut
        self.device = lut.direction.device
        self.state = (lio.init_state(cfg, self.device) if state is None
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
        its tensors on the device (read them only when needed)."""
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

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        batch = lio.ScanBatch(
            range_m=t(np.asarray(range_m, np.float32)),
            scan_ts=t(np.float32(t1)),
            imu=Imu(lacc=t(lacc), avel=t(avel), ts=t(its)),
            imu_valid=t(valid, torch.bool),
            guess_pose=torch.eye(4, dtype=torch.float32, device=self.device))
        boot = self._boot_scans < 0 or self._n_scans < self._boot_scans
        self.state, row = (self._step_boot if boot
                           else self._step_steady)(self.state, batch)
        self._n_scans += 1
        return lio.unpack_out(row)
