"""Stream statistics: online mean/std for scan range and IMU channels.

A copy of ``ptudes_tpu.utils.stats`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

Equivalent of the reference ``StreamStatsTracker``
(``src/ptudes/ins/data.py:207-369``) with identical math (Welford updates
for IMU, two-group variance merge for scan ranges, beam subsampling,
profile-aware range scaling), plus a vectorized whole-sequence variant that
computes the same numbers in one pass over dense arrays.
"""
from __future__ import annotations

import numpy as np


class StreamStatsTracker:
    """Incremental tracker (host-side numpy, reference-parity API)."""

    def __init__(self, use_beams_num: int | None = None,
                 range_unit_m: float = 0.001):
        self._range_unit = range_unit_m
        self._use_beams = use_beams_num
        self._beams_sel = None
        self._mean = 0.0
        self._sigma_sq = 0.0
        self._scans_num = 0
        self._points_num = 0
        self._mean_acc = np.zeros(3)
        self._mean_gyr = np.zeros(3)
        self._sigman_acc = np.zeros(3)
        self._sigman_gyr = np.zeros(3)
        self._imu_num = 0
        self._min_ts = 0.0
        self._max_ts = 0.0
        self._min_range = 0.0
        self._max_range = 0.0

    def _track_ts(self, ts: float) -> None:
        if not self._imu_num and not self._scans_num:
            self._min_ts = self._max_ts = ts
        else:
            self._min_ts = min(self._min_ts, ts)
            self._max_ts = max(self._max_ts, ts)

    def track_imu(self, lacc: np.ndarray, avel: np.ndarray, ts: float) -> None:
        """Welford update (reference ``trackImu``, ins/data.py:267-282)."""
        mean_acc_prev = self._mean_acc.copy()
        mean_gyr_prev = self._mean_gyr.copy()
        self._mean_acc += (lacc - self._mean_acc) / (self._imu_num + 1)
        self._sigman_acc += (lacc - mean_acc_prev) * (lacc - self._mean_acc)
        self._mean_gyr += (avel - self._mean_gyr) / (self._imu_num + 1)
        self._sigman_gyr += (avel - mean_gyr_prev) * (avel - self._mean_gyr)
        self._track_ts(ts)
        self._imu_num += 1

    def track_scan(self, range_raw: np.ndarray, ts: float) -> None:
        """Two-group mean/variance merge (reference ``trackScan``,
        ins/data.py:284-322; merge formula :308-314)."""
        h = range_raw.shape[0]
        if self._use_beams:
            if self._beams_sel is None:
                self._beams_sel = np.linspace(
                    0, h, num=self._use_beams, endpoint=False, dtype=int)
            range_raw = range_raw[self._beams_sel, :]
        rng = range_raw[range_raw > 0].astype(np.float64) * self._range_unit
        if rng.size == 0:
            self._scans_num += 1
            return
        if not self._points_num:
            self._min_range = float(rng.min())
            self._max_range = float(rng.max())
        else:
            self._min_range = min(self._min_range, float(rng.min()))
            self._max_range = max(self._max_range, float(rng.max()))

        m, n, v = float(rng.mean()), rng.size, float(rng.var())
        pn = self._points_num
        s1 = 0.0 if not pn else (pn - 1) * self._sigma_sq
        corr = pn * n * (self._mean - m) ** 2 / ((pn + n) * (pn + n - 1))
        self._sigma_sq = (s1 + n * v) / (pn + n - 1) + corr
        self._mean = (self._mean * pn + m * n) / (pn + n)
        self._track_ts(ts)
        self._scans_num += 1
        self._points_num += n

    @property
    def range_mean(self) -> float:
        return self._mean

    @property
    def range_std(self) -> float:
        return float(np.sqrt(self._sigma_sq))

    @property
    def acc_mean(self) -> np.ndarray:
        return self._mean_acc

    @property
    def acc_std(self) -> np.ndarray:
        return np.sqrt(self._sigman_acc / max(self._imu_num, 1))

    @property
    def gyr_mean(self) -> np.ndarray:
        return self._mean_gyr

    @property
    def gyr_std(self) -> np.ndarray:
        return np.sqrt(self._sigman_gyr / max(self._imu_num, 1))

    @property
    def dt(self) -> float:
        return self._max_ts - self._min_ts

    @property
    def gravity_estimate(self) -> np.ndarray:
        """Gravity direction from mean acceleration (printed by the
        reference CLI, ``src/ptudes/cli/stat.py:112-115``)."""
        n = np.linalg.norm(self._mean_acc)
        return self._mean_acc / n if n > 0 else self._mean_acc

    def __repr__(self) -> str:
        s3_lo = max(self._min_range, self.range_mean - 3 * self.range_std)
        s3_hi = min(self._max_range, self.range_mean + 3 * self.range_std)
        return (
            f"StreamStatsTracker[dt: {self.dt:.04f} s, imus: {self._imu_num},"
            f" scans: {self._scans_num}]:\n"
            f"  range_mean: {self.range_mean:.03f} m,\n"
            f"  range_std: {self.range_std:.03f} m "
            f"(s3 span: [{s3_lo:.03f} - {s3_hi:.03f} m])\n"
            f"  range min max: {self._min_range:.03f} - {self._max_range:.03f} m\n"
            f"  acc_mean: {self.acc_mean} m/s^2\n"
            f"  acc_std: {self.acc_std}\n"
            f"  gyr_mean: {self.gyr_mean} rad/s\n"
            f"  gyr_std: {self.gyr_std}")


def sequence_stats(
    range_mm: np.ndarray,        # [N, H, W] raw
    scan_ts: np.ndarray,         # [N]
    imu_lacc: np.ndarray,        # [M, 3]
    imu_avel: np.ndarray,        # [M, 3]
    imu_ts: np.ndarray,          # [M]
    use_beams_num: int | None = 32,
    range_unit_m: float = 0.001,
) -> StreamStatsTracker:
    """One-shot stats over dense arrays — same numbers, truly vectorized.

    The IMU mean/std are closed-form over the whole array (what the
    Welford recurrence converges to); the scan ranges reduce in one masked
    pass. Only the per-scan two-group merge loop remains (N_scans
    iterations over already-reduced scalars, not per-point work).
    """
    t = StreamStatsTracker(use_beams_num=use_beams_num,
                           range_unit_m=range_unit_m)
    m = len(imu_ts)
    if m:
        lacc = np.asarray(imu_lacc, np.float64).reshape(m, 3)
        avel = np.asarray(imu_avel, np.float64).reshape(m, 3)
        t._mean_acc = lacc.mean(axis=0)
        t._mean_gyr = avel.mean(axis=0)
        # Welford's sigman accumulator == sum of squared deviations
        t._sigman_acc = ((lacc - t._mean_acc) ** 2).sum(axis=0)
        t._sigman_gyr = ((avel - t._mean_gyr) ** 2).sum(axis=0)
        t._imu_num = m
        t._min_ts = float(np.min(imu_ts))
        t._max_ts = float(np.max(imu_ts))
    for i in range(len(scan_ts)):
        t.track_scan(range_mm[i], float(scan_ts[i]))
    return t
