"""Typed configuration for the PyTorch port.

Frozen copies of ``ptudes_tpu.config`` with the same fields and defaults,
minus the JAX-only knobs (``scan_unroll``, ``gn_unroll``, ``gn_backend``).
The kernel forms are named for the port: ``EkfConfig.predict_batch`` and
``update_form`` take ``"cuda"`` where the JAX package takes ``"pallas"``, and
``KissConfig.icp_form`` selects the CUDA ICP kernels and the grid front
end's hashing kernels (``"cuda"``) or their plain PyTorch twins
(``"torch"``). There is no
``"auto"``: the configuration says which form runs.

Every option of the JAX ``PipelineConfig`` that runs on one device runs
here; :func:`check_supported` raises ``ValueError`` for values neither
package knows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KissConfig:
    """KISS-ICP odometry parameters (``ptudes_tpu.config.KissConfig``)."""
    max_range: float = 100.0
    min_range: float = 5.0
    deskew: bool = True
    voxel_size: float | None = None  # None -> max_range / 100
    max_points_per_voxel: int = 20
    initial_threshold: float = 2.0
    min_motion_th: float = 0.1
    max_iterations: int = 50
    convergence_criterion: float = 1e-4
    loss: str = "plane"
    plane_min_quality: float = 0.2
    plane_fit_radius: float | None = None  # None -> 1.5 * voxel_size
    approx_nn: bool = True
    nn_mode: str = "cached"
    nn_voxels: int = 4
    nn_refresh_drift: float = 0.5
    prior_rot_weight: float = 0.01
    prior_trans_weight: float = 0.01
    nn_neighborhood: int = 27
    fused_gather: bool = False
    # "cuda": the ICP kernels — with nn_refresh_drift == 0 the candidate
    # prep (K3, or with fused_gather the whole gather and prep, K6) and the
    # whole GN loop (K4), otherwise the per-iteration GN build (K5) — and
    # the grid front end's voxel hashing (the window pre-dedup K8, the
    # first-in-voxel sort keys K9); "torch": their plain PyTorch twins on
    # any device
    icp_form: str = "torch"

    @property
    def resolved_voxel_size(self) -> float:
        return self.max_range / 100.0 if self.voxel_size is None else self.voxel_size


@dataclass(frozen=True)
class Capacity:
    """Static shapes of the device pipeline (``ptudes_tpu.config.Capacity``)."""
    max_points: int = 131072
    max_frame: int = 32768
    max_source: int = 8192
    map_capacity: int = 1 << 19
    max_probes: int = 2
    dedup_table: int = 1 << 20
    max_new_per_scan: int = 8192


@dataclass(frozen=True)
class EkfConfig:
    """ES-EKF tuning (``ptudes_tpu.config.EkfConfig``)."""
    init_pos_std: float = 10.0
    init_vel_std: float = 5.0
    init_att_rpy_deg: float = 10.0
    init_bg_std: float = 1.5
    init_ba_std: float = 0.5
    init_grav_std: float = 2.5
    acc_bias_std: float = 0.049
    gyr_bias_std: float = 0.38
    acc_vrw: float = 0.0043
    gyr_arw: float = 0.000466
    meas_pos_std: float = 0.02
    meas_att_std: float = 0.01
    joseph_form: bool = True
    # "unroll": step-by-step chain (K1's twin); "cuda": the whole block as
    # one kernel (K1); "assoc": the covariance chain as a log-depth scan of
    # batched products (plain torch ops, the JAX package's off-TPU form)
    predict_batch: str = "assoc"
    # "xla": the op chain (K2's twin); "cuda": one kernel (K2)
    update_form: str = "xla"


@dataclass(frozen=True)
class PipelineConfig:
    """Fused LIO pipeline (``ptudes_tpu.config.PipelineConfig``)."""
    kiss: KissConfig = dataclasses.field(default_factory=KissConfig)
    cap: Capacity = dataclasses.field(default_factory=Capacity)
    ekf: EkfConfig = dataclasses.field(default_factory=EkfConfig)
    max_imu_per_scan: int = 16
    guess: str = "kiss"
    deskew_mode: str = "ekf"
    col_decimation: int = 1
    bootstrap_scans: int = 1
    steady_insert_mode: bool | str = "cond"
    map_frozen: bool = False


def bench_config() -> PipelineConfig:
    """The bench's main-path configuration (``bench.py:bench_config``
    values): 128x1024 scans, 2048-point ICP source, 2^19-slot map with 8
    points per voxel, one probe, 7-neighbourhood over 4 voxels, frozen
    candidates, EKF guess and deskew, 3 bootstrap scans then the decimated
    steady insert — with all four kernels in their CUDA form."""
    h, w = 128, 1024
    return PipelineConfig(
        kiss=KissConfig(max_range=70.0, min_range=1.0,
                        max_points_per_voxel=8, max_iterations=20,
                        deskew=True, loss="plane",
                        voxel_size=0.3, plane_fit_radius=0.6,
                        nn_mode="cached", nn_voxels=4,
                        nn_neighborhood=7, nn_refresh_drift=0.0,
                        icp_form="cuda"),
        cap=Capacity(max_points=h * w, max_frame=32768, max_source=2048,
                     map_capacity=1 << 19, dedup_table=1 << 18,
                     max_new_per_scan=2048, max_probes=1),
        ekf=EkfConfig(predict_batch="cuda", update_form="cuda"),
        max_imu_per_scan=12,
        guess="ekf",
        bootstrap_scans=3,
        steady_insert_mode=False,
    )


def long_config() -> PipelineConfig:
    """The endurance run's configuration (``bench_long.py:82-106``'s
    values): 64x512 scans clipped at 25 m, 2048-point ICP source, a 2^19-
    slot map with 8 points per voxel, a 2^17-slot dedup table, 16384-point
    frames and at most 1024 new points a steady scan, K = 16 IMU samples,
    EKF guess, 3 bootstrap scans then the decimated steady insert — with
    all four kernels in their CUDA form."""
    h, w = 64, 512
    return PipelineConfig(
        kiss=KissConfig(max_range=25.0, min_range=1.0,
                        max_points_per_voxel=8, max_iterations=20,
                        deskew=True, loss="plane", voxel_size=0.3,
                        plane_fit_radius=0.6, nn_mode="cached",
                        nn_voxels=4, nn_neighborhood=7,
                        nn_refresh_drift=0.0, icp_form="cuda"),
        cap=Capacity(max_points=h * w, max_frame=16384, max_source=2048,
                     map_capacity=1 << 19, dedup_table=1 << 17,
                     max_new_per_scan=1024, max_probes=1),
        ekf=EkfConfig(predict_batch="cuda", update_form="cuda"),
        max_imu_per_scan=16,
        guess="ekf",
        bootstrap_scans=3,
        steady_insert_mode=False,
    )


def cli_config(h: int, w: int, guess: str = "ekf") -> PipelineConfig:
    """The flagship command's configuration, ``ptudes ekf-bench ouster``
    (``ptudes_tpu/cli/main.py:428-452``) for an ``h`` x ``w`` sensor, with
    the guess its flags choose: ``"ekf"`` for ``--use-imu-prediction``,
    ``"gt"`` for ``--use-gt-guess``, ``"kiss"`` (constant velocity) for
    neither. The library defaults (50 iterations, 27-neighbourhood, 20
    points per voxel, candidate refresh at half a voxel of drift, the exact
    chunked steady insert) with a 1-70 m range, and the card's kernel
    forms where the command picks the TPU's: the predict block (K1) and the
    ICP kernels; the pose update keeps the command's op chain."""
    return PipelineConfig(
        kiss=KissConfig(max_range=70.0, min_range=1.0, deskew=True,
                        loss="plane", icp_form="cuda"),
        cap=Capacity(max_points=h * w),
        ekf=EkfConfig(predict_batch="cuda"),
        guess=guess)


def twin_config(cfg: PipelineConfig) -> PipelineConfig:
    """``cfg`` with every kernel replaced by its plain PyTorch twin (the
    ``"assoc"`` predict has no kernel and stays)."""
    predict = "unroll" if cfg.ekf.predict_batch == "cuda" \
        else cfg.ekf.predict_batch
    return dataclasses.replace(
        cfg,
        kiss=dataclasses.replace(cfg.kiss, icp_form="torch"),
        ekf=dataclasses.replace(cfg.ekf, predict_batch=predict,
                                update_form="xla"))


def check_supported(cfg: PipelineConfig) -> None:
    """Raise ``ValueError`` for unknown option values and form names."""
    k, e = cfg.kiss, cfg.ekf
    choices = [
        ("guess", cfg.guess, ("ekf", "kiss", "gt")),
        ("deskew_mode", cfg.deskew_mode, ("ekf", "kiss")),
        ("steady_insert_mode", cfg.steady_insert_mode, (False, True, "cond")),
        ("loss", k.loss, ("plane", "point")),
        ("nn_mode", k.nn_mode, ("cached", "every")),
        ("nn_neighborhood", k.nn_neighborhood, (4, 7, 27)),
        ("icp_form", k.icp_form, ("torch", "cuda")),
        ("predict_batch", e.predict_batch, ("unroll", "cuda", "assoc")),
        ("update_form", e.update_form, ("xla", "cuda")),
    ]
    for name, value, known in choices:
        if not any(value is c or (type(value) is type(c) and value == c)
                   for c in known):
            raise ValueError(f"unknown {name} {value!r}")
    if not (isinstance(cfg.col_decimation, int) and cfg.col_decimation >= 1):
        raise ValueError(f"col_decimation {cfg.col_decimation!r} (an int "
                         ">= 1 that divides the scan width)")
    if k.nn_mode == "every" and k.nn_neighborhood == 4:
        raise ValueError("nn_mode='every' queries the 7- or 27-"
                         "neighbourhood, not 4")
