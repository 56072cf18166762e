"""Ouster sensor metadata (JSON) parsing.

A copy of ``ptudes_tpu.io.metadata`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

Replaces ouster-sdk ``SensorInfo`` for the fields this framework needs
(reference reader with the legacy ``lidar_mode`` backfill:
``src/ptudes/utils.py:157-168``). Supports both the legacy flat layout and
the FW 2.x+ nested layout (``beam_intrinsics`` / ``lidar_data_format`` /
``config_params``).
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field

import numpy as np

# UDP lidar profiles (subset we parse)
PROFILE_LEGACY = "LEGACY"
PROFILE_RNG19 = "RNG19_RFL8_SIG16_NIR16"
PROFILE_RNG15 = "RNG15_RFL8_NIR8"
PROFILE_DUAL = "RNG19_RFL8_SIG16_NIR16_DUAL"
PROFILE_FUSA = "FUSA_RNG15_RFL8_NIR8_DUAL"


@dataclass
class SensorInfo:
    prod_line: str = "OS-0-128"
    mode: str = "1024x10"
    columns_per_frame: int = 1024
    pixels_per_column: int = 128
    columns_per_packet: int = 16
    pixel_shift_by_row: list[int] = field(default_factory=list)
    udp_profile_lidar: str = PROFILE_LEGACY
    beam_altitude_angles: np.ndarray = None
    beam_azimuth_angles: np.ndarray = None
    lidar_origin_to_beam_origin_mm: float = 0.0
    lidar_to_sensor_transform: np.ndarray = None
    imu_to_sensor_transform: np.ndarray = None
    extrinsic: np.ndarray = None  # user extrinsics (sensor -> target frame)

    @property
    def w(self) -> int:
        return self.columns_per_frame

    @property
    def h(self) -> int:
        return self.pixels_per_column

    @property
    def frequency(self) -> int:
        return int(self.mode.split("x")[1]) if "x" in self.mode else 10

    def range_unit_m(self) -> float:
        """Meters per raw range unit (mm, or 8 mm for the RNG15 profile —
        the scaling the reference stats tracker applies,
        ``src/ptudes/ins/data.py:244-249``)."""
        return 0.008 if self.udp_profile_lidar == PROFILE_RNG15 else 0.001


def _get(js: dict, *paths, default=None):
    for path in paths:
        node = js
        ok = True
        for key in path.split("."):
            if isinstance(node, dict) and key in node:
                node = node[key]
            else:
                ok = False
                break
        if ok and node is not None:
            return node
    return default


def parse_metadata(json_str: str) -> SensorInfo:
    js = json.loads(json_str)
    # FW 3.x wraps everything under "sensor_info" sometimes; flatten one level
    if "sensor_info" in js and isinstance(js["sensor_info"], dict) \
            and "beam_intrinsics" not in js and "beam_altitude_angles" not in js:
        merged = dict(js["sensor_info"])
        for k, v in js.items():
            if k != "sensor_info":
                merged[k] = v
        js = merged

    alt = _get(js, "beam_altitude_angles", "beam_intrinsics.beam_altitude_angles")
    azi = _get(js, "beam_azimuth_angles", "beam_intrinsics.beam_azimuth_angles")
    if alt is None or azi is None:
        raise ValueError("metadata missing beam intrinsics")

    mode = _get(js, "lidar_mode", "config_params.lidar_mode")
    if mode is None:
        # reference backfill hack for NC 2020 legacy metadata
        # (src/ptudes/utils.py:160-167)
        warnings.warn(
            "lidar_mode not present in metadata; assuming 1024x10 "
            "(legacy Newer College metadata)"
        )
        mode = "1024x10"

    h = len(alt)
    df_w = _get(js, "data_format.columns_per_frame",
                "lidar_data_format.columns_per_frame")
    w = int(df_w) if df_w else int(mode.split("x")[0])

    shifts = _get(js, "data_format.pixel_shift_by_row",
                  "lidar_data_format.pixel_shift_by_row", default=[0] * h)

    def mat4(x, default=None):
        if x is None:
            return default if default is not None else np.eye(4)
        return np.asarray(x, np.float64).reshape(4, 4)

    return SensorInfo(
        prod_line=_get(js, "prod_line", "sensor_info.prod_line",
                       default="unknown"),
        mode=mode,
        columns_per_frame=w,
        pixels_per_column=h,
        columns_per_packet=int(
            _get(js, "data_format.columns_per_packet",
                 "lidar_data_format.columns_per_packet", default=16)),
        pixel_shift_by_row=list(shifts),
        udp_profile_lidar=_get(
            js, "data_format.udp_profile_lidar",
            "lidar_data_format.udp_profile_lidar",
            "config_params.udp_profile_lidar",
            default=PROFILE_LEGACY),
        beam_altitude_angles=np.asarray(alt, np.float64),
        beam_azimuth_angles=np.asarray(azi, np.float64),
        lidar_origin_to_beam_origin_mm=float(
            _get(js, "lidar_origin_to_beam_origin_mm",
                 "beam_intrinsics.lidar_origin_to_beam_origin_mm",
                 default=0.0)),
        lidar_to_sensor_transform=mat4(
            _get(js, "lidar_to_sensor_transform",
                 "lidar_intrinsics.lidar_to_sensor_transform")),
        imu_to_sensor_transform=mat4(
            _get(js, "imu_to_sensor_transform",
                 "imu_intrinsics.imu_to_sensor_transform")),
        extrinsic=np.eye(4),
    )


def read_metadata_json(path: str) -> SensorInfo:
    """File variant (reference ``read_metadata_json``,
    ``src/ptudes/utils.py:157-168``)."""
    with open(path) as f:
        return parse_metadata(f.read())


def resolve_metadata(data_path: str, meta_path: str | None = None) -> str | None:
    """Find a metadata JSON next to the data file (ouster-sdk
    ``resolve_metadata`` equivalent, used at
    ``src/ptudes/cli/ekf_bench.py:420``)."""
    import glob
    import os

    if meta_path:
        return meta_path
    base = os.path.splitext(data_path)[0]
    # prefer exact-stem match, then any json in the directory
    if os.path.isfile(base + ".json"):
        return base + ".json"
    d = os.path.dirname(os.path.abspath(data_path))
    cands = sorted(glob.glob(os.path.join(d, "*.json")))
    return cands[0] if cands else None
