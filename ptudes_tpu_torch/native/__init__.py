"""Native host-runtime bindings (ctypes over a small C++ library): the pcap
split with IPv4 reassembly, the Ouster packet decoders and the LZ4 block
decoder.

A copy of ``ptudes_tpu.native`` for the PyTorch port. The library builds
with ``g++`` at first use into ``_build/`` beside this file (never next to
the source). When the build or the load fails, every consumer falls back to
its numpy path with a warning, as in the JAX package; :func:`backend` says
which decoder the last call used, and :func:`numpy_only` forces the numpy
path (the tests compare the two).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import tempfile
import warnings

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ptudes_native.cpp")
_BUILD = os.path.join(_HERE, "_build")
_LIB = os.path.join(_BUILD, "libptudes_native.so")

_lib = None
_tried = False
_enabled = True
_last: str | None = None


def _build() -> bool:
    """Compile into a temporary name, then move it into place, so that
    processes building at once never load a half-written library."""
    try:
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return True
    except Exception as e:  # noqa: BLE001 — any failure means numpy fallback
        warnings.warn(f"native build failed ({e}); using numpy fallbacks")
        return False


def get_lib():
    """Load (building if needed) the native library, or None (also under
    :func:`numpy_only`)."""
    global _lib, _tried
    if not _enabled:
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as e:
        warnings.warn(f"native load failed ({e}); using numpy fallbacks")
        return None
    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.pcap_split_udp.restype = i64
    lib.pcap_split_udp.argtypes = [
        u8p, i64, u8p, i64, i64p, i64p, i64p, i64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.parse_legacy.restype = None
    lib.parse_legacy.argtypes = [
        u8p, i64, i64, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint64, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.uint32, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
    ]
    lib.parse_rng19.restype = None
    lib.parse_rng19.argtypes = lib.parse_legacy.argtypes
    lib.parse_rng15.restype = None
    lib.parse_rng15.argtypes = lib.parse_legacy.argtypes
    dual_argtypes = list(lib.parse_legacy.argtypes) + [
        np.ctypeslib.ndpointer(np.uint32, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
        np.ctypeslib.ndpointer(np.uint16, flags="C"),
    ]
    lib.parse_dual.restype = None
    lib.parse_dual.argtypes = dual_argtypes
    lib.parse_fusa.restype = None
    lib.parse_fusa.argtypes = dual_argtypes
    lib.parse_imu.restype = None
    lib.parse_imu.argtypes = [
        u8p, i64, i64,
        np.ctypeslib.ndpointer(np.uint64, flags="C"),
        np.ctypeslib.ndpointer(np.uint64, flags="C"),
        np.ctypeslib.ndpointer(np.uint64, flags="C"),
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        np.ctypeslib.ndpointer(np.float32, flags="C"),
    ]
    lib.lz4_block_decompress.restype = i64
    lib.lz4_block_decompress.argtypes = [u8p, i64, u8p, i64, i64]
    _lib = lib
    return _lib


def _use():
    """The library for a decode call, recording which decoder it used."""
    global _last
    lib = get_lib()
    _last = "numpy" if lib is None else "native"
    return lib


def backend() -> str | None:
    """``"native"`` or ``"numpy"``: the decoder the last call of this
    module used (None before the first)."""
    return _last


@contextlib.contextmanager
def numpy_only():
    """Within the block every decode takes its numpy path."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev


def lz4_block_decompress(src: bytes, max_out: int = 1 << 30,
                         history: bytes = b"") -> bytes | None:
    """Native LZ4 block decode, or None (numpy/pure-Python fallback).

    ``history`` pre-fills the match window (block-linked frames); only
    the produced bytes are returned. Grows the output buffer on overflow
    (-2) up to ``max_out``; -1 (malformed) raises the same ValueError
    contract as the Python decoder in ``io.lz4f``."""
    lib = _use()
    if lib is None:
        return None
    buf = np.frombuffer(src, np.uint8)
    hist = np.frombuffer(history, np.uint8)
    hl = len(hist)
    cap = min(max(4 * len(src), 1 << 16), max_out) + hl
    while True:
        out = np.zeros(cap, np.uint8)
        if hl:
            out[:hl] = hist
        r = lib.lz4_block_decompress(buf, len(buf), out, cap, hl)
        if r == -2:
            if cap - hl >= max_out:
                raise ValueError("lz4: output exceeds limit")
            cap = min((cap - hl) * 4, max_out) + hl
            continue
        if r < 0:
            raise ValueError("lz4: malformed block")
        return out[hl:hl + r].tobytes()


def pcap_split_udp(data: np.ndarray):
    """Split a pcap byte buffer into reassembled UDP datagrams.

    Returns (arena bytes, offsets, lengths, ts_ns) — datagram i is
    ``arena[offsets[i]:offsets[i]+lengths[i]]`` — or None if the native
    library is unavailable or the capture is unsupported (big-endian).
    IPv4 fragments are reassembled (real Ouster lidar packets exceed MTU).
    """
    global _last
    lib = _use()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    empty8 = np.zeros(0, np.uint8)
    empty64 = np.zeros(0, np.int64)
    used = ctypes.c_int64(0)
    n = lib.pcap_split_udp(
        data, len(data), empty8, 0, empty64, empty64, empty64, 0,
        ctypes.byref(used))
    if n < 0:
        _last = "numpy"
        return None
    arena = np.zeros(used.value, np.uint8)
    offs = np.zeros(n, np.int64)
    lens = np.zeros(n, np.int64)
    ts = np.zeros(n, np.int64)
    lib.pcap_split_udp(data, len(data), arena, used.value, offs, lens, ts,
                       n, ctypes.byref(used))
    return arena, offs, lens, ts


def parse_lidar(profile: str, payloads: np.ndarray, h: int, cpp: int):
    """Decode a [N, packet_size] batch; returns dict of column arrays or
    None for numpy fallback."""
    global _last
    lib = _use()
    if lib is None:
        return None
    fn = {"LEGACY": lib.parse_legacy,
          "RNG19_RFL8_SIG16_NIR16": lib.parse_rng19,
          "RNG15_RFL8_NIR8": lib.parse_rng15,
          "RNG19_RFL8_SIG16_NIR16_DUAL": lib.parse_dual,
          "FUSA_RNG15_RFL8_NIR8_DUAL": lib.parse_fusa}.get(profile)
    if fn is None:
        _last = "numpy"
        return None
    dual = fn in (lib.parse_dual, lib.parse_fusa)
    payloads = np.ascontiguousarray(payloads, np.uint8)
    n = payloads.shape[0]
    ncols = n * cpp
    out = {
        "timestamp": np.zeros(ncols, np.uint64),
        "measurement_id": np.zeros(ncols, np.uint16),
        "frame_id": np.zeros(ncols, np.uint16),
        "status": np.zeros(ncols, np.uint8),
        "range_mm": np.zeros((ncols, h), np.uint32),
        "reflectivity": np.zeros((ncols, h), np.uint16),
        "signal": np.zeros((ncols, h), np.uint16),
        "nir": np.zeros((ncols, h), np.uint16),
    }
    args = [payloads, n, payloads.shape[1], h, cpp,
            out["timestamp"], out["measurement_id"], out["frame_id"],
            out["status"], out["range_mm"], out["reflectivity"],
            out["signal"], out["nir"]]
    if dual:
        out["range2_mm"] = np.zeros((ncols, h), np.uint32)
        out["reflectivity2"] = np.zeros((ncols, h), np.uint16)
        out["signal2"] = np.zeros((ncols, h), np.uint16)
        args += [out["range2_mm"], out["reflectivity2"], out["signal2"]]
    fn(*args)
    return out


def parse_imu(payloads: np.ndarray):
    lib = _use()
    if lib is None:
        return None
    payloads = np.ascontiguousarray(payloads, np.uint8)
    n = payloads.shape[0]
    sys_ts = np.zeros(n, np.uint64)
    accel_ts = np.zeros(n, np.uint64)
    gyro_ts = np.zeros(n, np.uint64)
    accel = np.zeros((n, 3), np.float32)
    avel = np.zeros((n, 3), np.float32)
    lib.parse_imu(payloads, n, payloads.shape[1], sys_ts, accel_ts, gyro_ts,
                  accel.reshape(-1), avel.reshape(-1))
    return {"sys_ts": sys_ts, "accel_ts": accel_ts, "gyro_ts": gyro_ts,
            "accel_g": accel, "avel_deg": avel}
