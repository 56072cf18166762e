"""Build, load, launch and count the hand-written CUDA kernels.

The sources in ``ptudes_tpu_torch/csrc`` have a plain C interface. At first
use, one ``nvcc`` per source compiles them for ``sm_90a`` in parallel, and a
last one links the objects into one shared library under
``kernels/_build/<hash of the sources>/`` (listed in ``.gitignore``), which
``ctypes`` loads. Every entry point takes device pointers and the stream as
``c_void_p``, launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero status.

There is no fallback: a missing ``nvcc`` or a failed build raises. The
plain PyTorch twins run only where a wrapper is given CPU tensors.

``LAUNCHES`` counts, per kernel, the launches :func:`launch` made since the
last :func:`reset_launches`; a run shows it went through the kernels by
reading them. A launch with a replica axis (K1-K5, K8 and K9 on the
batched driver's paths: all replicas in one grid) counts once. A launch
of a kernel's variant also counts in ``VARIANT_LAUNCHES``
(``ekf_predict_history``: K1 writing the filter history). ``graph_cond``
is the graph form's predicate kernel (``csrc/graph_cond.cu``, driven by
``models.graph``), which sets a CUDA graph conditional node from a flag on
the card; the host functions beside it that build the nodes are in
``_HOST_SIGNATURES`` (:func:`host_call`).
``stage_stamp`` beside it is the stage clock's stamp (``models.graph.
StageClock``): it is not one of ``KERNELS``, so no count here moves with
it.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64 = ctypes.c_ulonglong
# entry point -> argument types, the stream last
# (K1-K5 take a replica count, and K3-K5 a replica stride, last; K5 also
# a replica mask before its sizes)
_SIGNATURES = {
    "ptudes_ekf_predict": [_P] * 6 + [_I] + [_F] * 4 + [_I, _P],
    "ptudes_ekf_update": [_P] * 4 + [_I, _I, _P],
    "ptudes_gn_prep": [_P] * 9 + [_I, _I, _F, _I, _I, _I, _P],
    "ptudes_icp_loop": [_P] * 8 + [_I, _I] + [_F] * 4 + [_I] * 6 + [_P],
    "ptudes_gn_iter": [_P] * 11 + [_I, _I, _F, _I, _I, _P],
    "ptudes_gather_fused": [_P] * 10 + [_I] * 6 + [_F] * 3 + [_I, _P],
    "ptudes_plane_moments": [_P] * 6 + [_I, _I, _F, _P],
    "ptudes_grid_prededup": [_P] * 3 + [_I] * 3 + [_F, _P],
    "ptudes_voxel_key": [_P] * 3 + [_I, _F, _P],
    "ptudes_graph_cond": [_P, _I, _P, _I, _U64, _P],
}
# launched, never counted: the stage clock's stamp
_UNCOUNTED_SIGNATURES = {"ptudes_stage_stamp": [_P, _I, _I, _I, _I, _P]}
# host functions (no launch): the conditional nodes' construction
_HOST_SIGNATURES = {
    "ptudes_graph_cond_load": [],
    "ptudes_stream_create": [ctypes.POINTER(_P)],
    "ptudes_cond_handle": [_P, _I, ctypes.POINTER(_U64)],
    "ptudes_cond_open": [_P, _P, _I, _U64],
    "ptudes_cond_close": [_P],
}
KERNELS = ("ekf_predict", "ekf_update", "gn_prep", "icp_loop", "gn_iter",
           "gather_fused", "plane_moments", "graph_cond", "grid_prededup",
           "voxel_key")
LAUNCHES = {name: 0 for name in KERNELS}
VARIANT_LAUNCHES = {"ekf_predict_history": 0}

_lib = None
build_log = ""


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else the toolkit's
    default prefix; raises ``RuntimeError`` when none exists."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(NVCC_DEFAULT)
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(build_dir: str | None = None) -> str:
    """Compile the kernels into ``build_dir`` (default ``BUILD_DIR``), once
    per source hash; returns the library path. Raises ``RuntimeError``
    when nvcc is missing or fails."""
    global build_log
    out_dir = os.path.join(build_dir or BUILD_DIR, source_hash())
    lib_path = os.path.join(out_dir, "libptudes_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    cus = [p for p in sources() if p.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(p)[:-3] + ".o")
            for p in cus]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    procs = []
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cus, objs)]
        logs, failed = [], []
        for p, proc in zip(cus, procs):
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(p)} (rc "
                              f"{proc.returncode})")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               f"{build_log[-4000:]}")
        r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                            *objs], capture_output=True, text=True,
                           timeout=NVCC_TIMEOUT_S)
        build_log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (rc {r.returncode}):\n"
                f"{build_log[-4000:]}")
        os.replace(tmp, lib_path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in [tmp, *objs]:
            if os.path.exists(path):
                os.unlink(path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in (*_SIGNATURES.items(),
                               *_UNCOUNTED_SIGNATURES.items(),
                               *_HOST_SIGNATURES.items()):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.ptudes_error_string.argtypes = [ctypes.c_int]
        handle.ptudes_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def ptr(t: torch.Tensor, what: str, dtype: torch.dtype = torch.float32,
        align: int = 1) -> int:
    """Device pointer of a contiguous CUDA tensor of ``dtype`` (float32 by
    default; int32 for the hash map's tables, bool for masks) whose data
    starts on an ``align``-byte boundary (checked)."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{what}: needs a contiguous {dtype} CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: data not aligned to {align} bytes")
    return t.data_ptr()


def launch(name: str, *args, variant: str | None = None) -> None:
    """Launch kernel ``name`` on the current stream; count it (one of
    ``KERNELS``), and its ``variant`` too when given."""
    handle = lib()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(handle, f"ptudes_{name}")(*args, stream)
    if err != 0:
        msg = handle.ptudes_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    if name not in LAUNCHES:
        return
    LAUNCHES[name] += 1
    if variant is not None:
        VARIANT_LAUNCHES[variant] += 1


def host_call(name: str, *args) -> None:
    """Call the host function ``ptudes_<name>`` of the library; raises
    ``RuntimeError`` on a nonzero status."""
    handle = lib()
    err = getattr(handle, f"ptudes_{name}")(*args)
    if err != 0:
        msg = handle.ptudes_error_string(err).decode()
        raise RuntimeError(f"{name} failed: {msg}")


def device_kind(t: torch.Tensor, what: str) -> str:
    """"cpu" (use the twin) or "cuda" (launch); anything else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type
