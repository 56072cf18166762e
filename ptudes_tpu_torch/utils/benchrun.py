"""What the repo's two top-level runs (``bench_torch.py`` and
``bench_long_torch.py``) share: the device they run on, the card's name
and power limit, the kernel build, a timed sequence call and the kernels
it launched."""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

from .. import kernels
from ..models import graph

# the TPU kernel each CUDA kernel ports (PERF.md's table of kernels)
PORTS = {"ekf_predict": "K1", "ekf_update": "K2", "gn_prep": "K3",
         "icp_loop": "K4", "gn_iter": "K5", "gather_fused": "K6",
         "plane_moments": "K7", "graph_cond": "graph predicate",
         "grid_prededup": "K8", "voxel_key": "K9"}
# the source of the kernels not named after theirs
SOURCES = {"grid_prededup": "voxel_grid", "voxel_key": "voxel_grid"}
# each kernel's launches a scan of bench_config()'s path: K1-K4, the
# window pre-dedup (K8) and the two first-in-voxel sort keys (K9)
BENCH_LAUNCHES = {"ekf_predict": 1, "ekf_update": 1, "gn_prep": 1,
                  "icp_loop": 1, "grid_prededup": 1, "voxel_key": 2}


def open_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device without a card raises instead of
    leaving the run on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: torch.cuda.is_available() is "
                           "False (pass --device cpu to run on the CPU)")
    return dev


def card_line(dev: torch.device) -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card (None on
    the CPU)."""
    if dev.type != "cuda":
        return None
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return r.stdout.strip().splitlines()[dev.index or 0]


def power_limit(card: str | None) -> str | None:
    """The power limit of a :func:`card_line` ("700.00 W")."""
    return card.split(",")[-1].strip() if card else None


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def build_kernels(dev: torch.device) -> float | None:
    """Build and load the CUDA kernels from the checkout's sources (the
    CPU runs their twins: None); returns the seconds it took."""
    if dev.type != "cuda":
        return None
    t0 = time.monotonic()
    kernels.build()
    kernels.lib()
    return time.monotonic() - t0


def timed(fn, dev: torch.device) -> dict:
    """``fn()`` (a sequence call) timed on the host clock from a synchronize
    to a synchronize, with every host sync inside it made an error on a
    card: its result, seconds, the kernels' launches and
    ``graph.LAST_RUN``."""
    kernels.reset_launches()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
    t0 = time.monotonic()
    try:
        result = fn()
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(dev)
    return dict(result=result, s=time.monotonic() - t0,
                launches=dict(kernels.LAUNCHES), record=dict(graph.LAST_RUN))


def check_form(run: dict, want: str, cached: bool | None = None) -> None:
    """Raise unless ``run`` (:func:`timed`'s) ran as ``want`` and, for a
    graph, from a kept runner when ``cached`` says so."""
    rec = run["record"]
    if rec["form"] != want:
        raise RuntimeError(f"the sequence ran as {rec['form']}, not {want}")
    if cached is not None and want == "graph" and rec["cached"] != cached:
        raise RuntimeError(f"the graph runner was kept: {rec['cached']}, "
                           f"not {cached}")


def check_launches(run: dict, n_scans: int, per_scan: dict) -> None:
    """Raise unless each kernel of ``per_scan`` launched ``n_scans`` times
    its launches a scan there in ``run`` and no other kernel launched (on
    a card; the CPU runs the twins and launches nothing)."""
    for name, count in run["launches"].items():
        want = n_scans * per_scan.get(name, 0)
        if count != want:
            raise RuntimeError(f"{name} launched {count} times in "
                               f"{n_scans} scans, not {want}")


def kernel_list(launches: dict) -> list[dict]:
    """The kernels one run's ``launches`` launched, each with the TPU
    kernel it ports, its source and its launches in the run."""
    return [dict(name=name, ports=PORTS[name],
                 source=f"ptudes_tpu_torch/csrc/"
                        f"{SOURCES.get(name, name)}.cu",
                 launches_per_run=count)
            for name, count in launches.items() if count]


def median(xs) -> float | None:
    return statistics.median(xs) if xs else None
