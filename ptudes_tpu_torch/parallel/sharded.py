"""Point-sharded LIO across ranks (``ptudes_tpu.parallel.sharded``).

Within one sequence the ICP source points are split over the ranks of a
``torch.distributed`` process group (the ``pt`` axis of ``parallel.mesh``):
each rank gathers candidates for its shard from its own copy of the map
and builds its part of the Gauss-Newton system, and one ``all_reduce`` of
the packed system (44 floats) a GN iteration joins them
(``ops.icp.all_reduce_system``). The frozen-candidate form preps once a
scan (K3, or K6 with ``fused_gather``) and runs K5 a GN iteration, never
K4, which cannot reduce across ranks; the refresh form runs its K5 loop
with the all-reduce after each build.

The step is ``lio.make_scan_step`` with a ``group``, not a fork: the
projection, deskew, voxelize cascade, threshold, map insert and EKF run on
every rank on the same inputs, so the maps stay equal and every rank ends
with the same outputs. It differs from the single-rank run only in the
summation order of the joined systems.

Two entry points:

- :func:`sharded_run_sequence`, which every rank calls inside its process
  group;
- :func:`run_sharded`, which starts one process a rank with
  ``torch.multiprocessing`` (the counterpart of the JAX package's one call
  over a mesh), runs :func:`sharded_run_sequence` in each and returns rank
  0's result with a record of the run: backend, world size,
  whether every rank's outputs and state are bit-equal to rank 0's, and
  each rank's kernel launches, host reads, all-reduces and times.

The backend is explicit: ``"nccl"`` when each rank has its own card,
``"gloo"`` for CPU tensors and for several ranks on one card (gloo then
stages the CUDA tensors through host memory: a host sync an all-reduce).
The process group meets through a ``file://`` store in a temporary
directory, so parallel runs never collide on a TCP port.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import kernels
from ..config import PipelineConfig
from ..models import graph as graph_mod
from ..models import kiss, lio
from ..ops import icp
from ..ops.projection import XyzLut
from .replay import _to

BACKENDS = ("nccl", "gloo")
# a collective that waits longer raises in its rank instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)
# all-reduces of the 44-float system that run_sharded(probe=True) times
PROBE_ALLREDUCES = 200


def sharded_run_sequence(state: lio.LioState, batches: lio.ScanBatch,
                         lut: XyzLut, cfg: PipelineConfig, group,
                         log: bool = False
                         ) -> tuple[lio.LioState, lio.LioOut]:
    """``lio.run_sequence`` with every scan's ICP source split over the
    ranks of ``group`` (the same boot / steady insert split, ``log=True``
    the filter history too). Every rank calls it with the same state and
    batches on its own device and gets the same outputs. The first scan's
    ``kiss.register_scan`` raises ``ValueError`` unless
    ``cfg.kiss.nn_mode == "cached"`` and ``cfg.cap.max_source`` is a
    multiple of the group's size."""
    return lio.run_sequence(state, batches, lut, cfg=cfg, log=log,
                            group=group)


class ShardedRun(NamedTuple):
    state: lio.LioState   # rank 0's final state, on the CPU
    out: lio.LioOut       # rank 0's outputs, on the CPU
    backend: str
    world_size: int
    ranks_equal: bool     # every rank's outputs and state bit-equal rank 0's
    # per rank: "device"; "launches" (the kernels'), "host_reads",
    # "regathers" and "allreduces" of the last run; "seconds" of each
    # run; "allreduce_us" (the probe's mean, None without the probe)
    rank_stats: list


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8) \
        if x.dtype.is_floating_point \
        else x


def _same_bits(a, b) -> bool:
    """Every tensor of the trees ``a`` and ``b`` equal bit for bit."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(torch.equal(_bits(x), _bits(y))) for x, y in zip(la, lb))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allreduce_us(dev: torch.device, group) -> float:
    """Host-timed mean us of ``PROBE_ALLREDUCES`` all-reduces of the
    44-float system on ``dev``, each waited for."""
    buf = torch.ones(44, dtype=torch.float32, device=dev)
    dist.all_reduce(buf, group=group)
    _sync(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(PROBE_ALLREDUCES):
        dist.all_reduce(buf, group=group)
        _sync(dev)
    return (time.perf_counter() - t0) / PROBE_ALLREDUCES * 1e6


def _rank_main(rank: int, world: int, workdir: str, backend: str,
               devices: list, log: bool, probe: bool) -> None:
    """One rank of :func:`run_sharded` (a spawned process): join the group
    through the file store, load the inputs onto this rank's device, run
    :func:`sharded_run_sequence` (twice with ``probe``, the last run's
    counts kept), and save the result for the parent."""
    torch.set_num_threads(1)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "store"),
        world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT,
        device_id=dev if backend == "nccl" else None)
    try:
        group = dist.group.WORLD
        state, batches, lut, cfg = _to(torch.load(
            os.path.join(workdir, "inputs.pt"), weights_only=False), dev)
        runs = 2 if probe else 1
        seconds = []
        for i in range(runs):
            kernels.reset_launches()
            icp.reset_refresh_counts()
            dist.barrier(group=group)
            _sync(dev)
            strict = probe and i == runs - 1 and backend == "nccl"
            mode = torch.cuda.get_sync_debug_mode() if strict else None
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                fin, out = sharded_run_sequence(state, batches, lut, cfg,
                                                group, log=log)
            finally:
                if strict:
                    torch.cuda.set_sync_debug_mode(mode)
            _sync(dev)
            seconds.append(time.perf_counter() - t0)
        stats = dict(
            device=str(dev), seconds=seconds,
            form=graph_mod.LAST_RUN["form"],
            launches={**kernels.LAUNCHES, **kernels.VARIANT_LAUNCHES},
            **icp.REFRESH_COUNTS,
            allreduce_us=_allreduce_us(dev, group) if probe else None)
        torch.save(dict(state=_to(fin, "cpu"), out=_to(out, "cpu"),
                        stats=stats),
                   os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier(group=group)
    finally:
        dist.destroy_process_group()


def run_sharded(state: lio.LioState, batches: lio.ScanBatch, lut: XyzLut,
                cfg: PipelineConfig, *, devices, backend: str,
                log: bool = False, probe: bool = False) -> ShardedRun:
    """Run the sequence point-sharded over ``len(devices)`` ranks, rank r
    a process of its own on ``devices[r]`` (``"cpu"``, ``"cuda:0"``, ...;
    several ranks may share a card with gloo), in a process group of
    ``backend`` (``"nccl"``: one card a rank; ``"gloo"``: CPU tensors, or
    ranks sharing a card). The inputs go to the ranks through a file in a
    temporary directory, which also holds the group's store. A collective
    that waits longer than ``COLLECTIVE_TIMEOUT`` fails its rank.

    ``probe`` is a test hook, for ``chip_smoke.py``'s measurement: each
    rank runs the sequence twice from the same state (a warm-up, then the
    timed run, whose counts are kept); with NCCL the timed run is under
    ``torch.cuda.set_sync_debug_mode("error")``, which only the counted
    reads (``icp.read_flags``) lift; then ``PROBE_ALLREDUCES``
    all-reduces of the system are timed. Raises ``ValueError``
    for a configuration that cannot be sharded over the ranks
    (:func:`kiss.check_point_sharding`) or a backend that does not fit the
    devices; a rank that fails raises in the caller."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    world = len(devices)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} (one of {BACKENDS})")
    if world < 1:
        raise ValueError("no devices")
    kiss.check_point_sharding(cfg.kiss, cfg.cap, world)
    if backend == "nccl" and (any(not d.startswith("cuda") for d in devices)
                              or len(set(devices)) < world):
        raise ValueError(f"nccl needs one card a rank, not {devices} "
                         "(gloo runs CPU ranks and ranks sharing a card)")
    with tempfile.TemporaryDirectory(prefix="ptudes_sharded_") as workdir:
        torch.save((_to(state, "cpu"), _to(batches, "cpu"), _to(lut, "cpu"),
                    cfg), os.path.join(workdir, "inputs.pt"))
        mp.spawn(_rank_main, args=(world, workdir, backend, devices, log,
                                   probe),
                 nprocs=world, join=True)
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    r0 = ranks[0]
    equal = all(_same_bits((r["out"], r["state"]), (r0["out"], r0["state"]))
                for r in ranks[1:])
    return ShardedRun(r0["state"], r0["out"], backend, world, equal,
                      [r["stats"] for r in ranks])
