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

With an NCCL group on the cards each rank runs the sequence as the
single-card driver does, in its graph form (``models.graph``; the JAX
package's ``jax.jit(shard_map(run))``): the boot and steady steps captured
once and replayed once a scan, the GN loop a WHILE node whose body holds
K5, the all-reduce, the solve and the update, the refresh form's
re-gather an IF node in it, no host read in a replay. Every rank replays
the same number of iterations: the loop's flag is computed from the
all-reduced system and the shared pose. Each rank keeps its runners as
the single-card driver does, keyed also by the group's backend, the rank
and the world size. A gloo group stages each all-reduce through host
memory, which no graph can hold: its ranks run eagerly, a host loop with
one read of the loop's flag and one all-reduce a GN iteration.

Two entry points:

- :func:`sharded_run_sequence`, which every rank calls inside its process
  group;
- :func:`run_sharded`, which starts one process a rank with
  ``torch.multiprocessing`` (the counterpart of the JAX package's one call
  over a mesh), runs :func:`sharded_run_sequence` in each and returns rank
  0's result with a record of the run: backend, world size,
  whether every rank's outputs and state are bit-equal to rank 0's, and
  each rank's form, kernel launches, host reads, all-reduces and times.
  It waits for the ranks at most ``timeout`` seconds (a collective
  captured in a graph has no timeout of its own), then kills them and
  raises.

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
# all-reduces of the 44-float system that run_sharded's probe times,
# eagerly and (NCCL) captured into one graph
PROBE_ALLREDUCES = 200
# run_sharded's default wall-clock limit on its rank processes, in seconds
RUN_TIMEOUT_S = 1800.0


def sharded_run_sequence(state: lio.LioState, batches: lio.ScanBatch,
                         lut: XyzLut, cfg: PipelineConfig, group,
                         log: bool = False, graph: bool | None = None,
                         capture: bool = True
                         ) -> tuple[lio.LioState, lio.LioOut]:
    """``lio.run_sequence`` with every scan's ICP source split over the
    ranks of ``group`` (the same boot / steady insert split, ``log=True``
    the filter history too). Every rank calls it with the same state and
    batches on its own device and gets the same outputs. The first scan's
    ``kiss.register_scan`` raises ``ValueError`` unless
    ``cfg.kiss.nn_mode == "cached"`` and ``cfg.cap.max_source`` is a
    multiple of the group's size.

    ``graph`` as ``lio.run_sequence``'s: None replays captured steps for
    an NCCL group on the cards and runs a gloo group's eagerly; True
    raises ``ValueError`` for gloo. ``capture=False`` is a test hook: the
    graph form's code (the runner's buffers, the loop's WHILE and IF
    bodies as host loops) with no capture, whatever ``graph`` says, so the
    CPU tests run it with a gloo group (``lio.graph_run``)."""
    if not capture:
        return lio.graph_run(state, batches, lut, cfg=cfg, log=log,
                             group=group, capture=False)
    return lio.run_sequence(state, batches, lut, cfg=cfg, log=log,
                            group=group, graph=graph)


class ShardedRun(NamedTuple):
    state: lio.LioState   # rank 0's final state, on the CPU
    out: lio.LioOut       # rank 0's outputs, on the CPU
    backend: str
    world_size: int
    ranks_equal: bool     # every rank's outputs and state bit-equal rank 0's
    # per rank, of its last run: "asked" (its graph argument), "form"
    # ("graph", "eager" or "static"), "graph" (models.graph.LAST_RUN:
    # capture ms, pool MB, conditional counts, "cached"), "launches" (the
    # kernels'), "host_reads", "regathers" and "allreduces"; "device";
    # "seconds" of each timed run and "warm_seconds" of each warm-up;
    # "runs" (each timed run's record) and "runs_equal"; "allreduce_us"
    # (the probe's host-timed mean, None without the probe) and
    # "captured_allreduce_us" (the probe's, NCCL only)
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


def _captured_allreduce_us(dev: torch.device, group) -> float:
    """Mean us of one all-reduce of the 44-float system among
    ``PROBE_ALLREDUCES`` captured into one CUDA graph, the graph replayed
    (every rank together) and timed with CUDA events."""
    buf = torch.zeros(44, dtype=torch.float32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dist.all_reduce(buf, group=group)
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(PROBE_ALLREDUCES):
            dist.all_reduce(buf, group=group)
    g.replay()
    _sync(dev)
    dist.barrier(group=group)
    _sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        g.replay()
    stop.record()
    _sync(dev)
    return start.elapsed_time(stop) * 1e3 / (reps * PROBE_ALLREDUCES)


def _one_run(state, batches, lut, cfg, group, dev, *, log, graph, capture,
             strict: bool) -> tuple:
    """One :func:`sharded_run_sequence` call, the ranks lined up before
    it, with ``strict`` (NCCL's timed runs) under
    ``torch.cuda.set_sync_debug_mode("error")`` throughout: ((final
    state, outputs), its record: the form asked for and the form run,
    ``models.graph.LAST_RUN``, seconds, launches and counts)."""
    kernels.reset_launches()
    icp.reset_refresh_counts()
    dist.barrier(group=group)
    _sync(dev)
    mode = torch.cuda.get_sync_debug_mode() if strict else None
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        res = sharded_run_sequence(state, batches, lut, cfg, group, log=log,
                                   graph=graph, capture=capture)
    finally:
        if strict:
            torch.cuda.set_sync_debug_mode(mode)
    _sync(dev)
    seconds = time.perf_counter() - t0
    return res, dict(
        asked=graph, form=graph_mod.LAST_RUN["form"],
        graph=dict(graph_mod.LAST_RUN), seconds=seconds,
        launches={**kernels.LAUNCHES, **kernels.VARIANT_LAUNCHES},
        **icp.REFRESH_COUNTS)


def _rank_main(rank: int, world: int, workdir: str, backend: str,
               devices: list, log: bool, graph: bool | None, capture: bool,
               probe: tuple) -> None:
    """One rank of :func:`run_sharded` (a spawned process): join the group
    through the file store, load the inputs onto this rank's device, run
    :func:`sharded_run_sequence` (with ``probe``: each form of it once
    untimed, then a timed run for each of its entries in turn), and save
    the first timed run's result and the runs' records for the parent."""
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

        def run(form, strict):
            return _one_run(state, batches, lut, cfg, group, dev, log=log,
                            graph=form, capture=capture, strict=strict)

        warm = [run(form, False) for form in dict.fromkeys(probe)]
        runs = [run(form, bool(probe) and backend == "nccl")
                for form in (probe or (graph,))]
        first = runs[0][0]
        stats = dict(
            runs[-1][1], device=str(dev),
            seconds=[r[1]["seconds"] for r in runs],
            warm_seconds=[r[1]["seconds"] for r in warm],
            runs=[r[1] for r in runs],
            runs_equal=all(_same_bits(r[0], first) for r in warm + runs),
            allreduce_us=_allreduce_us(dev, group) if probe else None,
            captured_allreduce_us=(_captured_allreduce_us(dev, group)
                                   if probe and backend == "nccl" else None))
        torch.save(dict(state=_to(first[0], "cpu"), out=_to(first[1], "cpu"),
                        stats=stats),
                   os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier(group=group)
    finally:
        dist.destroy_process_group()


def run_sharded(state: lio.LioState, batches: lio.ScanBatch, lut: XyzLut,
                cfg: PipelineConfig, *, devices, backend: str,
                log: bool = False, graph: bool | None = None,
                capture: bool = True, probe: tuple = (),
                timeout: float = RUN_TIMEOUT_S) -> ShardedRun:
    """Run the sequence point-sharded over ``len(devices)`` ranks, rank r
    a process of its own on ``devices[r]`` (``"cpu"``, ``"cuda:0"``, ...;
    several ranks may share a card with gloo), in a process group of
    ``backend`` (``"nccl"``: one card a rank; ``"gloo"``: CPU tensors, or
    ranks sharing a card). The inputs go to the ranks through a file in a
    temporary directory, which also holds the group's store. An eager
    collective that waits longer than ``COLLECTIVE_TIMEOUT`` fails its
    rank; a captured one has no timeout, so the ranks are killed and
    ``TimeoutError`` raised once ``timeout`` seconds have passed.

    ``graph`` and ``capture`` as :func:`sharded_run_sequence`'s (NCCL
    ranks replay captured steps by default, gloo ranks run eagerly).

    ``probe`` is a test hook, for ``chip_smoke.py``'s measurement: the
    ``graph`` values of timed runs, in turn (``(False, True, True,
    False)``: the two forms alternating), in place of ``graph``. Each rank
    first runs each form of it once untimed (the warm-up; a graph's
    capture), then the timed runs from the same state, every graph run a
    later call of the kept runner; the last run's counts are the rank's,
    each run's are in ``"runs"``, and ``"runs_equal"`` says whether every
    run's outputs and state are bit-equal to the first timed run's. With
    NCCL each timed run is under ``torch.cuda.set_sync_debug_mode
    ("error")`` throughout, which only the counted reads
    (``icp.read_flags``, eager) and a graph's one read of its counters
    after the run lift. Then ``PROBE_ALLREDUCES`` all-reduces of the
    system are timed, each waited for on the host, and with NCCL also
    captured into one graph and replayed.

    Raises ``ValueError`` for a configuration that cannot be sharded over
    the ranks (:func:`kiss.check_point_sharding`), a backend that does not
    fit the devices, or a graph asked of gloo; a rank that fails raises in
    the caller."""
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
    if capture and any(f for f in (graph, *probe)) and backend != "nccl":
        raise ValueError(f"graph=True: a {backend} group's step cannot be "
                         "captured (it stages each all-reduce through host "
                         "memory); only nccl's can")
    with tempfile.TemporaryDirectory(prefix="ptudes_sharded_") as workdir:
        torch.save((_to(state, "cpu"), _to(batches, "cpu"), _to(lut, "cpu"),
                    cfg), os.path.join(workdir, "inputs.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(world, workdir, backend, devices, log, graph,
                              capture, tuple(probe)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"run_sharded: the {world} ranks did not finish within "
                    f"{timeout:.0f} s (killed)")
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    r0 = ranks[0]
    equal = all(_same_bits((r["out"], r["state"]), (r0["out"], r0["state"]))
                for r in ranks[1:])
    return ShardedRun(r0["state"], r0["out"], backend, world, equal,
                      [r["stats"] for r in ranks])
