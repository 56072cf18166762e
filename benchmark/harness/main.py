"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The end-to-end metrics are the benchmark's own: ``scans_per_s`` all the
window's scans (every replica's) over all its host time, each chunk from
host memory through the batcher to its last pose; ``scan_latency_p95_ms``
the 95th percentile of every window scan's latency in a closed loop;
``setup_s`` the host time from the process's start to the window. A traced
run (``--trace 1``) profiles a stretch of its window, ends the window
there, and reports the cell's per-layer metrics instead, each from its
reader in ``layers/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
import time

import numpy as np
import torch

from .. import scene
from . import ate, check, spec, trace, window

FORBIDDEN = ("jax", "jaxlib", "flax", "ptudes_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's, its libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def rehearsal(config: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at a size the CPU runs in seconds: a 16 x 128 sensor,
    capacities to match, short recordings and chunks, checks of four and
    two scans.
    Nothing of a rehearsal is a measurement of the card."""
    config = json.loads(json.dumps(config))
    traffic = json.loads(json.dumps(traffic))
    sen = config["sensor"]
    sen["h"], sen["w"] = 16, 128
    cap = config["pipeline"]["cap"]
    cap.update(max_points=16 * 128, max_frame=2048,
               max_source=min(cap["max_source"], 512), map_capacity=1 << 14,
               dedup_table=1 << 14,
               max_new_per_scan=min(cap["max_new_per_scan"], 512))
    traffic.update(recording_scans=48, chunk_scans=4, warmup_scans=3,
                   trace_scans=2)
    traffic["check"].update(scans=2, fresh_scans=4)
    return config, traffic


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell's files, the program's modules and
    configuration, the device, the seed, and the set-up clock."""
    config: dict
    traffic: dict
    limits: dict | None
    device: torch.device
    t0: float
    seconds: float
    seed: int
    rng: random.Random
    profiler: trace.Profiler
    stages: dict = dataclasses.field(default_factory=dict)
    setup_s: float | None = None
    recs: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        from ptudes_tpu_torch import kernels
        from ptudes_tpu_torch.config import (Capacity, EkfConfig, KissConfig,
                                             PipelineConfig)
        from ptudes_tpu_torch.models import graph, lio, online
        from ptudes_tpu_torch.ops.projection import XyzLut
        from ptudes_tpu_torch.parallel import batched, replay
        self.lio, self.online, self.graph = lio, online, graph
        self.kernels = kernels
        self.batched, self.replay = batched, replay
        self.pipeline = self.config["pipeline"]
        p = self.pipeline
        top = {k: v for k, v in p.items() if k not in ("kiss", "cap", "ekf")}
        self.cfg = PipelineConfig(kiss=KissConfig(**p["kiss"]),
                                  cap=Capacity(**p["cap"]),
                                  ekf=EkfConfig(**p["ekf"]), **top)
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else None)
        self.sensor_spec = self.config["sensor"]
        s = self.sensor_spec
        self.sensor = scene.make_sensor(s["h"], s["w"], s["fov_deg"])
        self.lut = XyzLut(*(torch.as_tensor(x, device=self.device)
                            for x in (self.sensor.direction,
                                      self.sensor.offset)))

    def mark(self, stage: str) -> None:
        """A set-up stage done; after the scene, the memory peak restarts
        (the scene is the benchmark's, not the program's)."""
        self.stages[stage] = time.perf_counter() - self.t0
        if stage == "scene" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def end_setup(self) -> None:
        self.setup_s = time.perf_counter() - self.t0
        self.stages["setup"] = self.setup_s


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the context, the window and the
    traced stretch (None where nothing was traced)."""
    ctx: Context
    window: window.Window
    stretch: trace.Stretch | None

    def kernel(self, name: str):
        return spec.kernel_count(name)

    def aux(self, field: str) -> np.ndarray:
        """A ``KissAux`` field of the stretch's scans (of every replica),
        flat: ``iterations`` (GN iterations), ``source_count`` (points in
        the ICP source), ...; empty where nothing was traced."""
        a = self.window.stretch_aux
        if a is None:
            return np.zeros(0)
        return getattr(a, field).cpu().numpy().reshape(-1).astype(np.int64)


def end_to_end(name: str, ctx: Context, win: window.Window) -> float:
    if name == "setup_s":
        return ctx.setup_s
    if name == "scans_per_s":
        return win.scans / win.seconds
    if name == "scan_latency_p95_ms":
        return float(np.percentile(np.asarray(win.latencies), 95) * 1e3)
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the measurement), or cpu for a rehearsal "
                    "at a tiny size (the program's kernel twins)")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also run the reference with TF32 products and "
                    "print its gaps to the float32 reference (the check's "
                    "control); not part of a measured run")
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config_file(bench, cell)
    traffic = spec.traffic_file(cell)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            say("torch.cuda.is_available() is False: no result")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            say(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell['chips']}: no result")
            return 2
        device = torch.device("cuda", 0)
    else:
        config, traffic = rehearsal(config, traffic)
    torch.set_num_threads(1)
    ctx = Context(config=config, traffic=traffic,
                  limits=spec.limits_file(cell), device=device, t0=t0,
                  seconds=args.seconds, seed=args.seed,
                  rng=random.Random(args.seed),
                  profiler=trace.Profiler(device, bool(args.trace)))
    if device.type == "cuda":
        # the harness's own first CUDA work and the kernel library, before
        # any set-up call of the program times its capture
        from ptudes_tpu_torch import kernels
        x = torch.ones(64, 64, device=device)
        (x @ x).sum().item()
        kernels.lib()
        ctx.mark("kernels")
    win = spec.driver(traffic["driver"]).run(ctx)
    if args.trace and device.type == "cuda" and ctx.profiler.stretch is None:
        raise RuntimeError("the traced run profiled no stretch")
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": cell["chips"] if device.type == "cuda" else 0,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0}
    stretch = ctx.profiler.stretch
    if stretch is not None:
        dev_info.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
    failed = check.nonfinite_scans(win.outs)
    metrics = {}
    run = Run(ctx, win, stretch)
    wanted = (spec.per_layer(bench, cell["name"]) if args.trace
              else spec.end_to_end(bench, cell["name"]))
    for m in wanted:
        value = (spec.layer_reader(m["name"]).read(run) if args.trace
                 else end_to_end(m["name"], ctx, win))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    stats = ctx.stages | {"window_s": win.seconds, "scans": win.scans,
                          "checks": len(win.checks),
                          "chunk_s": [round(x, 4) for x in win.chunk_s]}
    if win.track:
        kp = torch.cat(win.track).double().cpu().numpy()
        stats["ate_rmse_m"] = ate.ate_rmse(kp, ctx.recs[0].gt_mid[:len(kp)])
        stats["ate_scans"] = len(kp)
    if stretch is not None:
        stats.update(stretch_scans=stretch.scans,
                     stretch_iterations=int(run.aux("iterations").sum()),
                     stretch_source_mean=float(
                         run.aux("source_count").mean()),
                     stretch_k5_program=win.stretch_k5,
                     stretch_k5_traced=trace.kernel_time(stretch,
                                                         "gn_iter_kernel")[0],
                     stretch_k4_traced=trace.kernel_time(stretch,
                                                         "icp_loop_kernel")[0])
    say("run: " + json.dumps(stats))
    # the program's outputs go to the host, and its state and graphs are
    # freed, before the reference runs
    got = [check.program_fields(c) for c in win.checks]
    runs = [(r.rec, r.origin, check.run_fields(r)) for r in win.runs]
    ctx.graph.RUNNERS.clear()
    win.outs, win.runs = [], []
    for c in win.checks:
        c.out = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tr = time.perf_counter()
    want = [check.reference_fields(ctx, c) for c in win.checks]
    readings = check.worst([check.gaps(g, w) for g, w in zip(got, want)])
    say(f"reference: {len(win.checks)} checks, "
        f"{sum(c.n for c in win.checks)} scans, "
        f"{time.perf_counter() - tr:.2f} s")
    if got:
        say("position gap by scan of the first check (m): " + json.dumps(
            [float(f"{x:.3g}") for x in check.pose_gaps(got[0], want[0])]))
    tr = time.perf_counter()
    readings |= check.worst([check.filter_gaps(ctx, *r) for r in runs],
                            check.FILTER_NUMBERS)
    say(f"filter: {len(runs)} recordings, "
        f"{sum(len(r[2]['kiss_pose']) for r in runs)} scans, "
        f"{time.perf_counter() - tr:.2f} s")
    if args.control:
        tf32 = [check.reference_fields(ctx, c, True) for c in win.checks]
        ctrl = check.worst([check.gaps(g, w) for g, w in zip(tf32, want)])
        ctrl |= check.worst([
            check.filter_gaps(ctx, c.rec, c.time_origin or 0.0, g)
            for c, g in zip(win.checks, tf32) if c.start is None],
            check.FILTER_NUMBERS)
        line = {"control": ctrl, "program": readings, "seed": args.seed,
                "workload": cell["name"]}
        print(json.dumps(line), flush=True)
        say("control: " + json.dumps(line))
    readings["nonfinite_scans"] = failed
    correct, checked = check.judge(readings, ctx.limits)
    say("readings: " + json.dumps(readings))
    bad = forbidden_modules()
    if bad:
        say("modules of JAX or the JAX package were loaded: "
            + ", ".join(bad))
        return 3
    result = {"correct": correct, "attempted": win.scans, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if stretch is not None:
        result["breakdown"] = trace.breakdown(stretch)
    result["checked"] = checked
    for name, c in checked.items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
