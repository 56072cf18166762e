"""Whether an NCCL all-reduce can sit in a CUDA graph's conditional body.

The point-sharded step's graph form (``parallel.sharded``) captures the
GN loop as a WHILE node whose body holds K5, one ``dist.all_reduce`` of
the 44-float system, the solve and the update (``ops.icp._refresh_graph``,
``models.graph.while_node``). A conditional body accepts only some node
kinds (kernels, memsets, memcpys, empty, child-graph and conditional
nodes); this probe captures a process group's all-reduce in each place the
sharded graph puts one and replays it:

- ``plain``: an all-reduce in a ``torch.cuda.graph`` capture, no node;
- ``while``: an all-reduce in a WHILE body that counts to a bound set on
  the card (7, then 3 with no new capture), the body's executions counted
  on the card by the predicate kernel;
- ``while_if``: the same with an IF node inside the body whose body holds
  a second all-reduce, taken at one iteration (the refresh form's
  re-gather sits there);
- ``while_avg``: ``ReduceOp.AVG`` in the WHILE body; at world size 1 NCCL
  launches its one-rank scaling kernel for a float average, so a kernel of
  NCCL's own sits in the body;
- ``while_norecord``: ``while`` with ``TORCH_NCCL_AVOID_RECORD_STREAMS=1``;
- ``timing``: ``PROBE`` all-reduces of 44 floats captured into one graph,
  replayed and timed with CUDA events, beside the host-timed eager call.

Every case runs in a process of its own (a refused capture can leave the
context unusable), in a process group of one rank on ``cuda:0`` (NCCL
allows one rank a card; a one-card machine runs world size 1 only). Each
prints one JSON line; the last line gathers them.

    python tools/exp_nccl_graph_probe.py [--backend nccl] [--cases ...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("plain", "while", "while_if", "while_avg", "while_norecord",
         "timing")
PROBE = 200          # all-reduces captured into the timed graph
CASE_TIMEOUT_S = 180


def run_case(case: str, backend: str) -> dict:
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from ptudes_tpu_torch import kernels
    from ptudes_tpu_torch.models import graph

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            world_size=1, rank=0,
            device_id=dev if backend == "nccl" else None)
        try:
            return _case(case, dev, torch, dist, kernels, graph)
        finally:
            dist.destroy_process_group()


def _case(case, dev, torch, dist, kernels, graph) -> dict:
    class OneCall(graph.StepGraph):
        """A runner whose scan is one call of its step on its state."""

        def scan_inputs(self):
            return None, 0

        def emit(self, outs) -> int:
            return 0

    buf = torch.arange(44, dtype=torch.float32, device=dev) + 1.0
    want = buf.clone()
    dist.all_reduce(buf)               # the communicator's first use
    torch.cuda.synchronize()
    out = dict(case=case, torch=torch.__version__, cuda=torch.version.cuda,
               nccl=".".join(map(str, torch.cuda.nccl.version())),
               device=torch.cuda.get_device_name(0))
    if case == "plain":
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            dist.all_reduce(buf)
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            dist.all_reduce(buf)
            buf.mul_(2.0)
        for _ in range(2):
            g.replay()
        torch.cuda.synchronize()
        # world size 1: each all-reduce keeps buf, each replay doubles it
        ok = torch.equal(buf, want * 4.0)
        return dict(out, ok=bool(ok), got=float(buf[1]),
                    want=float(want[1] * 4))
    if case == "timing":
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            dist.all_reduce(buf)
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            for _ in range(PROBE):
                dist.all_reduce(buf)
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        reps = 5
        start.record()
        for _ in range(reps):
            g.replay()
        stop.record()
        torch.cuda.synchronize()
        captured = start.elapsed_time(stop) * 1e3 / (reps * PROBE)
        t0 = time.perf_counter()
        for _ in range(PROBE):
            dist.all_reduce(buf)
            torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / PROBE * 1e6
        return dict(out, ok=True, captured_us=captured, eager_host_us=eager,
                    calls=PROBE)
    op = dist.ReduceOp.AVG if case == "while_avg" else dist.ReduceOp.SUM
    limit = torch.tensor(7, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def step(state, _):
        n, acc, hit = (x.clone() for x in state)
        go = torch.ones((), dtype=torch.bool, device=dev)

        def inner():
            x = torch.full((44,), 2.0, device=dev)
            dist.all_reduce(x, op=op)
            hit.add_(x[:1].to(torch.int32).squeeze(0))

        def body():
            x = torch.ones(44, dtype=torch.float32, device=dev)
            dist.all_reduce(x, op=op)
            acc.add_(x.sum().to(torch.int32))
            n.add_(1)
            go.copy_(n < limit)
            if case == "while_if":
                graph.if_node("inner", n == 3, inner)

        graph.while_node("loop", go, body)
        return (n, acc, hit),

    t0 = time.perf_counter()
    g = OneCall((zero, zero, zero))
    g.add("s", step)
    capture_ms = (time.perf_counter() - t0) * 1e3
    runs = []
    ok = True
    for b in (7, 3):
        limit.fill_(b)
        for x in g.state:
            x.zero_()
        kernels.reset_launches()
        g.begin_counts()
        g.step("s")
        g.fold_counts()
        got = tuple(int(x) for x in g.state)
        want_ = (b, 44 * b, 2 if case == "while_if" else 0)
        ok &= got == want_ and g.cond.get("loop") == b
        runs.append(dict(bound=b, got=got, want=want_, cond=g.cond,
                         graph_cond=kernels.LAUNCHES["graph_cond"]))
    return dict(out, ok=bool(ok), runs=runs, capture_ms=capture_ms,
                cond_nodes=g.cond_nodes,
                avoid_record_streams=os.environ.get(
                    "TORCH_NCCL_AVOID_RECORD_STREAMS"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    ap.add_argument("--case", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.case:
        print(json.dumps(run_case(args.case, args.backend)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    results = []
    for case in args.cases:
        env = dict(os.environ)
        if case == "while_norecord":
            env["TORCH_NCCL_AVOID_RECORD_STREAMS"] = "1"
        cmd = [sys.executable, os.path.abspath(__file__), "--case",
               "while" if case == "while_norecord" else case,
               "--backend", args.backend]
        try:
            p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=CASE_TIMEOUT_S)
            line = p.stdout.strip().splitlines()[-1:] if p.returncode == 0 \
                else []
            res = json.loads(line[0]) if line else dict(
                case=case, ok=False, rc=p.returncode,
                error=p.stderr[-3000:])
        except subprocess.TimeoutExpired:
            res = dict(case=case, ok=False, error="timed out")
        res["case"] = case
        print(json.dumps(res), flush=True)
        results.append(res)
    print(json.dumps(dict(ok=all(r["ok"] for r in results),
                          cases={r["case"]: r["ok"] for r in results})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
