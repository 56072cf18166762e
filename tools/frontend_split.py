"""The grid front end's device time by part, on the card.

    python3 tools/frontend_split.py [--json out.json]

Run from the root of a checkout. One scan (scan 20 of the benchmark's
circle recording, seed 2147483747) at each configuration of
``benchmark/configs``: each part of ``kiss.register_scan``'s grid front
end, from the range image to the compacted ICP source, is captured alone
as a CUDA graph and replayed; CUDA events around 200 replays give its
device us a call, the gaps between its graph nodes included. Both forms of
``KissConfig.icp_form`` (``"cuda"``: K8 and K9; ``"torch"``: the torch
code), and the whole front end captured as one graph beside the parts'
sum. Prints one JSON line, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import stage_clock_probe as probe  # noqa: E402
from ptudes_tpu_torch.ops import deskew, voxel  # noqa: E402
from ptudes_tpu_torch.ops.projection import scan_to_points  # noqa: E402

SCAN = 20
REPS = 200


def graph_us(fn, reps: int = REPS) -> float:
    """Device us of one replay of ``fn`` captured as a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps


def parts(cfg, lut, rm, form: str):
    """(name, fn) of each front-end part, its inputs the previous parts'
    outputs computed once."""
    k, cap = cfg.kiss, cfg.cap
    vs, d = k.resolved_voxel_size, cfg.col_decimation
    grid = (rm.shape[0], rm.shape[1] // d)
    twist = torch.tensor([0.01, -0.02, 0.15, 0.2, 0.01, -0.03],
                         device=rm.device)
    pts, mask, ts = scan_to_points(lut, rm, decimate=d)
    dsk = deskew.deskew_by_twist(pts, ts - 0.5, twist)
    clip = voxel.range_clip_mask(dsk, mask, k.min_range, k.max_range)
    pre = voxel.window_prededup_mask(dsk, clip, 0.5 * vs, grid, form=form)
    cp, cm = voxel.compact(dsk, pre, cap.max_frame)
    f1, k1 = voxel.first_in_voxel_sorted(cp, cm, 0.5 * vs, cap.max_frame,
                                         form=form)
    f2, k2 = voxel.first_in_voxel_sorted(f1, k1, 1.5 * vs, cap.max_frame,
                                         form=form)

    def whole():
        p, m, t = scan_to_points(lut, rm, decimate=d)
        p = deskew.deskew_by_twist(p, t - 0.5, twist)
        m = voxel.range_clip_mask(p, m, k.min_range, k.max_range)
        m = voxel.window_prededup_mask(p, m, 0.5 * vs, grid, form=form)
        p, m = voxel.compact(p, m, cap.max_frame)
        p, m = voxel.first_in_voxel_sorted(p, m, 0.5 * vs, cap.max_frame,
                                           form=form)
        p, m = voxel.first_in_voxel_sorted(p, m, 1.5 * vs, cap.max_frame,
                                           form=form)
        return voxel.compact(p, m, cap.max_source, decimate_overflow=True)

    return [
        ("scan_to_points", lambda: scan_to_points(lut, rm, decimate=d)),
        ("deskew", lambda: deskew.deskew_by_twist(pts, ts - 0.5, twist)),
        ("range_clip", lambda: voxel.range_clip_mask(
            dsk, mask, k.min_range, k.max_range)),
        ("prededup", lambda: voxel.window_prededup_mask(
            dsk, clip, 0.5 * vs, grid, form=form)),
        ("compact", lambda: voxel.compact(dsk, pre, cap.max_frame)),
        ("first_in_voxel_0.5", lambda: voxel.first_in_voxel_sorted(
            cp, cm, 0.5 * vs, cap.max_frame, form=form)),
        ("first_in_voxel_1.5", lambda: voxel.first_in_voxel_sorted(
            f1, k1, 1.5 * vs, cap.max_frame, form=form)),
        ("source_compact", lambda: voxel.compact(
            f2, k2, cap.max_source, decimate_overflow=True)),
        ("whole", whole),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = dict(card=card, scan=SCAN, reps=REPS)
    for name in ("ouster128_bench", "ouster128_cli"):
        c, cfg = probe.config(name)
        rec, lut = probe.recording(c, probe.SEED, SCAN + 1)
        rm = torch.as_tensor(rec.scans[SCAN], dtype=torch.float32,
                             device=probe.DEV)
        for form in ("cuda", "torch"):
            us = {part: graph_us(fn) for part, fn in parts(cfg, lut, rm,
                                                            form)}
            us["sum_of_parts"] = sum(v for k, v in us.items()
                                     if k != "whole")
            out[f"{name} {form}"] = us
            print(f"{name} {form}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in us.items()) + " us", flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
