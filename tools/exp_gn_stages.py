"""Where the device time of K4 (``csrc/icp_loop.cu``) and K5
(``csrc/gn_iter.cu``) goes, on one CUDA card: each kernel rebuilt with
stages taken out, timed with ``torch.profiler`` at the shapes phase 3 of
``chip_smoke.py`` uses.

    python3 tools/exp_gn_stages.py

Each variant is the committed source built by ``nvcc`` into a temporary
directory with ``-DPTUDES_SKIP=<mask>``, the stage mask of
``csrc/common.cuh`` (``ptudes::Stage``):

- K5 at N = 8192, C = 80 (``cli_gn_scene``): as committed; without the
  nearest-neighbour scan; without the moments; without the last-CTA sum;
  with none of the three.
- K4 at N = 2048, C = 32 (``icp_scene``), staged and streamed, 1, 10 and
  20 iterations (convergence off), then at 10 iterations without the
  nearest-neighbour scan, the moments, the cluster barrier and peer reads,
  the solve, or all four. A removed stage changes the numbers the later
  ones see (a zero system solves differently), so read the differences as
  rough shares.
- K4's other row split (``kSwapGroups``): two warps a point staged at the
  bench shapes (10 iterations), one warp a point streamed at the CLI
  shapes (5 iterations), each beside the committed split at the same
  shape.

Prints one line per variant: mean device us per launch over 50 launches.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "ptudes_tpu_torch", "csrc")

# the bits of csrc/common.cuh:ptudes::Stage
NEAREST, MOMENTS, TAIL, CLUSTER, SOLVE, SWAP_GROUPS = 1, 2, 4, 8, 16, 32

K5_VARIANTS = {"as committed": 0, "no NN scan": NEAREST,
               "no moments": MOMENTS, "no last-CTA sum": TAIL,
               "none of the three": NEAREST | MOMENTS | TAIL}
K4_VARIANTS = {"as committed": 0, "no NN scan": NEAREST,
               "no moments": MOMENTS, "no cluster barrier": CLUSTER,
               "no solve": SOLVE,
               "none of the four": NEAREST | MOMENTS | CLUSTER | SOLVE,
               "other row split": SWAP_GROUPS}


def build_all(out_dir: str):
    """Every variant as its own library, compiled in parallel; returns
    {(kernel, variant): entry point}."""
    from ptudes_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    jobs = {}
    for kern, variants in (("gn_iter", K5_VARIANTS),
                           ("icp_loop", K4_VARIANTS)):
        for v, mask in variants.items():
            lib = os.path.join(out_dir, f"{kern}_{mask}.so")
            cmd = [nvcc, *kernels.NVCC_FLAGS[:6], f"-DPTUDES_SKIP={mask}",
                   "-shared", "-o", lib, os.path.join(CSRC, f"{kern}.cu")]
            jobs[(kern, v)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns = {}
    for (kern, v), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {kern} ({v}):\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(lib), f"ptudes_{kern}")
        fn.argtypes = kernels._SIGNATURES[f"ptudes_{kern}"]
        fn.restype = ctypes.c_int
        fns[(kern, v)] = fn
    return fns


def device_us(call, reps: int = 50) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler can drop records: profile again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        ds = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "_kernel" in e.name]
        if len(ds) == reps:
            return float(np.mean(ds))
    raise SystemExit(f"{len(ds)} kernels timed in {reps} launches")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("exp_gn_stages: no CUDA device")
    import chip_smoke as cs
    from ptudes_tpu_torch.geom import se3
    from ptudes_tpu_torch.ops import cuda_gn, cuda_icp, icp

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(tmp)
        stream = torch.cuda.current_stream().cuda_stream

        def ptrs(*ts):
            return [t.data_ptr() for t in ts]

        t, src, mask, cand = cs.cli_gn_scene(dev)
        pp = cuda_gn.prep_candidates(cand, mask)
        c, n = pp.cx.shape
        scal = torch.cat([torch.tensor([0.1667, 2.25], device=dev),
                          t[:3].reshape(12)]).float()
        partial = torch.empty(cuda_gn.gn_plan(n, c).blocks * 45, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty(44, device=dev)
        for v in K5_VARIANTS:
            fn = fns[("gn_iter", v)]
            ticket.zero_()
            args = ptrs(src, *pp, scal, partial, ticket, out)

            def k5(fn=fn, args=args):
                # no replica mask, one replica, no replica stride
                if fn(*args, None, n, c, 0.2, 1, 0, stream) != 0:
                    raise SystemExit("gn_iter launch failed")
            print(f"K5 N={n} C={c} {v}: {device_us(k5):.2f} us", flush=True)

        def k4_us(v, s3, prepped, scal4, iters, staged):
            """K4 variant ``v`` at ``iters`` iterations (conv2 = 0)."""
            c4, n4 = prepped.cx.shape
            plan = cuda_icp.loop_plan(n4, c4)
            fn = fns[("icp_loop", v)]
            args = ptrs(s3, *prepped, scal4, torch.empty(20, device=dev))

            def k4():
                if fn(*args, n4, c4, 0.2, 0.0, 0.01, 0.01, iters,
                      plan.cluster, plan.points_per_cta, int(staged), 1, 0,
                      stream) != 0:
                    raise SystemExit("icp_loop launch failed")
            kind = "staged" if staged else "streamed"
            print(f"K4 N={n4} C={c4} {kind} {iters} iterations {v}: "
                  f"{device_us(k4):.2f} us", flush=True)

        m, src4, mask4, guess = cs.icp_scene(dev)
        q_w = se3.transform(guess, src4)
        cand4 = icp.gather_candidates(m, q_w, voxel_size=0.3, max_probes=2,
                                      neighborhood=7, n_voxels=4,
                                      fit_planes=False)
        pp4 = cuda_gn.prep_with_plane(cand4, mask4, q_w, 0.6)
        s3 = src4.T.contiguous()
        scal4 = torch.cat([torch.tensor([0.1667, 0.25], device=dev),
                           guess[:3].reshape(12)]).float()
        for iters in (1, 10, 20):
            for staged in (True, False):
                k4_us("as committed", s3, pp4, scal4, iters, staged)
        for v in K4_VARIANTS:
            if v != "as committed":
                k4_us(v, s3, pp4, scal4, 10, True)
        # the row split at the CLI shapes, where loop_plan streams
        s3_cli = src.T.contiguous()
        for v in ("as committed", "other row split"):
            k4_us(v, s3_cli, pp, scal, 5, False)


if __name__ == "__main__":
    main()
