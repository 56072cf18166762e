"""K4: the whole frozen-candidate robust GN ICP loop in one launch
(``csrc/icp_loop.cu``), the counterpart of
``ptudes_tpu.ops.pallas_icp.icp_loop_pallas``.

Both forms return ``(pose [4, 4], n_corr, iters, dev_t, dev_r)``: the
refined pose, the last step's correspondence count, the iteration count,
and |t| / |log R| of ``guess^-1 pose`` (the adaptive threshold's model
deviation).

The kernel runs as one thread-block cluster whose CTAs split the source
points; :func:`loop_plan` picks its shape from ``(n, c)`` alone: the
staged variant when a CTA's slice of the candidate, feat and source rows
fits in shared memory, the streamed one (rows read from device memory
every iteration) otherwise. Both are the same hand-written kernel.

With a leading replica axis (the batched driver's B registrations: source
[B, N, 3], prepped rows [B, ., N], guesses [B, 4, 4], kernel widths and
max_d2 [B]) one launch runs B clusters, one a replica, each with its own
iteration count and exit; the twin runs replica by replica.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..geom import se3, so3
from .cuda_gn import (PreppedCandidates, candidates_from_prepped,
                      prepped_rows)
from .icp import gn_from_candidates, gn_twist
from ..utils.replicas import per_replica

_F32 = torch.float32
CLUSTER = 8           # CTAs a registration runs on (the portable maximum)
PASS_POINTS = 256     # points a CTA covers per pass (csrc: kPass)
SMEM_PER_CTA = 232448  # shared memory a CTA may use on sm_90
STATIC_SMEM = 8192    # kept for the kernel's static shared arrays
SIDE_ROWS = 11        # feat (8) and source (3) rows staged beside the C x 4


class LoopPlan(NamedTuple):
    cluster: int          # CTAs in the cluster
    points_per_cta: int   # CTA r owns points [r * ppc, (r + 1) * ppc)
    smem_bytes: int       # dynamic shared memory per CTA (staged slice)
    staged: bool

    def ranges(self, n: int) -> list[tuple[int, int]]:
        """(start, count) of each CTA's points; the counts sum to n."""
        ppc = self.points_per_cta
        return [(r * ppc, max(0, min(ppc, n - r * ppc)))
                for r in range(self.cluster)]


def loop_plan(n: int, c: int) -> LoopPlan:
    """K4's launch shape for ``n`` source points and ``c`` candidate rows:
    ``CLUSTER`` CTAs, each owning a contiguous slice of ceil(n / CLUSTER)
    points rounded up to a multiple of 4 (16-byte row segments for the
    bulk copies). Staged iff the slice's (4c + 11) rows fit in shared
    memory beside the static arrays (the kernel's ``launch_loop`` sizes the
    same bytes). The kernel scans a point's rows with one warp when staged
    and with two, each over half the rows, when streamed
    (``icp_loop.cu:loop_groups``)."""
    if n <= 0 or c <= 0:
        raise ValueError(f"loop_plan: n {n}, c {c}")
    ppc = -(-n // CLUSTER)
    ppc = -(-ppc // 4) * 4
    slice_bytes = (4 * c + SIDE_ROWS) * ppc * 4
    staged = slice_bytes + STATIC_SMEM <= SMEM_PER_CTA
    return LoopPlan(CLUSTER, ppc, slice_bytes if staged else 0, staged)


def icp_loop_torch(source: torch.Tensor, prepped: PreppedCandidates,
                   guess: torch.Tensor, kernel: torch.Tensor,
                   max_d2: torch.Tensor, convergence: float, *,
                   plane_min_quality: float, max_iterations: int,
                   prior_rot_weight: float, prior_trans_weight: float):
    """K4's plain twin: ``max_iterations`` GN steps, each masked once
    converged, so the step count never depends on data (no host sync)."""
    if source.dim() == 3:
        return per_replica(
            icp_loop_torch, source.shape[0], source, prepped, guess, kernel,
            max_d2, convergence=convergence,
            plane_min_quality=plane_min_quality,
            max_iterations=max_iterations, prior_rot_weight=prior_rot_weight,
            prior_trans_weight=prior_trans_weight)
    dev = source.device
    cand, mask = candidates_from_prepped(prepped)
    ginv = se3.inv(guess)
    t_cur = guess
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iterations):
        jtj, jtr, corr_n, total_w = gn_from_candidates(
            t_cur, source, mask, cand, kernel, max_d2,
            plane_min_quality=plane_min_quality)
        dx = gn_twist(t_cur, ginv, jtj, jtr, total_w,
                      prior_rot_weight=prior_rot_weight,
                      prior_trans_weight=prior_trans_weight)
        dx = torch.where(conv, 0.0, dx)
        t_cur = se3.exp_twist(dx) @ t_cur
        iters = torch.where(conv, iters, iters + 1)
        n_corr = torch.where(conv, n_corr, corr_n)
        conv = conv | (torch.linalg.vector_norm(dx) < convergence)
    dev_pose = ginv @ t_cur
    return (t_cur, n_corr, iters,
            torch.linalg.vector_norm(se3.trans(dev_pose)),
            torch.linalg.vector_norm(so3.log_rotmat(se3.rot(dev_pose))))


def icp_loop(source: torch.Tensor, prepped: PreppedCandidates,
             guess: torch.Tensor, kernel: torch.Tensor, max_d2: torch.Tensor,
             convergence: float, *, plane_min_quality: float,
             max_iterations: int, prior_rot_weight: float,
             prior_trans_weight: float):
    """K4: CUDA tensors launch ``icp_loop`` shaped by :func:`loop_plan`;
    CPU tensors take the twin."""
    if kernels.device_kind(source, "icp_loop") == "cpu":
        return icp_loop_torch(
            source, prepped, guess, kernel, max_d2, convergence,
            plane_min_quality=plane_min_quality,
            max_iterations=max_iterations,
            prior_rot_weight=prior_rot_weight,
            prior_trans_weight=prior_trans_weight)
    lead, (c, n) = source.shape[:-2], prepped.cx.shape[-2:]
    if source.shape != lead + (n, 3) or len(lead) > 1 \
            or prepped.feat.shape != lead + (8, n) \
            or any(x.shape != lead + (c, n) for x in prepped[2:]):
        raise ValueError(
            f"icp_loop: source {tuple(source.shape)}, feat "
            f"{tuple(prepped.feat.shape)}, candidates {c} x {n}")
    plan = loop_plan(n, c)
    src = source.to(_F32).transpose(-1, -2).contiguous()       # [..., 3, N]
    scal = torch.cat([kernel.reshape(lead + (1,)),
                      max_d2.reshape(lead + (1,)),
                      guess[..., :3, :].reshape(lead + (12,))], -1) \
        .to(_F32).contiguous()
    out = torch.empty(lead + (20,), dtype=_F32, device=source.device)
    rows, stride = prepped_rows(prepped, lead)
    conv = np.float32(convergence)
    kernels.launch(
        "icp_loop", kernels.ptr(src, "src"), *rows,
        kernels.ptr(scal, "scal"), kernels.ptr(out, "out"), n, c,
        plane_min_quality, float(conv * conv), prior_rot_weight,
        prior_trans_weight, max_iterations, plan.cluster,
        plan.points_per_cta, int(plan.staged), int(lead[0]) if lead else 1,
        stride)
    return (out[..., :16].reshape(lead + (4, 4)),
            out[..., 16].to(torch.int32), out[..., 17].to(torch.int32),
            out[..., 18], out[..., 19])

