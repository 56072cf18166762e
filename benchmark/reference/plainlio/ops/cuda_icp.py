"""K4's plain twin: the whole frozen-candidate robust GN ICP loop
(``ptudes_tpu_torch.ops.cuda_icp.icp_loop_torch``, the kernel
``csrc/icp_loop.cu``'s twin).

It returns ``(pose [4, 4], n_corr, iters, dev_t, dev_r)``: the refined
pose, the last step's correspondence count, the iteration count, and |t| /
|log R| of ``guess^-1 pose`` (the adaptive threshold's model deviation).
"""
from __future__ import annotations

import torch

from ..geom import se3, so3
from .cuda_gn import PreppedCandidates, candidates_from_prepped
from .icp import gn_from_candidates, gn_twist


def icp_loop_torch(source: torch.Tensor, prepped: PreppedCandidates,
                   guess: torch.Tensor, kernel: torch.Tensor,
                   max_d2: torch.Tensor, convergence: float, *,
                   plane_min_quality: float, max_iterations: int,
                   prior_rot_weight: float, prior_trans_weight: float):
    """K4's plain twin: ``max_iterations`` GN steps, each masked once
    converged, so the step count never depends on data (no host sync)."""
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


