"""Robust ICP against the voxel hash map, frozen-candidate form
(``ptudes_tpu.ops.icp``).

Per registration: gather each source point's candidates ONCE at the guess
pose (top-V voxels of its neighbourhood by representative distance), fit a
patch plane per point (K3, ``ops.cuda_gn``), then run the whole robust
point-to-plane / point-to-point Gauss-Newton loop against the frozen
candidates (K4, ``ops.cuda_icp``). ``KissConfig.icp_form`` says whether the
two kernels or their plain PyTorch twins run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3, so3
from . import hashmap
from .plane import smallest_eigvec_sym3
from .voxel import voxel_coords


class IcpResult(NamedTuple):
    pose: torch.Tensor        # [4, 4]
    num_corr: torch.Tensor    # [] int32, correspondences of the last step
    iterations: torch.Tensor  # [] int32
    dev_t: torch.Tensor       # [] |trans(guess^-1 pose)|
    dev_r: torch.Tensor       # [] |log rot(guess^-1 pose)|


class CandidateSet(NamedTuple):
    pts: torch.Tensor       # [M, V*P, 3]
    valid: torch.Tensor     # [M, V*P] bool
    normal: torch.Tensor    # [M, 3] patch plane normal
    centroid: torch.Tensor  # [M, 3]
    quality: torch.Tensor   # [M] planarity in [0, 1]


def neighbor_offsets(n: int, device) -> torch.Tensor:
    """The first ``n`` voxel neighbour offsets ordered by L1 norm (centre,
    6 faces, 12 edges, 8 corners; ``ptudes_tpu.ops.hashmap``'s order),
    built on ``device``: a host tensor copied in would synchronise the
    scan step."""
    g = torch.arange(27, device=device)
    o = torch.stack([g // 9 - 1, g // 3 % 3 - 1, g % 3 - 1], 1)
    order = torch.sort(o.abs().sum(1), stable=True).indices
    return o[order[:n]].to(torch.int32)


def gather_candidates(vmap_: hashmap.VoxelHashMap, pts_w: torch.Tensor, *,
                      voxel_size: float, max_probes: int = 2,
                      neighborhood: int = 27, n_voxels: int = 4,
                      fit_planes: bool = True,
                      plane_radius: float | None = None) -> CandidateSet:
    """The ``n_voxels`` nearest neighbour voxels' decoded point lists per
    query point, ranked by representative-point distance; with
    ``fit_planes`` also the per-point patch plane fit within
    ``plane_radius`` (default 1.5 * voxel_size)."""
    if neighborhood not in (7, 27):
        raise NotImplementedError(
            f"neighborhood={neighborhood} is not ported; see ROADMAP.md")
    cap = vmap_.meta.shape[0]
    ppv = vmap_.points.shape[1]
    mnum = pts_w.shape[0]
    dev = pts_w.device
    qc = voxel_coords(pts_w, voxel_size)
    keys = qc[:, None, :] + neighbor_offsets(neighborhood, dev)[None]
    fp, h0 = hashmap._fingerprint_and_slot(keys, cap)

    found_slot = torch.full((mnum, neighborhood), cap, dtype=torch.int32,
                            device=dev)
    found = torch.zeros((mnum, neighborhood), dtype=torch.bool, device=dev)
    cnt = torch.zeros((mnum, neighborhood), dtype=torch.int32, device=dev)
    rep = torch.zeros((mnum, neighborhood, 3), dtype=torch.float32,
                      device=dev)
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        rows = vmap_.meta[s.long()]
        match = (rows[..., 0] == fp) & ~found
        found_slot = torch.where(match, s, found_slot)
        cnt = torch.where(match, rows[..., 1], cnt)
        rep = torch.where(match[..., None],
                          rows[..., 2:5].contiguous().view(torch.float32),
                          rep)
        found = found | match

    d = torch.where(found, torch.sum((rep - pts_w[:, None, :]) ** 2, -1),
                    torch.inf)
    sel_slot, sel_cnt, sel_rep = [], [], []
    for _ in range(n_voxels):
        j = torch.argmin(d, -1, keepdim=True)                 # [M, 1]
        ok = torch.isfinite(d.gather(1, j))[:, 0]
        sel_slot.append(found_slot.gather(1, j)[:, 0])
        sel_cnt.append(torch.where(ok, cnt.gather(1, j)[:, 0], 0))
        sel_rep.append(rep.gather(1, j[..., None].expand(mnum, 1, 3))[:, 0])
        d = d.scatter(1, j, torch.inf)
    slot_v = torch.stack(sel_slot, 1)                         # [M, V]
    cnt_v = torch.stack(sel_cnt, 1)
    rep_v = torch.stack(sel_rep, 1)                           # [M, V, 3]

    packed = hashmap.gather_rows(vmap_.points, slot_v)        # [M, V, P]
    vox_pts = hashmap.unpack_points(
        packed, voxel_coords(rep_v, voxel_size)[:, :, None, :], voxel_size)
    valid = (torch.arange(ppv, device=dev)[None, None, :]
             < cnt_v[:, :, None])
    cpts = vox_pts.reshape(mnum, n_voxels * ppv, 3)
    cvalid = valid.reshape(mnum, n_voxels * ppv)

    if fit_planes:
        r = 1.5 * voxel_size if plane_radius is None else plane_radius
        d2g = torch.sum((cpts - pts_w[:, None, :]) ** 2, -1)
        w = (cvalid & (d2g <= r * r)).to(torch.float32)
        n_in = w.sum(-1)
        denom = torch.clamp(n_in, min=1.0)
        centroid = (cpts * w[..., None]).sum(1) / denom[:, None]
        dd = (cpts - centroid[:, None, :]) * w[..., None]
        cov = torch.einsum("mpi,mpj->mij", dd, dd) / denom[:, None, None]
        normal, quality = smallest_eigvec_sym3(cov)
        quality = torch.where(n_in >= 4, quality, 0.0)
    else:
        normal = torch.zeros((mnum, 3), dtype=torch.float32, device=dev)
        centroid = torch.zeros((mnum, 3), dtype=torch.float32, device=dev)
        quality = torch.zeros((mnum,), dtype=torch.float32, device=dev)
    return CandidateSet(cpts, cvalid, normal, centroid, quality)


def _argmin_select(d2: torch.Tensor, pts3: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min over the candidate axis, the point at its first argmin)."""
    dmin, j = torch.min(d2, -1, keepdim=True)
    nn = pts3.gather(1, j[..., None].expand(-1, 1, 3))[:, 0]
    return dmin[:, 0], nn


def gn_from_candidates(t_cur: torch.Tensor, source: torch.Tensor,
                       source_mask: torch.Tensor, cand: CandidateSet,
                       kernel: torch.Tensor, max_d2: torch.Tensor, *,
                       plane_min_quality: float):
    """One GN normal-equation build against fixed candidates, plane loss:
    (jtj [6, 6], jtr [6], n_corr, total weight)."""
    n = source.shape[0]
    dev = source.device
    pts_w = se3.transform(t_cur, source)
    d2 = torch.sum((cand.pts - pts_w[:, None, :]) ** 2, -1)
    d2 = torch.where(cand.valid, d2, torch.inf)
    d2min, nn = _argmin_select(d2, cand.pts)
    corr = source_mask & torch.isfinite(d2min) & (d2min <= max_d2)
    r_vec = pts_w - nn
    k2 = kernel * kernel

    use_plane = corr & (cand.quality >= plane_min_quality)
    s = torch.sum(cand.normal * (pts_w - cand.centroid), -1)
    w_pl = torch.where(use_plane, k2 / torch.square(kernel + s * s), 0.0)
    row = torch.cat([torch.linalg.cross(pts_w, cand.normal), cand.normal], -1)
    jtj_pl = (row * w_pl[:, None]).T @ row
    jtr_pl = (row * w_pl[:, None]).T @ s
    use_point = corr & ~use_plane

    w_pt = torch.where(use_point, k2 / torch.square(kernel + d2min), 0.0)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3)
    j = torch.cat([-so3.hat(pts_w), eye3], -1)                # [N, 3, 6]
    jw = j * w_pt[:, None, None]
    jtj = torch.einsum("nij,nik->jk", jw, j) + jtj_pl
    jtr = torch.einsum("nij,ni->j", jw, r_vec) + jtr_pl
    return jtj, jtr, corr.to(torch.int32).sum(), w_pt.sum() + w_pl.sum()


def register_frame_cached(source: torch.Tensor, source_mask: torch.Tensor,
                          vmap_: hashmap.VoxelHashMap,
                          initial_guess: torch.Tensor,
                          max_distance: torch.Tensor, kernel: torch.Tensor,
                          *, voxel_size: float, max_probes: int = 2,
                          max_iterations: int = 50, convergence: float = 1e-4,
                          plane_min_quality: float = 0.2,
                          prior_rot_weight: float = 0.0,
                          prior_trans_weight: float = 0.0,
                          neighborhood: int = 27, n_voxels: int = 4,
                          plane_radius: float | None = None,
                          form: str = "torch") -> IcpResult:
    """Gather-once robust GN ICP with frozen candidates, plane loss.

    ``form="cuda"``: the candidate prep (K3) and the loop (K4) run through
    their kernel wrappers (which take the twins for CPU tensors);
    ``"torch"``: the twins on any device."""
    from . import cuda_gn, cuda_icp
    if form not in ("cuda", "torch"):
        raise ValueError(f"unknown icp form {form!r}")
    guess = initial_guess.to(torch.float32)
    q_w = se3.transform(guess, source)
    cand = gather_candidates(
        vmap_, q_w, voxel_size=voxel_size, max_probes=max_probes,
        neighborhood=neighborhood, n_voxels=n_voxels, fit_planes=False)
    r = 1.5 * voxel_size if plane_radius is None else plane_radius
    prep = (cuda_gn.prep_with_plane if form == "cuda"
            else cuda_gn.prep_with_plane_torch)
    prepped = prep(cand, source_mask, q_w, r)
    loop = cuda_icp.icp_loop if form == "cuda" else cuda_icp.icp_loop_torch
    pose, n_corr, iters, dev_t, dev_r = loop(
        source, prepped, guess, kernel, max_distance * max_distance,
        convergence, plane_min_quality=plane_min_quality,
        max_iterations=max_iterations, prior_rot_weight=prior_rot_weight,
        prior_trans_weight=prior_trans_weight)
    return IcpResult(pose, n_corr, iters, dev_t, dev_r)
