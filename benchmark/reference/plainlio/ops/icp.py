"""Robust ICP against the voxel hash map (``ptudes_tpu.ops.icp``), the
cached-candidate form both configurations run.

Gather each source point's candidates at the guess pose (top-V voxels of
its neighbourhood by representative distance) with a patch plane per
point, then run the robust Gauss-Newton loop against them, point-to-plane
(point-to-point where the patch is not planar). Two forms:

- frozen candidates (``refresh_drift == 0``): one gather, the plane fit
  in K3's twin and the whole loop in K4's (``ops.cuda_gn``,
  ``ops.cuda_icp``);
- refresh (``refresh_drift > 0``): a host loop of GN builds (K5's twin,
  ``ops.cuda_gn.gn_prepped_torch``) that re-gathers the candidates
  whenever the pose has drifted ``refresh_drift`` voxels from the pose
  they were gathered at.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3, so3
from ..geom.linalg import solve_spd6
from . import hashmap
from .hashmap import neighbor_offsets
from .plane import smallest_eigvec_sym3
from .voxel import recip, voxel_coords


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


def gather_candidates(vmap_: hashmap.VoxelHashMap, pts_w: torch.Tensor, *,
                      voxel_size: float, max_probes: int = 2,
                      neighborhood: int = 27, n_voxels: int = 4,
                      fit_planes: bool = True,
                      plane_radius: float | None = None) -> CandidateSet:
    """The ``n_voxels`` nearest neighbour voxels' decoded point lists per
    query point, ranked by representative-point distance; with
    ``fit_planes`` also the per-point patch plane fit within
    ``plane_radius`` (default 1.5 * voxel_size). ``neighborhood`` 7 or 27
    is the centre and faces or the cube; 4 is octant-directed, the centre
    and the three face neighbours on the query's side of its voxel."""
    cap = vmap_.meta.shape[0]
    ppv = vmap_.points.shape[1]
    mnum = pts_w.shape[0]
    dev = pts_w.device
    qc = voxel_coords(pts_w, voxel_size)
    if neighborhood == 4:
        frac = pts_w * recip(voxel_size) - qc.to(pts_w.dtype)
        side = torch.where(frac >= 0.5, 1, -1).to(torch.int32)  # [M, 3]
        axes = torch.eye(3, dtype=torch.int32, device=dev)
        offsets = torch.cat([torch.zeros_like(side)[:, None],
                             side[:, None, :] * axes[None]], 1)  # [M, 4, 3]
        keys = qc[:, None, :] + offsets
    elif neighborhood in (7, 27):
        keys = qc[:, None, :] + neighbor_offsets(neighborhood, dev)[None]
    else:
        raise ValueError(f"neighborhood {neighborhood} (4, 7 or 27)")
    found_slot, cnt, rep, found = hashmap.probe(
        vmap_, keys, max_probes, miss_slot=cap)

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


def gn_from_candidates(t_cur: torch.Tensor, source: torch.Tensor,
                       source_mask: torch.Tensor, cand: CandidateSet,
                       kernel: torch.Tensor, max_d2: torch.Tensor, *,
                       plane_min_quality: float, loss: str = "plane"):
    """One GN normal-equation build against fixed candidates: (jtj [6, 6],
    jtr [6], n_corr, total weight). ``loss="plane"`` takes the plane row
    where the patch fit's quality reaches ``plane_min_quality``, the point
    rows elsewhere; ``"point"`` the point rows everywhere."""
    pts_w = se3.transform(t_cur, source)
    d2 = torch.sum((cand.pts - pts_w[:, None, :]) ** 2, -1)
    d2 = torch.where(cand.valid, d2, torch.inf)
    d2min, nn = hashmap.argmin_select(d2, cand.pts)
    corr = source_mask & torch.isfinite(d2min) & (d2min <= max_d2)
    if loss == "plane":
        return _robust_system(pts_w, nn, d2min, corr, kernel, cand.normal,
                              cand.centroid, cand.quality,
                              plane_min_quality)
    return _robust_system(pts_w, nn, d2min, corr, kernel)


def _robust_system(pts_w, nn, d2min, corr, kernel, normal=None,
                   centroid=None, quality=None, plane_min_quality=0.0):
    """The robust GN system of the correspondences ``corr`` (query
    ``pts_w``, nearest point ``nn`` at squared distance ``d2min``): plane
    rows where a plane (``normal``, ``centroid``) of ``quality`` at least
    ``plane_min_quality`` is given, point rows elsewhere; weights
    kernel^2 / (kernel + r^2)^2. Returns (jtj, jtr, n_corr int32, total
    weight)."""
    n = pts_w.shape[0]
    dev = pts_w.device
    k2 = kernel * kernel
    use_point = corr
    jtj = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    jtr = torch.zeros((6,), dtype=torch.float32, device=dev)
    total_w = torch.zeros((), dtype=torch.float32, device=dev)
    if normal is not None:
        use_plane = corr & (quality >= plane_min_quality)
        s = torch.sum(normal * (pts_w - centroid), -1)
        w_pl = torch.where(use_plane, k2 / torch.square(kernel + s * s), 0.0)
        row = torch.cat([torch.linalg.cross(pts_w, normal), normal], -1)
        jtj = (row * w_pl[:, None]).T @ row
        jtr = (row * w_pl[:, None]).T @ s
        total_w = w_pl.sum()
        use_point = corr & ~use_plane

    w_pt = torch.where(use_point, k2 / torch.square(kernel + d2min), 0.0)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3)
    j = torch.cat([-so3.hat(pts_w), eye3], -1)                # [N, 3, 6]
    jw = j * w_pt[:, None, None]
    jtj = torch.einsum("nij,nik->jk", jw, j) + jtj
    jtr = torch.einsum("nij,ni->j", jw, pts_w - nn) + jtr
    return jtj, jtr, corr.sum(dtype=torch.int32), w_pt.sum() + total_w


def drift_metric(t_gather: torch.Tensor, t_cur: torch.Tensor
                 ) -> torch.Tensor:
    """Worst-case candidate staleness: translation + rotation sweep at a
    nominal 17.5 m lever arm (half a typical clip range); one per pose of
    poses [..., 4, 4]."""
    rel = se3.inv(t_gather) @ t_cur
    dt = torch.linalg.vector_norm(se3.trans(rel), dim=-1)
    theta = torch.linalg.vector_norm(so3.log_rotmat(se3.rot(rel)), dim=-1)
    return dt + theta * 0.5 * 35.0


def gn_twist(t_cur: torch.Tensor, guess_inv: torch.Tensor,
             jtj: torch.Tensor, jtr: torch.Tensor, total_w: torch.Tensor, *,
             prior_rot_weight: float, prior_trans_weight: float
             ) -> torch.Tensor:
    """The GN update twist: the motion prior toward the guess (weighted by
    the total robust weight), a 1e-8 Tikhonov floor, the 6x6 solve. Leading
    replica dimensions ([B, 4, 4] poses, [B, 6, 6] systems, [B] weights)
    solve each replica's system with the same steps."""
    dev = jtj.device
    if prior_rot_weight > 0.0 or prior_trans_weight > 0.0:
        xi = se3.log_pose(t_cur @ guess_inv)
        wp = total_w[..., None] * torch.cat([
            torch.full((3,), prior_rot_weight, dtype=torch.float32,
                       device=dev),
            torch.full((3,), prior_trans_weight, dtype=torch.float32,
                       device=dev)])
        jtj = jtj + torch.diag_embed(wp)
        jtr = jtr + wp * xi
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    return solve_spd6(jtj + 1e-8 * eye6, -jtr)


def _bools(x):
    return [_bools(v) for v in x] if isinstance(x, list) else bool(x)


def read_flags(flags: torch.Tensor) -> list:
    """The small bool tensor ``flags`` on the host: a list of bools (the
    refresh loop's one read per iteration)."""
    return _bools(flags.tolist())


def register_frame_cached(source: torch.Tensor, source_mask: torch.Tensor,
                          vmap_: hashmap.VoxelHashMap,
                          initial_guess: torch.Tensor,
                          max_distance: torch.Tensor, kernel: torch.Tensor,
                          *, voxel_size: float, max_probes: int = 2,
                          max_iterations: int = 50, convergence: float = 1e-4,
                          loss: str = "plane",
                          plane_min_quality: float = 0.2,
                          prior_rot_weight: float = 0.0,
                          prior_trans_weight: float = 0.0,
                          neighborhood: int = 27, n_voxels: int = 4,
                          plane_radius: float | None = None,
                          refresh_drift: float = 0.0) -> IcpResult:
    """Cached-candidate robust GN ICP with the plane loss.

    ``refresh_drift == 0``: the candidates gathered at the guess stay
    frozen; the candidate prep is K3's twin and the loop K4's.
    ``refresh_drift > 0``: :func:`_register_refresh`."""
    from . import cuda_gn, cuda_icp
    if loss != "plane":
        raise ValueError(f"the reference runs the plane loss, not {loss!r}")
    guess = initial_guess.to(torch.float32)
    if refresh_drift > 0.0:
        return _register_refresh(
            source, source_mask, vmap_, guess, max_distance * max_distance,
            kernel, voxel_size=voxel_size, max_probes=max_probes,
            max_iterations=max_iterations, convergence=convergence,
            plane_min_quality=plane_min_quality,
            prior_rot_weight=prior_rot_weight,
            prior_trans_weight=prior_trans_weight,
            neighborhood=neighborhood, n_voxels=n_voxels,
            plane_radius=plane_radius, refresh_drift=refresh_drift)
    r = 1.5 * voxel_size if plane_radius is None else plane_radius
    q_w = se3.transform(guess, source)
    cand = gather_candidates(
        vmap_, q_w, voxel_size=voxel_size, max_probes=max_probes,
        neighborhood=neighborhood, n_voxels=n_voxels, fit_planes=False)
    prepped = cuda_gn.prep_with_plane_torch(cand, source_mask, q_w, r)
    pose, n_corr, iters, dev_t, dev_r = cuda_icp.icp_loop_torch(
        source, prepped, guess, kernel, max_distance * max_distance,
        convergence, plane_min_quality=plane_min_quality,
        max_iterations=max_iterations, prior_rot_weight=prior_rot_weight,
        prior_trans_weight=prior_trans_weight)
    return IcpResult(pose, n_corr, iters, dev_t, dev_r)


def _register_refresh(source, source_mask, vmap_, guess, max_d2, kernel, *,
                      voxel_size, max_probes, max_iterations, convergence,
                      plane_min_quality, prior_rot_weight,
                      prior_trans_weight, neighborhood, n_voxels,
                      plane_radius, refresh_drift) -> IcpResult:
    """The refresh loop (``ptudes_tpu.ops.icp.register_frame_cached`` with
    ``refresh_drift > 0``). Per iteration: stale check; re-gather at the
    current pose if stale; one GN build (K5's twin); prior, Tikhonov
    floor, solve, SE(3) update; convergence. From the second iteration on
    it reads both predicates ("not converged", "stale") at once through
    :func:`read_flags`."""
    from . import cuda_gn
    refresh_th = refresh_drift * voxel_size

    def fetch(t_at):
        cand = gather_candidates(
            vmap_, se3.transform(t_at, source), voxel_size=voxel_size,
            max_probes=max_probes, neighborhood=neighborhood,
            n_voxels=n_voxels, fit_planes=True, plane_radius=plane_radius)
        return cuda_gn.split_rows(
            cuda_gn.lane_major_rows(cand, source_mask),
            n_voxels * vmap_.points.shape[1])

    guess_inv = se3.inv(guess)
    prepped = fetch(guess)
    t_cur = t_gather = guess
    n_corr = torch.zeros((), dtype=torch.int32, device=source.device)
    iters = 0
    while iters < max_iterations:
        if iters > 0:
            go, stale = read_flags(torch.stack([
                ~converged, drift_metric(t_gather, t_cur) > refresh_th]))
            if not go:
                break
            if stale:
                prepped = fetch(t_cur)
                t_gather = t_cur
        jtj, jtr, n_corr, total_w = cuda_gn.gn_prepped_torch(
            t_cur, source, prepped, kernel, max_d2,
            plane_min_quality=plane_min_quality)
        dx = gn_twist(t_cur, guess_inv, jtj, jtr, total_w,
                      prior_rot_weight=prior_rot_weight,
                      prior_trans_weight=prior_trans_weight)
        t_cur = se3.exp_twist(dx) @ t_cur
        converged = torch.linalg.vector_norm(dx) < convergence
        iters += 1
    dev_pose = guess_inv @ t_cur
    return IcpResult(
        t_cur, n_corr,
        torch.full((), iters, dtype=torch.int32, device=source.device),
        torch.linalg.vector_norm(se3.trans(dev_pose)),
        torch.linalg.vector_norm(so3.log_rotmat(se3.rot(dev_pose))))
