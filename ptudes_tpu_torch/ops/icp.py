"""Robust ICP against the voxel hash map (``ptudes_tpu.ops.icp``).

Cached candidates (``nn_mode="cached"``, :func:`register_frame_cached`):
gather each source point's candidates at the guess pose (top-V voxels of
its neighbourhood by representative distance) with a patch plane per
point, then run the robust Gauss-Newton loop against them, point-to-plane
(``loss="plane"``, point-to-point where the patch is not planar) or
point-to-point (``loss="point"``). Two forms:

- frozen candidates (``refresh_drift == 0``): one gather, the plane fit in
  K3 and the whole loop in K4 (``ops.cuda_gn``, ``ops.cuda_icp``); with
  ``fused_gather`` the gather and the plane fit are K6's one launch
  (``ops.cuda_gather``) instead;
- refresh (``refresh_drift > 0``): a host loop of GN builds (K5,
  ``ops.cuda_gn.gn_prepped``) that re-gathers the candidates whenever the
  pose has drifted ``refresh_drift`` voxels from the pose they were
  gathered at.

Point-sharded across ranks (``group``, a ``torch.distributed`` process
group: ``parallel.sharded``), each rank registers its slice of the source
and the GN system is all-reduced once a GN iteration: the frozen form
preps once (K3, or K6) and runs a loop of K5 builds instead of K4, which
cannot reduce across ranks; the refresh form adds the all-reduce after
its K5 build.

Both forms also run B registrations against a flat B-map table in the
launches of one (:func:`register_frames_cached_batched`,
:func:`register_frames_refresh_batched`: the batched driver's).

``KissConfig.icp_form`` says whether the kernels or their plain PyTorch
twins run.

A map query every iteration (``nn_mode="every"``, :func:`register_frame`):
kiss-icp's own registration, ``hashmap.query`` at the current pose each GN
iteration, the plane fitted per matched voxel. The JAX package has no
kernel on this path; here it is plain torch with one host read a GN
iteration (:func:`read_flags`) for the early exit.

Inside a graph runner's step (``models.graph.conditional_form()``) the
refresh loops, the point-sharded loops (refresh and frozen) and the
every-iteration loop take their graph forms: the loop's carry in tensors
allocated before it and updated in place, the iteration count on the
card, the loop a WHILE node on JAX's predicate and the re-gather an IF
node on the stale test (``models.graph.while_node``, ``if_node``), the
sharded all-reduce inside the WHILE body, so no step reads the card from
the host. Each runs the eager loop's ops in its order, so both forms give
the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..geom import se3, so3
from ..geom.linalg import solve_spd6
from ..models import graph
from . import hashmap
from .hashmap import neighbor_offsets
from .plane import smallest_eigvec_sym3, voxel_plane
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
                      plane_radius: float | None = None,
                      slot_base: torch.Tensor | None = None,
                      logical_capacity: int | None = None) -> CandidateSet:
    """The ``n_voxels`` nearest neighbour voxels' decoded point lists per
    query point, ranked by representative-point distance; with
    ``fit_planes`` also the per-point patch plane fit within
    ``plane_radius`` (default 1.5 * voxel_size). ``neighborhood`` 7 or 27
    is the centre and faces or the cube; 4 is octant-directed, the centre
    and the three face neighbours on the query's side of its voxel.

    ``slot_base`` / ``logical_capacity``: a flat B-map table
    (``hashmap.create_batched``): keys hash with the logical capacity and
    every probe adds the slot base, a scalar or one per query point [M]
    (the batched driver gathers all replicas' points in one call)."""
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
    if slot_base is not None and slot_base.dim() == 1:
        slot_base = slot_base[:, None]
    found_slot, cnt, rep, found = hashmap.probe(
        vmap_, keys, max_probes, miss_slot=cap, slot_base=slot_base,
        logical_capacity=logical_capacity)

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


# the refresh loop's device-to-host reads (read_flags), re-gathers and,
# point-sharded, all-reduces of the GN system (all_reduce_system) since the
# last reset_refresh_counts(); a graph's re-gathers and all-reduces are
# counted on the card and added by models.graph after its run
REFRESH_COUNTS = {"host_reads": 0, "regathers": 0, "allreduces": 0}


def reset_refresh_counts() -> None:
    for k in REFRESH_COUNTS:
        REFRESH_COUNTS[k] = 0


def _bools(x):
    return [_bools(v) for v in x] if isinstance(x, list) else bool(x)


def read_flags(flags: torch.Tensor) -> list:
    """Copy the small bool tensor ``flags`` to the host and count the read:
    a list of bools, or of lists of them for a [B, k] tensor.

    On a CUDA tensor this synchronises with the card: it is the refresh
    loop's one read per iteration, and the one place that lifts
    ``torch.cuda.set_sync_debug_mode("error")`` (restored on return)."""
    REFRESH_COUNTS["host_reads"] += 1
    if flags.device.type != "cuda":
        return _bools(flags.tolist())
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return _bools(flags.tolist())
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def all_reduce_system(jtj: torch.Tensor, jtr: torch.Tensor,
                      n_corr: torch.Tensor, total_w: torch.Tensor, group):
    """The sum over the ranks of ``group`` of one GN build (jtj [6, 6], jtr
    [6], n_corr int32, total weight) as ONE all-reduce of a packed f32
    [36 + 6 + 1 + 1] buffer (the JAX package's four ``psum``s,
    ``ptudes_tpu/ops/icp.py:479-484``). The count travels as f32, exact
    below 2^24, and comes back int32. Every rank gets the same bits.
    Counted in ``REFRESH_COUNTS["allreduces"]``; in a graph runner's step
    on the card (``models.graph.count``), once each time the body that
    holds it runs."""
    buf = torch.cat([jtj.reshape(36), jtr, n_corr.to(torch.float32)[None],
                     total_w.reshape(1)])
    dist.all_reduce(buf, group=group)
    if graph.conditional_form():
        graph.count("allreduces", 1)
    else:
        REFRESH_COUNTS["allreduces"] += 1
    return (buf[:36].reshape(6, 6), buf[36:42], buf[42].to(torch.int32),
            buf[43])


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
                          refresh_drift: float = 0.0,
                          fused_gather: bool = False,
                          form: str = "torch",
                          slot_base: torch.Tensor | None = None,
                          logical_capacity: int | None = None,
                          group=None) -> IcpResult:
    """Cached-candidate robust GN ICP, ``loss`` "plane" or "point".

    ``refresh_drift == 0``: the candidates gathered at the guess stay
    frozen; ``form="cuda"`` runs the candidate prep (K3) and the loop (K4)
    through their kernel wrappers (which take the twins for CPU tensors),
    ``"torch"`` the twins on any device. ``fused_gather``: the gather and
    the prep are K6 (``cuda_gather.gather_prep_fused``, or its twin for
    ``"torch"``) instead of :func:`gather_candidates` and K3, for the 7-
    and 27-neighbourhoods; the octant neighbourhood (4) keeps the gather
    and K3 with ``fused_gather`` too, as the JAX package routes it
    (``ptudes_tpu/ops/icp.py:405-407``), so K6 does not launch there.
    With ``loss="point"`` K3 and K6 skip the patch fit.
    ``refresh_drift > 0``: :func:`_register_refresh`, which always gathers
    with :func:`gather_candidates` (``fused_gather`` has no effect there,
    as in the JAX package).

    ``slot_base`` / ``logical_capacity``: ``vmap_`` is a flat B-map table
    and the candidates come from this replica's slots
    (:func:`gather_candidates`). K6 probes the whole table, so with a slot
    base ``fused_gather`` takes the gather and K3 instead
    (``ptudes_tpu/ops/icp.py:406-408``). A ``logical_capacity`` without a
    slot base raises ``ValueError`` where K6 would run: K6 hashes with the
    table's physical capacity, so it would find other slots than the
    gather.

    ``group`` (a ``torch.distributed`` process group; None: no sharding):
    ``source`` and ``source_mask`` are this rank's shard of the source,
    the map and the guess are the same on every rank, and each GN build is
    summed over the ranks by :func:`all_reduce_system` before the solve,
    so every rank returns the same result. The frozen form then preps
    once as above (K6 or K3) and runs :func:`_register_refresh`'s loop
    without its re-gather: K5 (``cuda_gn.gn_prepped``) a GN iteration,
    never K4, which cannot reduce across ranks (as the JAX package routes
    it, ``ptudes_tpu/ops/icp.py:365-377``); a host loop eagerly, a WHILE
    node with the all-reduce in its body in a graph runner's step."""
    from . import cuda_gather, cuda_gn, cuda_icp
    if form not in ("cuda", "torch"):
        raise ValueError(f"unknown icp form {form!r}")
    if loss not in ("plane", "point"):
        raise ValueError(f"unknown loss {loss!r}")
    fused = (fused_gather and neighborhood in (7, 27) and slot_base is None
             and refresh_drift <= 0.0)
    if fused and logical_capacity is not None:
        raise ValueError(
            "fused_gather with logical_capacity and no slot_base: the fused "
            "gather (K6) hashes with the physical capacity; pass the "
            "replica's slot_base, or fused_gather=False")
    guess = initial_guess.to(torch.float32)
    if refresh_drift > 0.0:
        return _register_refresh(
            source, source_mask, vmap_, guess, max_distance * max_distance,
            kernel, voxel_size=voxel_size, max_probes=max_probes,
            max_iterations=max_iterations, convergence=convergence,
            loss=loss, plane_min_quality=plane_min_quality,
            prior_rot_weight=prior_rot_weight,
            prior_trans_weight=prior_trans_weight,
            neighborhood=neighborhood, n_voxels=n_voxels,
            plane_radius=plane_radius, refresh_drift=refresh_drift,
            form=form, slot_base=slot_base,
            logical_capacity=logical_capacity, group=group)
    r = 1.5 * voxel_size if plane_radius is None else plane_radius
    if fused:
        fuse = (cuda_gather.gather_prep_fused if form == "cuda"
                else cuda_gather.gather_prep_fused_torch)
        prepped = fuse(vmap_, source, source_mask, guess,
                        voxel_size=voxel_size, max_probes=max_probes,
                        neighborhood=neighborhood, n_voxels=n_voxels,
                        plane_radius=r, loss=loss)
    else:
        q_w = se3.transform(guess, source)
        cand = gather_candidates(
            vmap_, q_w, voxel_size=voxel_size, max_probes=max_probes,
            neighborhood=neighborhood, n_voxels=n_voxels, fit_planes=False,
            slot_base=slot_base, logical_capacity=logical_capacity)
        prep = (cuda_gn.prep_with_plane if form == "cuda"
                else cuda_gn.prep_with_plane_torch)
        prepped = prep(cand, source_mask, q_w, r, loss=loss)
    if group is not None:
        return _register_refresh(
            source, source_mask, vmap_, guess, max_distance * max_distance,
            kernel, voxel_size=voxel_size, max_probes=max_probes,
            max_iterations=max_iterations, convergence=convergence,
            loss=loss, plane_min_quality=plane_min_quality,
            prior_rot_weight=prior_rot_weight,
            prior_trans_weight=prior_trans_weight,
            neighborhood=neighborhood, n_voxels=n_voxels,
            plane_radius=plane_radius, refresh_drift=0.0, form=form,
            group=group, prepped=prepped)
    loop = cuda_icp.icp_loop if form == "cuda" else cuda_icp.icp_loop_torch
    pose, n_corr, iters, dev_t, dev_r = loop(
        source, prepped, guess, kernel, max_distance * max_distance,
        convergence, plane_min_quality=plane_min_quality,
        max_iterations=max_iterations, prior_rot_weight=prior_rot_weight,
        prior_trans_weight=prior_trans_weight)
    return IcpResult(pose, n_corr, iters, dev_t, dev_r)


def register_frames_cached_batched(
        source: torch.Tensor, source_mask: torch.Tensor,
        vmap_: hashmap.VoxelHashMap, initial_guess: torch.Tensor,
        max_distance: torch.Tensor, kernel: torch.Tensor, *,
        slot_base: torch.Tensor, logical_capacity: int, voxel_size: float,
        max_probes: int, max_iterations: int, convergence: float,
        loss: str, plane_min_quality: float, prior_rot_weight: float,
        prior_trans_weight: float, neighborhood: int, n_voxels: int,
        plane_radius: float | None, form: str) -> IcpResult:
    """B registrations with frozen candidates in the launches of one:
    ``source`` [B, M, 3], ``source_mask`` [B, M], guesses [B, 4, 4],
    ``max_distance`` and ``kernel`` [B], against replica b's slots
    (``slot_base`` [B]) of the flat B-map table ``vmap_``. One gather of
    all B x M points, then K3 and K4 each with a replica axis (one launch
    each for all replicas), or their twins with ``form="torch"``. The
    result's leaves carry the leading [B]."""
    from . import cuda_gn, cuda_icp
    if form not in ("cuda", "torch"):
        raise ValueError(f"unknown icp form {form!r}")
    if loss not in ("plane", "point"):
        raise ValueError(f"unknown loss {loss!r}")
    b, m = source_mask.shape
    guess = initial_guess.to(torch.float32)
    q_w = se3.transform(guess, source)
    cand = gather_candidates(
        vmap_, q_w.reshape(b * m, 3), voxel_size=voxel_size,
        max_probes=max_probes, neighborhood=neighborhood, n_voxels=n_voxels,
        fit_planes=False, slot_base=slot_base[:, None].expand(b, m).reshape(
            b * m), logical_capacity=logical_capacity)
    cand = CandidateSet(*(x.reshape((b, m) + x.shape[1:]) for x in cand))
    r = 1.5 * voxel_size if plane_radius is None else plane_radius
    prep = (cuda_gn.prep_with_plane if form == "cuda"
            else cuda_gn.prep_with_plane_torch)
    prepped = prep(cand, source_mask, q_w, r, loss=loss)
    loop = cuda_icp.icp_loop if form == "cuda" else cuda_icp.icp_loop_torch
    return IcpResult(*loop(
        source, prepped, guess, kernel, max_distance * max_distance,
        convergence, plane_min_quality=plane_min_quality,
        max_iterations=max_iterations, prior_rot_weight=prior_rot_weight,
        prior_trans_weight=prior_trans_weight))


def _register_refresh(source, source_mask, vmap_, guess, max_d2, kernel, *,
                      voxel_size, max_probes, max_iterations, convergence,
                      loss, plane_min_quality, prior_rot_weight,
                      prior_trans_weight, neighborhood, n_voxels,
                      plane_radius, refresh_drift, form, slot_base=None,
                      logical_capacity=None, group=None,
                      prepped=None) -> IcpResult:
    """The refresh loop (``ptudes_tpu.ops.icp.register_frame_cached`` with
    ``refresh_drift > 0``). Per iteration: stale check; re-gather at the
    current pose if stale; one GN build (K5 or its twin); with ``group``
    its all-reduce over the ranks (:func:`all_reduce_system`); prior,
    Tikhonov floor, solve, SE(3) update; convergence.

    ``refresh_drift == 0`` (the point-sharded frozen form): the candidates
    ``prepped`` the caller prepped stay frozen, there is no stale check,
    and the read is "not converged" alone.

    The JAX package runs this as a ``while_loop`` around a ``lax.cond``.
    Here the loop is on the host, and from the second iteration on it
    reads both predicates ("not converged", "stale") from the card at once
    through :func:`read_flags`: at most one read per iteration. Everything
    else stays on the card. The candidates are prepped once per gather.

    In a graph runner's step (:func:`_refresh_graph`) the loop is a WHILE
    node, the re-gather an IF node and, with ``group``, the all-reduce
    inside the WHILE body, with no host read; the frozen form's loop is
    the WHILE node alone over ``prepped``."""
    from . import cuda_gn
    gn = cuda_gn.gn_prepped if form == "cuda" else cuda_gn.gn_prepped_torch
    refresh_th = refresh_drift * voxel_size

    def fetch_rows(t_at):
        cand = gather_candidates(
            vmap_, se3.transform(t_at, source), voxel_size=voxel_size,
            max_probes=max_probes, neighborhood=neighborhood,
            n_voxels=n_voxels, fit_planes=loss == "plane",
            plane_radius=plane_radius, slot_base=slot_base,
            logical_capacity=logical_capacity)
        return cuda_gn.lane_major_rows(cand, source_mask, loss=loss)

    def fetch(t_at):
        return cuda_gn.split_rows(fetch_rows(t_at),
                                  n_voxels * vmap_.points.shape[1])

    guess_inv = se3.inv(guess)

    def gn_step(t_cur, prepped):
        """One GN iteration at ``t_cur``: (the updated pose, n_corr,
        converged)."""
        jtj, jtr, n_corr, total_w = gn(t_cur, source, prepped, kernel,
                                       max_d2,
                                       plane_min_quality=plane_min_quality)
        if group is not None:
            jtj, jtr, n_corr, total_w = all_reduce_system(
                jtj, jtr, n_corr, total_w, group)
        dx = gn_twist(t_cur, guess_inv, jtj, jtr, total_w,
                      prior_rot_weight=prior_rot_weight,
                      prior_trans_weight=prior_trans_weight)
        return (se3.exp_twist(dx) @ t_cur, n_corr,
                torch.linalg.vector_norm(dx) < convergence)

    refresh = refresh_drift > 0.0
    if graph.conditional_form():
        return _refresh_graph(
            gn_step, guess, guess_inv, max_iterations=max_iterations,
            prepped=prepped, fetch_rows=fetch_rows if refresh else None,
            c=n_voxels * vmap_.points.shape[1], refresh_th=refresh_th)
    if refresh:
        prepped = fetch(guess)
    t_cur = t_gather = guess
    n_corr = torch.zeros((), dtype=torch.int32, device=source.device)
    iters = 0
    while iters < max_iterations:
        if iters > 0:
            flags = [~converged]
            if refresh:
                flags.append(drift_metric(t_gather, t_cur) > refresh_th)
            go, *stale = read_flags(torch.stack(flags))
            if not go:
                break
            if refresh and stale[0]:
                prepped = fetch(t_cur)
                t_gather = t_cur
                REFRESH_COUNTS["regathers"] += 1
        t_cur, n_corr, converged = gn_step(t_cur, prepped)
        iters += 1
    dev_pose = guess_inv @ t_cur
    return IcpResult(
        t_cur, n_corr,
        torch.full((), iters, dtype=torch.int32, device=source.device),
        torch.linalg.vector_norm(se3.trans(dev_pose)),
        torch.linalg.vector_norm(so3.log_rotmat(se3.rot(dev_pose))))


def _refresh_graph(gn_step, guess, guess_inv, *, max_iterations,
                   prepped=None, fetch_rows=None, c=0,
                   refresh_th=0.0) -> IcpResult:
    """:func:`_register_refresh`'s graph form (JAX's ``while_loop`` around
    its ``lax.cond``, ``ptudes_tpu/ops/icp.py:505-520``): the carry (pose,
    the pose gathered at, the prepped rows, the correspondence count, the
    iteration count, the flag) in tensors updated in place; the loop a
    WHILE node on ``~converged & (iterations < max_iterations)``; from the
    second iteration on an IF node on the stale test re-gathers at the
    current pose (counted as ``"regathers"``); then the eager loop's
    ``gn_step`` (K5, with a group its all-reduce, the solve, the update).
    ``fetch_rows(pose)`` gathers and lays out the [8 + 4C, N] rows at a
    pose (``c`` = C). Without ``fetch_rows`` (the point-sharded frozen
    form) the loop runs on the candidates ``prepped`` as they are, with no
    stale test and no IF node. The flag is computed from the all-reduced
    system and the shared pose alone, so every rank of a group runs the
    same iterations."""
    from . import cuda_gn
    dev = guess.device
    t_cur, t_gather = guess.clone(), guess.clone()
    if fetch_rows is not None:
        rows = fetch_rows(guess)
        prepped = cuda_gn.split_rows(rows, c)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)

    def regather():
        rows.copy_(fetch_rows(t_cur))
        t_gather.copy_(t_cur)

    def step():
        if fetch_rows is not None:
            stale = ((iters > 0)
                     & (drift_metric(t_gather, t_cur) > refresh_th))
            graph.if_node("regathers", stale, regather)
        pose, corr_n, converged = gn_step(t_cur, prepped)
        t_cur.copy_(pose)
        n_corr.copy_(corr_n)
        iters.add_(1)
        go.copy_(~converged & (iters < max_iterations))

    if max_iterations > 0:
        graph.while_node("gn_iter", go, step)
    dev_pose = guess_inv @ t_cur
    return IcpResult(
        t_cur, n_corr, iters,
        torch.linalg.vector_norm(se3.trans(dev_pose)),
        torch.linalg.vector_norm(so3.log_rotmat(se3.rot(dev_pose))))


def register_frames_refresh_batched(
        source: torch.Tensor, source_mask: torch.Tensor,
        vmap_: hashmap.VoxelHashMap, initial_guess: torch.Tensor,
        max_distance: torch.Tensor, kernel: torch.Tensor, *,
        slot_base: torch.Tensor, logical_capacity: int, voxel_size: float,
        max_probes: int, max_iterations: int, convergence: float,
        loss: str, plane_min_quality: float, prior_rot_weight: float,
        prior_trans_weight: float, neighborhood: int, n_voxels: int,
        plane_radius: float | None, refresh_drift: float,
        form: str) -> IcpResult:
    """B refresh loops (:func:`_register_refresh`) run as one, as the JAX
    package's ``while_loop`` and ``lax.cond`` run under ``jax.vmap``:
    ``source`` [B, M, 3], ``source_mask`` [B, M], guesses [B, 4, 4],
    ``max_distance`` and ``kernel`` [B], against replica b's slots
    (``slot_base`` [B]) of the flat B-map table ``vmap_``.

    The loop runs while any replica goes and the iteration cap allows.
    Each iteration is one K5 launch with a replica axis for the active
    replicas (or its twin with ``form="torch"``), then the prior, the
    Tikhonov floor, the solve and the SE(3) update over [B]; a replica
    that has converged keeps its pose, iteration count and correspondence
    count (its update is zero, as in JAX's ``gn_step``). From the second
    iteration on, one :func:`read_flags` of a [B, 2] tensor (goes, stale)
    an iteration; only the stale replicas that go re-gather, at their
    current pose, from their own slots, picked by the host from that read
    (``REFRESH_COUNTS["regathers"]`` counts one a replica). Replica b's
    iteration count, re-gathers and correspondence count are
    :func:`_register_refresh`'s on its own inputs. The result's leaves
    carry the leading [B].

    In a graph runner's step the loop is a WHILE node on ``any(active) &
    (iterations < max_iterations)`` and the host's pick a mask on the card:
    under an IF node on ``any(active & stale)`` all B replicas are gathered
    at their current poses and the stale replicas' rows and poses taken
    from it (the gather and the layout work point by point, so a replica's
    rows are the subset gather's); the re-gathered replicas are counted on
    the card as ``"regathers"``."""
    from . import cuda_gn
    if form not in ("cuda", "torch"):
        raise ValueError(f"unknown icp form {form!r}")
    if loss not in ("plane", "point"):
        raise ValueError(f"unknown loss {loss!r}")
    gn = cuda_gn.gn_prepped if form == "cuda" else cuda_gn.gn_prepped_torch
    b, m = source_mask.shape
    dev = source.device
    refresh_th = refresh_drift * voxel_size
    max_d2 = max_distance * max_distance

    def pick(x, idx):
        return x if len(idx) == b else torch.stack([x[i] for i in idx])

    def fetch(idx, t_at):
        """Replicas ``idx``' prepped rows [k, 8 + 4C, M], gathered at
        their poses ``t_at`` [k, 4, 4] in one call."""
        k = len(idx)
        cand = gather_candidates(
            vmap_, se3.transform(t_at, pick(source, idx)).reshape(k * m, 3),
            voxel_size=voxel_size, max_probes=max_probes,
            neighborhood=neighborhood, n_voxels=n_voxels,
            fit_planes=loss == "plane", plane_radius=plane_radius,
            slot_base=pick(slot_base, idx)[:, None].expand(k, m).reshape(
                k * m), logical_capacity=logical_capacity)
        cand = CandidateSet(*(x.reshape((k, m) + x.shape[1:]) for x in cand))
        return cuda_gn.lane_major_rows(cand, pick(source_mask, idx),
                                       loss=loss)

    guess = initial_guess.to(torch.float32)
    guess_inv = se3.inv(guess)
    everyone = list(range(b))
    rows = fetch(everyone, guess)
    prepped = cuda_gn.split_rows(rows, n_voxels * vmap_.points.shape[-1])
    out = torch.zeros((b, cuda_gn.GN_OUT), dtype=torch.float32, device=dev)
    n_corr = torch.zeros((b,), dtype=torch.int32, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)

    def gn_step(t_cur, n_corr, iters, active):
        """One GN iteration of the active replicas: the new (poses,
        n_corr, iterations, active)."""
        jtj, jtr, corr_n, total_w = gn(
            t_cur, source, prepped, kernel, max_d2,
            plane_min_quality=plane_min_quality, active=active, out=out)
        dx = gn_twist(t_cur, guess_inv, jtj, jtr, total_w,
                      prior_rot_weight=prior_rot_weight,
                      prior_trans_weight=prior_trans_weight)
        dx = torch.where(active[:, None], dx, 0.0)
        return (torch.where(active[:, None, None],
                            se3.exp_twist(dx) @ t_cur, t_cur),
                torch.where(active, corr_n, n_corr),
                iters + active.to(torch.int32),
                active & ~(torch.linalg.vector_norm(dx, dim=-1)
                           < convergence))

    if graph.conditional_form():
        return _refresh_batched_graph(
            gn_step, fetch, rows, n_corr, iters, active, guess, guess_inv,
            max_iterations=max_iterations, refresh_th=refresh_th)
    t_cur = t_gather = guess
    it = 0
    while it < max_iterations:
        if it > 0:
            stale = drift_metric(t_gather, t_cur) > refresh_th
            flags = read_flags(torch.stack([active, stale], -1))
            if not any(f[0] for f in flags):
                break
            redo = [i for i, (go, st) in enumerate(flags) if go and st]
            if redo:
                fresh = fetch(redo, pick(t_cur, redo))
                if len(redo) == b:
                    rows.copy_(fresh)
                else:
                    for j, i in enumerate(redo):
                        rows[i].copy_(fresh[j])
                t_gather = torch.where((active & stale)[:, None, None],
                                       t_cur, t_gather)
                REFRESH_COUNTS["regathers"] += len(redo)
        t_cur, n_corr, iters, active = gn_step(t_cur, n_corr, iters, active)
        it += 1
    return _batched_result(guess_inv, t_cur, n_corr, iters)


def _batched_result(guess_inv, t_cur, n_corr, iters) -> IcpResult:
    dev_pose = guess_inv @ t_cur
    return IcpResult(
        t_cur, n_corr, iters,
        torch.linalg.vector_norm(se3.trans(dev_pose), dim=-1),
        torch.linalg.vector_norm(so3.log_rotmat(se3.rot(dev_pose)), dim=-1))


def _refresh_batched_graph(gn_step, fetch, rows, n_corr, iters, active,
                           guess, guess_inv, *, max_iterations,
                           refresh_th) -> IcpResult:
    """:func:`register_frames_refresh_batched`'s graph form: the carry
    (``rows``, ``n_corr``, ``iters``, ``active`` as the caller made them,
    the poses, the loop's iteration count, the flag) updated in place; the
    loop a WHILE node, the re-gather of the stale replicas that go an IF
    node on ``any`` of them (all replicas gathered, the stale ones' rows
    and poses taken), counted on the card as ``"regathers"``; then the
    eager loop's ``gn_step``."""
    b, dev = active.shape[0], active.device
    everyone = list(range(b))
    t_cur, t_gather = guess.clone(), guess.clone()
    it = torch.zeros((), dtype=torch.int32, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)

    def regather(redo):
        fresh = fetch(everyone, t_cur)
        rows.copy_(torch.where(redo[:, None, None], fresh, rows))
        t_gather.copy_(torch.where(redo[:, None, None], t_cur, t_gather))
        graph.count("regathers", redo.sum(dtype=torch.int32))

    def step():
        stale = drift_metric(t_gather, t_cur) > refresh_th
        redo = (it > 0) & active & stale
        graph.if_node("regather_calls", redo.any(), lambda: regather(redo))
        for dst, src in zip((t_cur, n_corr, iters, active),
                            gn_step(t_cur, n_corr, iters, active)):
            dst.copy_(src)
        it.add_(1)
        go.copy_(active.any() & (it < max_iterations))

    if max_iterations > 0:
        graph.while_node("gn_iter", go, step)
    return _batched_result(guess_inv, t_cur, n_corr, iters)


def register_frame(source: torch.Tensor, source_mask: torch.Tensor,
                   vmap_: hashmap.VoxelHashMap, initial_guess: torch.Tensor,
                   max_distance: torch.Tensor, kernel: torch.Tensor, *,
                   voxel_size: float, max_probes: int = 4,
                   max_iterations: int = 50, convergence: float = 1e-4,
                   approx: bool = True, loss: str = "point",
                   plane_min_quality: float = 0.2,
                   prior_rot_weight: float = 0.0,
                   prior_trans_weight: float = 0.0,
                   neighborhood: int = 27) -> IcpResult:
    """Robust GN ICP with a map query every iteration
    (``ptudes_tpu.ops.icp.register_frame``, ``nn_mode="every"``).

    Per iteration: ``hashmap.query`` of the source at the current pose
    (``approx``, ``neighborhood``), correspondences within
    ``max_distance``, point rows (``loss="point"``) or plane rows from the
    matched voxel's own plane (``plane.voxel_plane``, point rows where it
    is not planar), the motion prior toward the guess, the Tikhonov floor,
    the solve and the SE(3) update; it stops once the update is shorter
    than ``convergence``. The JAX package's ``while_loop`` reads that
    flag on the device; here the host reads it through :func:`read_flags`,
    once an iteration from the second on; in a graph runner's step the
    loop is a WHILE node on ``~converged & (iterations <
    max_iterations)`` (``ptudes_tpu/ops/icp.py:670``), its carry updated
    in place, with no host read."""
    if loss not in ("plane", "point"):
        raise ValueError(f"unknown loss {loss!r}")
    max_d2 = max_distance * max_distance
    guess = initial_guess.to(torch.float32)
    guess_inv = se3.inv(guess)

    def gn_step(t_cur):
        """One GN iteration at ``t_cur``: (the updated pose, n_corr,
        converged)."""
        pts_w = se3.transform(t_cur, source)
        res = hashmap.query(vmap_, pts_w, voxel_size=voxel_size,
                            max_probes=max_probes, approx=approx,
                            neighborhood=neighborhood)
        corr = source_mask & res.found & (res.d2 <= max_d2)
        if loss == "plane":
            # res.nn lies in the winning voxel: its floor is the voxel
            vox_pts = hashmap.unpack_points(
                hashmap.gather_rows(vmap_.points, res.slot),
                voxel_coords(res.nn, voxel_size)[:, None, :], voxel_size)
            cnt = hashmap.gather_rows(vmap_.meta, res.slot)[:, 1]
            normal, centroid, quality = voxel_plane(vox_pts, cnt)
            jtj, jtr, n_corr, total_w = _robust_system(
                pts_w, res.nn, res.d2, corr, kernel, normal, centroid,
                quality, plane_min_quality)
        else:
            jtj, jtr, n_corr, total_w = _robust_system(
                pts_w, res.nn, res.d2, corr, kernel)
        dx = gn_twist(t_cur, guess_inv, jtj, jtr, total_w,
                      prior_rot_weight=prior_rot_weight,
                      prior_trans_weight=prior_trans_weight)
        return (se3.exp_twist(dx) @ t_cur, n_corr,
                torch.linalg.vector_norm(dx) < convergence)

    n_corr = torch.zeros((), dtype=torch.int32, device=source.device)
    if graph.conditional_form():
        t_cur = guess.clone()
        iters = torch.zeros((), dtype=torch.int32, device=source.device)
        go = torch.ones((), dtype=torch.bool, device=source.device)

        def step():
            pose, corr_n, converged = gn_step(t_cur)
            t_cur.copy_(pose)
            n_corr.copy_(corr_n)
            iters.add_(1)
            go.copy_(~converged & (iters < max_iterations))

        if max_iterations > 0:
            graph.while_node("every_iter", go, step)
    else:
        t_cur = guess
        it = 0
        while it < max_iterations:
            if it > 0 and not read_flags((~converged)[None])[0]:
                break
            t_cur, n_corr, converged = gn_step(t_cur)
            it += 1
        iters = torch.full((), it, dtype=torch.int32, device=source.device)
    dev_pose = guess_inv @ t_cur
    return IcpResult(
        t_cur, n_corr, iters,
        torch.linalg.vector_norm(se3.trans(dev_pose)),
        torch.linalg.vector_norm(so3.log_rotmat(se3.rot(dev_pose))))
