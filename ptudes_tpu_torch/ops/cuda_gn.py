"""The ICP candidate kernels on the lane-major [C, N] layout:

- K3, the per-point patch plane fit over the gathered candidates, which
  also lays them out lane-major (``csrc/gn_prep.cu``), the counterpart of
  ``ptudes_tpu.ops.pallas_gn.prep_with_plane_pallas``;
- K5, one robust GN build against prepped candidates (``csrc/gn_iter.cu``),
  the counterpart of ``ptudes_tpu.ops.pallas_gn.gn_prepped_pallas``;
- K7, the patch moments alone (``csrc/plane_moments.cu``), the counterpart
  of ``ptudes_tpu.ops.pallas_gn.plane_moments_pallas``, which no pipeline
  path calls.

The candidates are laid out ONCE per gather in the lane-major [C, N] rows
K4 and K5 read: on the frozen path by K3 itself, which also writes the feat
rows (normal, centroid, quality, source mask); in K3's twin by
:func:`lane_major`; on the refresh path by :func:`prep_candidates`, its
feat rows coming from the gather's own plane fit.

K3 also takes a leading replica axis (the batched driver's B
registrations): one launch writes every replica's feat and lane-major rows
into one [B, 8 + 4C, N] buffer, the layout K4's replica axis reads. So do
:func:`prep_candidates` for the batched refresh loop and K5, whose replica
axis builds all replicas' systems in one launch and skips the replicas an
``active`` mask on the card leaves out.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from .icp import CandidateSet, gn_from_candidates
from .plane import smallest_eigvec_sym3
from ..utils.replicas import per_replica

_F32 = torch.float32
GN_TILE = 32     # points per CTA of K5 (csrc/gn_iter.cu:kTile)
GN_GROUPS = 8    # row ranges per point, one a warp (kGroups)
GN_THREADS = GN_TILE * GN_GROUPS


def row_groups(c: int, groups: int) -> list[tuple[int, int]]:
    """The contiguous, ascending row ranges [k0, k1) that cut ``c``
    candidate rows into ``groups`` (csrc/common.cuh:row_split); ranges are
    empty where c < groups."""
    return [(g * c // groups, (g + 1) * c // groups) for g in range(groups)]


class GnPlan(NamedTuple):
    blocks: int       # CTAs of GN_THREADS, each GN_TILE consecutive points
    row_ranges: list  # per warp, the rows it scans for all the CTA's points


def gn_plan(n: int, c: int) -> GnPlan:
    """K5's launch shape for ``n`` source points and ``c`` candidate rows
    (``ptudes_gn_iter`` computes the same)."""
    if n <= 0 or c <= 0:
        raise ValueError(f"gn_plan: n {n}, c {c}")
    return GnPlan(-(-n // GN_TILE), row_groups(c, GN_GROUPS))


_TICKETS: dict[int, torch.Tensor] = {}


def _ticket(device: torch.device, replicas: int = 1) -> torch.Tensor:
    """K5's last-CTA counters on ``device``: one int32 a replica, zero
    between launches (each replica's last CTA resets its own), allocated
    once and grown to the largest replica count asked for. Launches that
    share them must run in one stream's order."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _TICKETS or _TICKETS[idx].numel() < replicas:
        _TICKETS[idx] = torch.zeros(replicas, dtype=torch.int32,
                                    device=device)
    return _TICKETS[idx]


class PreppedCandidates(NamedTuple):
    feat: torch.Tensor  # [8, N] nx ny nz cx cy cz quality mask
    cx: torch.Tensor    # [C, N]
    cy: torch.Tensor
    cz: torch.Tensor
    inf: torch.Tensor   # [C, N] 0 valid / 1e30 invalid


def lane_major(cand) -> tuple[torch.Tensor, ...]:
    """CandidateSet -> contiguous (cx, cy, cz, inf), each [C, N]."""
    cx, cy, cz = (cand.pts[:, :, i].T.contiguous() for i in range(3))
    inf = torch.where(cand.valid, 0.0, 1e30).to(_F32).T.contiguous()
    return cx, cy, cz, inf


def _radius2(radius: float) -> float:
    """radius^2 in f32, as the TPU kernel's scalar input."""
    return float(np.float32(radius) * np.float32(radius))


def _patch_weights(q_w: torch.Tensor, cx, cy, cz, inf, r2: float):
    """(w, dx, dy, dz), each [C, N]: the candidate offsets d = c - q and
    w = 1 for the valid ones within the patch radius (d2 + inf <= r2)."""
    dx, dy, dz = cx - q_w[:, 0], cy - q_w[:, 1], cz - q_w[:, 2]
    w = ((dx * dx + dy * dy + dz * dz + inf) <= r2).to(_F32)
    return w, dx, dy, dz


def plane_feat_torch(q_w: torch.Tensor, source_mask: torch.Tensor, cx, cy,
                     cz, inf, r2: float) -> torch.Tensor:
    """The patch plane fit's feat rows [8, N] (normal, centroid, quality,
    mask) over lane-major candidates: offset moments within the radius,
    covariance, ``plane.smallest_eigvec_sym3``."""
    w, dx, dy, dz = _patch_weights(q_w, cx, cy, cz, inf, r2)
    n_in = w.sum(0)
    denom = torch.clamp(n_in, min=1.0)
    m = torch.stack([(w * dx).sum(0), (w * dy).sum(0), (w * dz).sum(0)],
                    -1) / denom[:, None]                       # [N, 3]
    d = torch.stack([dx, dy, dz], -1) * w[..., None]           # [C, N, 3]
    cov = torch.einsum("cni,cnj->nij", d, d) / denom[:, None, None] \
        - m[:, :, None] * m[:, None, :]
    normal, quality = smallest_eigvec_sym3(cov)
    return torch.cat([normal, q_w + m,
                      torch.where(n_in >= 4, quality, 0.0)[:, None],
                      source_mask.to(_F32)[:, None]], 1).T.contiguous()


def point_feat_torch(source_mask: torch.Tensor) -> torch.Tensor:
    """The feat rows [8, N] of the point loss: no fit, zeros, quality -1 (no
    correspondence takes the plane row) and the mask
    (``pallas_gn.py:288-295``)."""
    n = source_mask.shape[0]
    dev = source_mask.device
    return torch.cat([torch.zeros((6, n), dtype=_F32, device=dev),
                      torch.full((1, n), -1.0, dtype=_F32, device=dev),
                      source_mask.to(_F32)[None]])


def prep_with_plane_torch(cand, source_mask: torch.Tensor,
                          q_w: torch.Tensor, radius: float, *,
                          loss: str = "plane") -> PreppedCandidates:
    """K3's plain twin: :func:`plane_feat_torch` on the lane-major
    candidates, or with ``loss="point"`` :func:`point_feat_torch`; with a
    leading replica axis, replica by replica."""
    if source_mask.dim() == 2:
        return per_replica(prep_with_plane_torch, source_mask.shape[0],
                           cand, source_mask, q_w, radius=radius, loss=loss)
    cx, cy, cz, inf = lane_major(cand)
    feat = (plane_feat_torch(q_w, source_mask, cx, cy, cz, inf,
                             _radius2(radius)) if loss == "plane"
            else point_feat_torch(source_mask))
    return PreppedCandidates(feat, cx, cy, cz, inf)


def prep_with_plane(cand, source_mask: torch.Tensor, q_w: torch.Tensor,
                    radius: float, *, loss: str = "plane"
                    ) -> PreppedCandidates:
    """K3: CUDA tensors launch ``gn_prep``, which takes the CandidateSet as
    gathered (``pts`` [N, C, 3] f32, ``valid`` [N, C] bool, read as bytes)
    with ``q_w`` [N, 3] f32 and ``source_mask`` [N] bool, all contiguous,
    and writes feat and the lane-major candidates in one launch; anything
    else raises. ``loss="point"`` runs the kernel's instance without the
    plane fit (feat as :func:`point_feat_torch`). A leading replica axis
    on all four ([B, N, C, 3] ...) runs all replicas in the one launch,
    its outputs [B, 8, N] and [B, C, N] views of one buffer. CPU tensors
    take the twin."""
    if loss not in ("plane", "point"):
        raise ValueError(f"gn_prep: loss {loss!r}")
    if kernels.device_kind(q_w, "gn_prep") == "cpu":
        return prep_with_plane_torch(cand, source_mask, q_w, radius,
                                     loss=loss)
    lead, (n, c) = cand.valid.shape[:-2], cand.valid.shape[-2:]
    if cand.pts.shape != lead + (n, c, 3) or q_w.shape != lead + (n, 3) \
            or source_mask.shape != lead + (n,) or len(lead) > 1:
        raise ValueError(
            f"gn_prep: pts {tuple(cand.pts.shape)}, valid "
            f"{tuple(cand.valid.shape)}, q_w {tuple(q_w.shape)}, "
            f"source_mask {tuple(source_mask.shape)}")
    out = torch.empty(lead + (8 + 4 * c, n), dtype=_F32, device=q_w.device)
    prepped = PreppedCandidates(out[..., :8, :],
                                *out[..., 8:, :].split(c, -2))
    kernels.launch(
        "gn_prep", kernels.ptr(cand.pts, "pts"),
        kernels.ptr(cand.valid, "valid", torch.bool), kernels.ptr(q_w, "q_w"),
        kernels.ptr(source_mask, "source_mask", torch.bool),
        *(kernels.ptr(out, "out") + 4 * n * r0
          for r0 in (0, 8, 8 + c, 8 + 2 * c, 8 + 3 * c)),
        n, c, _radius2(radius), int(loss == "plane"),
        int(lead[0]) if lead else 1, (8 + 4 * c) * n)
    return prepped


def prep_candidates(cand, source_mask: torch.Tensor, *,
                    loss: str = "plane") -> PreppedCandidates:
    """The lane-major candidates with the feat rows taken from ``cand``'s
    own patch plane fit (``pallas_gn.prep_candidates``); ``loss="point"``
    sets quality -1, so no correspondence takes the plane row. The five
    fields are views of one [8 + 4C, N] buffer (:func:`lane_major_rows`);
    with a leading replica axis (``cand`` [B, N, ...], ``source_mask``
    [B, N]) of one [B, 8 + 4C, N] buffer, the layout K4 and K5 take with a
    replica stride, each replica's values its own call's."""
    return split_rows(lane_major_rows(cand, source_mask, loss=loss),
                      cand.valid.shape[-1])


def lane_major_rows(cand, source_mask: torch.Tensor, *,
                    loss: str = "plane") -> torch.Tensor:
    """:func:`prep_candidates`' buffer [..., 8 + 4C, N] of candidates
    ``cand`` [..., N, ...]: the feat rows, then the cx, cy, cz and inf
    rows."""
    mask = source_mask.to(_F32)[..., None]
    if loss != "plane":
        feat = torch.cat([torch.zeros(mask.shape[:-1] + (6,), dtype=_F32,
                                      device=mask.device),
                          torch.full_like(mask, -1.0), mask], -1)
    else:
        feat = torch.cat([cand.normal, cand.centroid,
                          cand.quality[..., None], mask], -1)
    inf = torch.where(cand.valid, 0.0, 1e30).to(_F32)
    return torch.cat([feat, cand.pts[..., 0], cand.pts[..., 1],
                      cand.pts[..., 2], inf], -1).transpose(-1, -2) \
        .contiguous()


def split_rows(buf: torch.Tensor, c: int) -> PreppedCandidates:
    """The feat, cx, cy, cz and inf views of a [..., 8 + 4C, N] buffer."""
    return PreppedCandidates(buf[..., :8, :], *buf[..., 8:, :].split(c, -2))


def prepped_rows(prepped: PreppedCandidates, lead: tuple
                 ) -> tuple[list[int], int]:
    """K4's and K5's pointers to replica 0's feat, cx, cy, cz, inf rows
    and the floats between replicas: one stride for all five (K3's and
    :func:`prep_candidates`' replica-axis buffers have it; other layouts
    are packed into one [B, 8 + 4C, N] buffer first)."""
    if not lead:
        return [kernels.ptr(x, name) for x, name in
                zip(prepped, prepped._fields)], 0
    stride = prepped.feat.stride(0)
    if not all(x.stride(0) == stride and x[0].is_contiguous()
               for x in prepped):
        buf = torch.cat([x.to(_F32) for x in prepped], -2).contiguous()
        prepped = split_rows(buf, prepped.cx.shape[-2])
        stride = buf.stride(0)
    return [kernels.ptr(x[0], name) for x, name in
            zip(prepped, prepped._fields)], stride


def candidates_from_prepped(prepped: PreppedCandidates
                            ) -> tuple[CandidateSet, torch.Tensor]:
    """The inverse of the lane-major prep: (CandidateSet, source mask)."""
    f = prepped.feat
    cand = CandidateSet(
        pts=torch.stack([prepped.cx.T, prepped.cy.T, prepped.cz.T], -1),
        valid=(prepped.inf == 0).T, normal=f[0:3].T, centroid=f[3:6].T,
        quality=f[6])
    return cand, f[7] > 0


GN_OUT = 44  # K5's output row: jtj (36), jtr (6), n_corr, total weight


def _unpack_gn(out: torch.Tensor):
    """(jtj [..., 6, 6], jtr [..., 6], n_corr int32, total weight) of K5's
    output rows [..., 44]."""
    lead = out.shape[:-1]
    return (out[..., :36].reshape(lead + (6, 6)), out[..., 36:42],
            out[..., 42].to(torch.int32), out[..., 43])


def gn_prepped_torch(t_cur: torch.Tensor, source: torch.Tensor,
                     prepped: PreppedCandidates, kernel: torch.Tensor,
                     max_d2: torch.Tensor, *, plane_min_quality: float,
                     active: torch.Tensor | None = None,
                     out: torch.Tensor | None = None):
    """K5's plain twin: ``icp.gn_from_candidates`` on the candidates the
    prepped tensors hold. Returns (jtj [6, 6], jtr [6], n_corr int32,
    total weight).

    With a leading replica axis (poses [B, 4, 4], ``source`` [B, N, 3],
    prepped rows [B, ., N], ``kernel`` and ``max_d2`` [B]) replica by
    replica, packed into K5's output rows ``out`` [B, 44] (a new one when
    None) and returned as [B, ...] views of them; the rows of replicas
    whose ``active`` [B] is false keep what ``out`` held (zeros in a new
    one), selected on the device without a host read."""
    if source.dim() == 3:
        def row(*args):
            jtj, jtr, n_corr, total_w = gn_prepped_torch(
                *args, plane_min_quality=plane_min_quality)
            return torch.cat([jtj.reshape(36), jtr, n_corr.to(_F32)[None],
                              total_w[None]])

        rows = per_replica(row, source.shape[0], t_cur, source, prepped,
                           kernel, max_d2)
        if out is None:
            out = torch.zeros_like(rows)
        out.copy_(rows if active is None
                  else torch.where(active[:, None], rows, out))
        return _unpack_gn(out)
    cand, mask = candidates_from_prepped(prepped)
    return gn_from_candidates(t_cur, source, mask, cand, kernel, max_d2,
                              plane_min_quality=plane_min_quality)


def gn_prepped(t_cur: torch.Tensor, source: torch.Tensor,
               prepped: PreppedCandidates, kernel: torch.Tensor,
               max_d2: torch.Tensor, *, plane_min_quality: float,
               active: torch.Tensor | None = None,
               out: torch.Tensor | None = None):
    """K5: CUDA tensors launch ``gn_iter`` (one launch a build, shaped by
    :func:`gn_plan`); CPU tensors take the twin. The kernel transforms
    ``source`` [N, 3] by ``t_cur`` itself.

    A leading replica axis (as :func:`gn_prepped_torch`'s) builds every
    replica's system in the one launch (grid y = the replica; the prepped
    rows one stride apart, :func:`prepped_rows`), counted once, into
    ``out`` [B, 44] (a new one when None); ``active`` [B] bool on the card
    leaves the rows of the replicas it clears as they were, and their CTAs
    do no work. Returns [B, ...] views of ``out``."""
    if kernels.device_kind(source, "gn_iter") == "cpu":
        return gn_prepped_torch(t_cur, source, prepped, kernel, max_d2,
                                plane_min_quality=plane_min_quality,
                                active=active, out=out)
    lead, (c, n) = source.shape[:-2], prepped.cx.shape[-2:]
    if source.shape != lead + (n, 3) or len(lead) > 1 \
            or prepped.feat.shape != lead + (8, n) \
            or any(x.shape != lead + (c, n) for x in prepped[2:]):
        raise ValueError(
            f"gn_iter: source {tuple(source.shape)}, feat "
            f"{tuple(prepped.feat.shape)}, candidates {c} x {n}")
    b = int(lead[0]) if lead else 1
    if out is None:
        out = torch.empty(lead + (GN_OUT,), dtype=_F32, device=source.device)
    if out.shape != lead + (GN_OUT,) or (active is not None and (
            not lead or active.shape != lead)):
        raise ValueError(f"gn_iter: out {tuple(out.shape)}, active "
                         f"{None if active is None else tuple(active.shape)}"
                         f" for {b} replicas")
    scal = torch.cat([kernel.reshape(lead + (1,)),
                      max_d2.reshape(lead + (1,)),
                      t_cur[..., :3, :].reshape(lead + (12,))], -1) \
        .to(_F32).contiguous()
    partial = torch.empty(b * gn_plan(n, c).blocks * 45, dtype=_F32,
                          device=source.device)
    rows, stride = prepped_rows(prepped, lead)
    kernels.launch(
        "gn_iter", kernels.ptr(source, "source"), *rows,
        kernels.ptr(scal, "scal"), kernels.ptr(partial, "partial"),
        kernels.ptr(_ticket(source.device, b), "ticket", torch.int32),
        kernels.ptr(out, "out"),
        None if active is None else kernels.ptr(active, "active",
                                                torch.bool),
        n, c, plane_min_quality, b, stride)
    return _unpack_gn(out)


MOMENT_ROWS = 16  # plane_moments output rows (10 used, the rest zero)


def plane_moments_torch(ptq: torch.Tensor, cx, cy, cz, inf,
                        radius2) -> torch.Tensor:
    """K7's plain twin: [16, N], row 0 the count, rows 1-3 sum d, rows 4-9
    sum d d^T (xx yy zz xy xz yz) of the valid candidates' offsets from the
    query points ``ptq[0:3]`` within the radius; rows 10-15 zero."""
    w, dx, dy, dz = _patch_weights(ptq[0:3].T, cx, cy, cz, inf,
                                   float(np.float32(radius2)))
    rows = [w, w * dx, w * dy, w * dz, w * dx * dx, w * dy * dy, w * dz * dz,
            w * dx * dy, w * dx * dz, w * dy * dz]
    sums = torch.stack([r.sum(0) for r in rows])
    return torch.cat([sums, sums.new_zeros((MOMENT_ROWS - 10,
                                            sums.shape[1]))])


def plane_moments(ptq: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  cz: torch.Tensor, inf: torch.Tensor, radius2
                  ) -> torch.Tensor:
    """K7: CUDA tensors launch ``plane_moments``; CPU tensors take the
    twin. ``ptq`` [8, N] (rows 0-2 the query points), candidates [C, N],
    ``radius2`` a Python float or 0-d tensor (cast to f32)."""
    if kernels.device_kind(ptq, "plane_moments") == "cpu":
        return plane_moments_torch(ptq, cx, cy, cz, inf, radius2)
    c, n = cx.shape
    if ptq.shape != (8, n) or any(x.shape != (c, n) for x in (cy, cz, inf)):
        raise ValueError(f"plane_moments: ptq {tuple(ptq.shape)}, "
                         f"candidates {c} x {n}")
    out = torch.empty((MOMENT_ROWS, n), dtype=_F32, device=ptq.device)
    kernels.launch(
        "plane_moments", kernels.ptr(ptq, "ptq"), kernels.ptr(cx, "cx"),
        kernels.ptr(cy, "cy"), kernels.ptr(cz, "cz"),
        kernels.ptr(inf, "inf"), kernels.ptr(out, "out"), n, c,
        float(np.float32(radius2)))
    return out
