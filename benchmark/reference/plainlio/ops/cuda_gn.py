"""The plain twins of the ICP candidate kernels on the lane-major [C, N]
layout (``ptudes_tpu_torch.ops.cuda_gn``): K3's per-point patch plane fit
over the gathered candidates, which also lays them out lane-major, and
K5's robust GN build against prepped candidates.

The candidates are laid out ONCE per gather in the lane-major [C, N] rows
K4 and K5 read: on the frozen path by K3's twin (:func:`lane_major`), on
the refresh path by :func:`lane_major_rows`, its feat rows coming from the
gather's own plane fit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .icp import CandidateSet, gn_from_candidates
from .plane import smallest_eigvec_sym3

_F32 = torch.float32


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


def prep_with_plane_torch(cand, source_mask: torch.Tensor,
                          q_w: torch.Tensor, radius: float, *,
                          loss: str = "plane") -> PreppedCandidates:
    """K3's plain twin: :func:`plane_feat_torch` on the lane-major
    candidates (the plane loss, which both configurations run)."""
    if loss != "plane":
        raise ValueError(f"the reference runs the plane loss, not {loss!r}")
    cx, cy, cz, inf = lane_major(cand)
    feat = plane_feat_torch(q_w, source_mask, cx, cy, cz, inf,
                            _radius2(radius))
    return PreppedCandidates(feat, cx, cy, cz, inf)


def lane_major_rows(cand, source_mask: torch.Tensor, *,
                    loss: str = "plane") -> torch.Tensor:
    """The refresh loop's lane-major buffer [..., 8 + 4C, N] of candidates
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


def candidates_from_prepped(prepped: PreppedCandidates
                            ) -> tuple[CandidateSet, torch.Tensor]:
    """The inverse of the lane-major prep: (CandidateSet, source mask)."""
    f = prepped.feat
    cand = CandidateSet(
        pts=torch.stack([prepped.cx.T, prepped.cy.T, prepped.cz.T], -1),
        valid=(prepped.inf == 0).T, normal=f[0:3].T, centroid=f[3:6].T,
        quality=f[6])
    return cand, f[7] > 0


def gn_prepped_torch(t_cur: torch.Tensor, source: torch.Tensor,
                     prepped: PreppedCandidates, kernel: torch.Tensor,
                     max_d2: torch.Tensor, *, plane_min_quality: float):
    """K5's plain twin: ``icp.gn_from_candidates`` on the candidates the
    prepped tensors hold. Returns (jtj [6, 6], jtr [6], n_corr int32,
    total weight)."""
    cand, mask = candidates_from_prepped(prepped)
    return gn_from_candidates(t_cur, source, mask, cand, kernel, max_d2,
                              plane_min_quality=plane_min_quality)
