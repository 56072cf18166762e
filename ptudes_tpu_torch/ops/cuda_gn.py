"""K3: the per-point patch plane fit over the gathered ICP candidates
(``csrc/gn_prep.cu``), the counterpart of
``ptudes_tpu.ops.pallas_gn.prep_with_plane_pallas``.

The candidates are transposed ONCE per registration to the lane-major
[C, N] layout both K3 and the ICP loop K4 read; the plane fit then emits
the feat rows (normal, centroid, quality, source mask).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
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


def prep_with_plane_torch(cand, source_mask: torch.Tensor,
                          q_w: torch.Tensor, radius: float
                          ) -> PreppedCandidates:
    """K3's plain twin: offset moments within the radius, covariance,
    ``plane.smallest_eigvec_sym3``."""
    cx, cy, cz, inf = lane_major(cand)
    dx, dy, dz = cx - q_w[:, 0], cy - q_w[:, 1], cz - q_w[:, 2]
    w = ((dx * dx + dy * dy + dz * dz + inf) <= _radius2(radius)).to(_F32)
    n_in = w.sum(0)
    denom = torch.clamp(n_in, min=1.0)
    m = torch.stack([(w * dx).sum(0), (w * dy).sum(0), (w * dz).sum(0)],
                    -1) / denom[:, None]                       # [N, 3]
    d = torch.stack([dx, dy, dz], -1) * w[..., None]           # [C, N, 3]
    cov = torch.einsum("cni,cnj->nij", d, d) / denom[:, None, None] \
        - m[:, :, None] * m[:, None, :]
    normal, quality = smallest_eigvec_sym3(cov)
    feat = torch.cat([normal, q_w + m,
                      torch.where(n_in >= 4, quality, 0.0)[:, None],
                      source_mask.to(_F32)[:, None]], 1).T.contiguous()
    return PreppedCandidates(feat, cx, cy, cz, inf)


def prep_with_plane(cand, source_mask: torch.Tensor, q_w: torch.Tensor,
                    radius: float) -> PreppedCandidates:
    """K3: CUDA tensors launch ``gn_prep``; CPU tensors take the twin."""
    if kernels.device_kind(q_w, "gn_prep") == "cpu":
        return prep_with_plane_torch(cand, source_mask, q_w, radius)
    cx, cy, cz, inf = lane_major(cand)
    c, n = cx.shape
    ptq = torch.cat([q_w.to(_F32).T, source_mask.to(_F32)[None]],
                    0).contiguous()                            # [4, N]
    feat = torch.empty((8, n), dtype=_F32, device=q_w.device)
    kernels.launch(
        "gn_prep", kernels.ptr(ptq, "ptq"), kernels.ptr(cx, "cx"),
        kernels.ptr(cy, "cy"), kernels.ptr(cz, "cz"),
        kernels.ptr(inf, "inf"), kernels.ptr(feat, "feat"), n, c,
        _radius2(radius))
    return PreppedCandidates(feat, cx, cy, cz, inf)
