"""K6: the fused ICP candidate gather (``csrc/gather_fused.cu``), the
counterpart of ``ptudes_tpu.ops.pallas_gather.gather_prep_fused``.

One launch after the transform of the source to the gather pose
(:func:`gather_fused`), one warp per source point:

- select: the hash-probe match of its J neighbour voxels and the top-V
  selection by representative distance, kept on chip (and, when asked,
  written to ``aux`` int32 [5V, N]: slot, count, corner x, y, z per
  selected voxel);
- prep: the V x P packed points of the selected voxels, unpacked into the
  lane-major candidates and, for the plane loss, the patch plane fit ->
  ``cuda_gn.PreppedCandidates``.

The plain twins of the two stages, :func:`select_voxels_torch` and
:func:`prep_selected_torch`, compute what the kernel computes, which is
the TPU select kernel's semantics, not ``icp.gather_candidates``': an
unmatched neighbour has distance 1e30; once fewer than V voxels matched,
the remaining selections are neighbour 0 with count 0; candidates decode
from the selected voxel key, not from its representative point; the patch
radius is squared in f64 before the f32 cast.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..geom import se3
from . import cuda_gn, hashmap
from .icp import neighbor_offsets
from .voxel import recip, voxel_coords

_F32 = torch.float32
_BIG = float(np.float32(1e30))  # the select stage's "unmatched" distance
MAX_VOXELS = 8  # csrc/gather_fused.cu:kMaxV


def _check(neighborhood: int, n_voxels: int, loss: str) -> None:
    if neighborhood not in (7, 27):
        raise ValueError(f"fused gather: neighborhood {neighborhood} (7 or "
                         "27)")
    if not 1 <= n_voxels <= MAX_VOXELS:
        raise ValueError(f"fused gather: n_voxels {n_voxels} (1 to "
                         f"{MAX_VOXELS})")
    if loss not in ("plane", "point"):
        raise ValueError(f"fused gather: loss {loss!r}")


def fused_radius2(radius: float) -> float:
    """K6's patch radius^2: squared in f64, then cast to f32
    (``pallas_gather.py:354-357``); K3 squares in f32
    (``cuda_gn._radius2``). The two differ by an ulp at 1.05 m."""
    return float(np.float32(radius * radius))


def select_voxels_torch(vmap_: hashmap.VoxelHashMap, pts_w: torch.Tensor, *,
                        voxel_size: float, max_probes: int,
                        neighborhood: int, n_voxels: int) -> torch.Tensor:
    """The select stage's plain twin: ``aux`` int32 [5V, N]."""
    n, dev = pts_w.shape[0], pts_w.device
    keys = voxel_coords(pts_w, voxel_size)[:, None, :] \
        + neighbor_offsets(neighborhood, dev)[None]          # [N, J, 3]
    slot, cnt, rep, found = hashmap.probe(vmap_, keys, max_probes,
                                          miss_slot=0)
    dx, dy, dz = (rep[..., i] - pts_w[:, None, i] for i in range(3))
    d = torch.where(found, dx * dx + dy * dy + dz * dz, _BIG)
    out_slot, out_cnt, out_key = [], [], []
    for _ in range(n_voxels):
        j = torch.argmin(d, 1, keepdim=True)          # the first minimum
        ok = d.gather(1, j)[:, 0] < _BIG
        out_slot.append(slot.gather(1, j)[:, 0])
        out_cnt.append(torch.where(ok, cnt.gather(1, j)[:, 0], 0))
        out_key.append(keys.gather(1, j[..., None].expand(n, 1, 3))[:, 0])
        d = d.scatter(1, j, _BIG)
    key = torch.stack(out_key, 1)                             # [N, V, 3]
    return torch.cat([torch.stack(out_slot), torch.stack(out_cnt),
                      key.permute(2, 1, 0).reshape(3 * n_voxels, n)]
                     ).to(torch.int32)


def prep_selected_torch(vmap_: hashmap.VoxelHashMap, pts_w: torch.Tensor,
                        source_mask: torch.Tensor, aux: torch.Tensor, *,
                        voxel_size: float, radius2: float, loss: str
                        ) -> cuda_gn.PreppedCandidates:
    """The prep stage's plain twin."""
    n = pts_w.shape[0]
    v = aux.shape[0] // 5
    ppv = vmap_.points.shape[1]
    corner = aux[2 * v:].reshape(3, v, n).permute(2, 1, 0)    # [N, V, 3]
    packed = vmap_.points[aux[:v].T.long()]                   # [N, V, P]
    pts = hashmap.unpack_points(packed, corner[:, :, None, :], voxel_size)
    valid = (torch.arange(ppv, device=pts_w.device)
             < aux[v:2 * v].T[..., None])                     # [N, V, P]
    cx, cy, cz = (pts[..., i].reshape(n, v * ppv).T.contiguous()
                  for i in range(3))
    inf = torch.where(valid, 0.0, _BIG).to(_F32).reshape(
        n, v * ppv).T.contiguous()
    feat = (cuda_gn.plane_feat_torch(pts_w, source_mask, cx, cy, cz, inf,
                                     radius2) if loss == "plane"
            else cuda_gn.point_feat_torch(source_mask))
    return cuda_gn.PreppedCandidates(feat, cx, cy, cz, inf)


def _twin(vmap_, pts_w, source_mask, *, voxel_size, max_probes,
          neighborhood, n_voxels, radius2, loss, aux=None):
    """The select and prep twins in turn; ``aux`` receives the
    selection."""
    sel = select_voxels_torch(vmap_, pts_w, voxel_size=voxel_size,
                              max_probes=max_probes,
                              neighborhood=neighborhood, n_voxels=n_voxels)
    if aux is not None:
        aux.copy_(sel)
    return prep_selected_torch(vmap_, pts_w, source_mask, sel,
                               voxel_size=voxel_size, radius2=radius2,
                               loss=loss)


def gather_fused(vmap_: hashmap.VoxelHashMap, pts_w: torch.Tensor,
                 source_mask: torch.Tensor, *, voxel_size: float,
                 max_probes: int, neighborhood: int, n_voxels: int,
                 radius2: float, loss: str,
                 aux: torch.Tensor | None = None
                 ) -> cuda_gn.PreppedCandidates:
    """K6 on the query points ``pts_w`` [N, 3] (the source at the gather
    pose): one launch of ``gather_fused`` on CUDA tensors; CPU tensors take
    the two twins. ``aux`` (int32 [5V, N]), when given, also receives the
    selection; the path passes none."""
    if kernels.device_kind(pts_w, "gather_fused") == "cpu":
        return _twin(vmap_, pts_w, source_mask, voxel_size=voxel_size,
                     max_probes=max_probes, neighborhood=neighborhood,
                     n_voxels=n_voxels, radius2=radius2, loss=loss, aux=aux)
    n = pts_w.shape[0]
    cap, ppv = vmap_.points.shape
    if (pts_w.shape != (n, 3) or vmap_.meta.shape != (cap, hashmap.META_W)
            or source_mask.shape != (n,)):
        raise ValueError(f"gather_fused: pts {tuple(pts_w.shape)}, mask "
                         f"{tuple(source_mask.shape)}, meta "
                         f"{tuple(vmap_.meta.shape)}")
    if aux is not None and aux.shape != (5 * n_voxels, n):
        raise ValueError(f"gather_fused: aux {tuple(aux.shape)}")
    dev = pts_w.device
    feat = torch.empty((8, n), dtype=_F32, device=dev)
    cx, cy, cz, inf = (torch.empty((n_voxels * ppv, n), dtype=_F32,
                                   device=dev) for _ in range(4))
    kernels.launch(
        "gather_fused", kernels.ptr(pts_w, "pts"),
        kernels.ptr(source_mask, "mask", torch.bool),
        kernels.ptr(vmap_.meta, "meta", torch.int32, align=16),
        kernels.ptr(vmap_.points, "points", torch.int32),
        None if aux is None else kernels.ptr(aux, "aux", torch.int32),
        kernels.ptr(feat, "feat"), kernels.ptr(cx, "cx"),
        kernels.ptr(cy, "cy"), kernels.ptr(cz, "cz"),
        kernels.ptr(inf, "inf"), n, cap, neighborhood, max_probes,
        n_voxels, ppv, recip(voxel_size), voxel_size, radius2,
        int(loss == "plane"))
    return cuda_gn.PreppedCandidates(feat, cx, cy, cz, inf)


def _gather(fused, vmap_, source, source_mask, t_gather, *, voxel_size,
            max_probes, neighborhood, n_voxels, plane_radius, loss):
    _check(neighborhood, n_voxels, loss)
    pts_w = se3.transform(t_gather.to(_F32), source.to(_F32)).contiguous()
    return fused(vmap_, pts_w, source_mask, voxel_size=voxel_size,
                 max_probes=max_probes, neighborhood=neighborhood,
                 n_voxels=n_voxels, radius2=fused_radius2(plane_radius),
                 loss=loss)


def gather_prep_fused_torch(vmap_: hashmap.VoxelHashMap,
                            source: torch.Tensor, source_mask: torch.Tensor,
                            t_gather: torch.Tensor, *, voxel_size: float,
                            max_probes: int = 1, neighborhood: int = 7,
                            n_voxels: int = 4, plane_radius: float,
                            loss: str = "plane"
                            ) -> cuda_gn.PreppedCandidates:
    """K6's plain twin on any device: the select and prep twins after the
    transform of ``source`` [N, 3] to the gather pose."""
    return _gather(_twin, vmap_, source, source_mask, t_gather,
                   voxel_size=voxel_size, max_probes=max_probes,
                   neighborhood=neighborhood, n_voxels=n_voxels,
                   plane_radius=plane_radius, loss=loss)


def gather_prep_fused(vmap_: hashmap.VoxelHashMap, source: torch.Tensor,
                      source_mask: torch.Tensor, t_gather: torch.Tensor, *,
                      voxel_size: float, max_probes: int = 1,
                      neighborhood: int = 7, n_voxels: int = 4,
                      plane_radius: float, loss: str = "plane"
                      ) -> cuda_gn.PreppedCandidates:
    """K6: the candidates of ``source`` [N, 3] gathered at ``t_gather``,
    lane-major and with the patch plane fit, in one launch on CUDA tensors
    (:func:`gather_fused`); CPU tensors take :func:`gather_prep_fused_torch`.
    """
    return _gather(gather_fused, vmap_, source, source_mask, t_gather,
                   voxel_size=voxel_size, max_probes=max_probes,
                   neighborhood=neighborhood, n_voxels=n_voxels,
                   plane_radius=plane_radius, loss=loss)
