"""K8 and K9: the grid front end's voxel hashing (``csrc/voxel_grid.cu``).

- :func:`grid_prededup` (K8): :func:`voxel.window_prededup_mask` in one
  launch, the 31-bit voxel ids hashed in native uint32 into shared memory
  and compared there with each pixel's 31 causally earlier neighbours;
- :func:`voxel_key` (K9): :func:`voxel.sort_key`, the int32 key whose
  stable sort :func:`voxel.first_in_voxel_sorted` runs, in one launch.

Both take a leading replica axis ([B, N, 3] points, [B, N] masks) in the
same launch, counted once. CPU tensors take the plain torch code in
``ops.voxel``, which is also what ``KissConfig.icp_form="torch"`` runs;
the kernels' outputs equal it bit for bit.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import voxel


def _check(pts: torch.Tensor, mask: torch.Tensor, what: str) -> None:
    if (pts.dim() not in (2, 3) or pts.shape[:-1] != mask.shape
            or pts.shape[-1] != 3):
        raise ValueError(f"{what}: pts {tuple(pts.shape)}, mask "
                         f"{tuple(mask.shape)}")


def grid_prededup(pts: torch.Tensor, mask: torch.Tensor, voxel_size: float,
                  grid_hw: tuple[int, int]) -> torch.Tensor:
    """K8: the keep mask of :func:`voxel.window_prededup_mask` (its 4 x +-4
    window) of ``pts`` [(B,) H*W, 3] on an H x W grid, one launch for
    every replica."""
    if kernels.device_kind(pts, "grid_prededup") == "cpu":
        return voxel.window_prededup_mask(pts, mask, voxel_size, grid_hw)
    _check(pts, mask, "grid_prededup")
    h, w = grid_hw
    if mask.shape[-1] != h * w:
        raise ValueError(f"grid_prededup: {mask.shape[-1]} points on a "
                         f"{h} x {w} grid")
    b = mask.shape[0] if mask.dim() == 2 else 1
    pts, mask = pts.contiguous(), mask.contiguous()
    keep = torch.empty_like(mask)
    kernels.launch("grid_prededup", kernels.ptr(pts, "pts"),
                   kernels.ptr(mask, "mask", torch.bool),
                   kernels.ptr(keep, "keep", torch.bool), h, w, b,
                   voxel.recip(voxel_size))
    return keep


def voxel_key(pts: torch.Tensor, mask: torch.Tensor,
              voxel_size: float) -> torch.Tensor:
    """K9: :func:`voxel.sort_key` of ``pts`` [(B,) M, 3], int32 [(B,) M],
    one launch for every replica."""
    if kernels.device_kind(pts, "voxel_key") == "cpu":
        return voxel.sort_key(pts, mask, voxel_size)
    _check(pts, mask, "voxel_key")
    pts, mask = pts.contiguous(), mask.contiguous()
    key = torch.empty(mask.shape, dtype=torch.int32, device=pts.device)
    kernels.launch("voxel_key", kernels.ptr(pts, "pts"),
                   kernels.ptr(mask, "mask", torch.bool),
                   kernels.ptr(key, "key", torch.int32), mask.numel(),
                   voxel.recip(voxel_size))
    return key
