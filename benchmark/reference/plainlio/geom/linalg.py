"""Tiny fixed-size linear algebra (``ptudes_tpu.geom.linalg``).

An unrolled Cholesky instead of ``torch.linalg``: the library solvers check
their ``info`` result on the host, which would synchronise the scan step.
"""
from __future__ import annotations

import torch


def solve_spd6(a: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """Solve ``a x = b`` for symmetric positive-definite 6x6 ``a``; ``b`` is
    [6] or [6, K]. The sqrt argument is floored at ``eps`` so a
    semidefinite system stays finite. Leading batch dimensions ([..., 6,
    6] and [..., 6] or [..., 6, K]) solve each system with the same
    element-wise steps."""
    n = 6
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                l[i][j] = s / l[j][j]
    vec = b.ndim == a.ndim - 1
    bb = b[..., None] if vec else b
    lc = [[None if x is None else x[..., None] for x in row] for row in l]
    y = [None] * n
    for i in range(n):
        s = bb[..., i, :]
        for k in range(i):
            s = s - lc[i][k] * y[k]
        y[i] = s / lc[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - lc[k][i] * x[k]
        x[i] = s / lc[i][i]
    out = torch.stack(x, -2)
    return out[..., 0] if vec else out
