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
    semidefinite system stays finite."""
    n = 6
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                l[i][j] = s / l[j][j]
    bb = b[:, None] if b.ndim == 1 else b
    y = [None] * n
    for i in range(n):
        s = bb[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    out = torch.stack(x, 0)
    return out[:, 0] if b.ndim == 1 else out
