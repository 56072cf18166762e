"""Trees with a leading replica axis (the batched driver's states and
batches): one replica's view, and per-replica results stacked back."""
from __future__ import annotations

import torch


def take(tree, i: int):
    """Replica ``i`` of ``tree``: every tensor indexed on its first axis,
    named tuples and tuples rebuilt, anything else passed through."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):
        parts = [take(x, i) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree


def stack(trees: list):
    """The inverse of :func:`take` over ``trees``: tensors stacked on a
    new first axis (``None`` stays ``None``)."""
    x0 = trees[0]
    if isinstance(x0, torch.Tensor):
        return torch.stack(trees)
    if isinstance(x0, tuple):
        parts = [stack(list(z)) for z in zip(*trees)]
        return type(x0)(*parts) if hasattr(x0, "_fields") else tuple(parts)
    return x0


def per_replica(fn, b: int, *args, **kw):
    """``fn`` on each of the ``b`` replicas of the positional ``args``
    (keyword arguments shared), the results stacked: how the plain twins
    of the kernels take a replica axis."""
    return stack([fn(*(take(a, i) for a in args), **kw) for i in range(b)])
