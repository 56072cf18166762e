"""Device grids for the LIO workload (``ptudes_tpu.parallel.mesh``).

Two axes, as in the JAX package: ``bag`` (independent sequences, no
communication: ``parallel.replay`` deals bags over a grid's rows) and
``pt`` (one scan's ICP source split across ranks, the 6x6 system reduced
every GN iteration: ``parallel.sharded``, which runs one grid row as one
process group, a rank a device).
"""
from __future__ import annotations

import numpy as np
import torch


def default_devices() -> list[torch.device]:
    """Every CUDA card of this machine (none without a card)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_bags: int = 1, n_pt: int = 1, devices=None) -> np.ndarray:
    """An [n_bags, n_pt] object array of ``torch.device`` (row b: the cards
    of bag b, one ``pt`` group) from ``devices`` (default
    :func:`default_devices`), whose count must be ``n_bags * n_pt``."""
    if n_bags < 1 or n_pt < 1:
        raise ValueError(f"bag x pt grid {n_bags}x{n_pt}")
    devices = default_devices() if devices is None else \
        [torch.device(d) for d in devices]
    if n_bags * n_pt != len(devices):
        raise ValueError(f"bag x pt grid {n_bags}x{n_pt} != "
                         f"{len(devices)} devices")
    grid = np.empty((n_bags, n_pt), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // n_pt, i % n_pt] = dev
    return grid
