"""State carried across packages: numpy <-> the port's tensors.

The LIO state travels as the flattened leaves of the JAX package's
``LioState`` pytree, keyed ``leaf_000`` ... ``leaf_015`` in its flatten
order — the keys ``ptudes_tpu.utils.checkpoint.save_state`` writes, so a
JAX checkpoint's ``np.load`` result converts directly (the JSON
``__meta__`` entry is ignored).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.esekf import EkfState
from ..models.kiss import KissState
from ..models.lio import LioState
from ..ops.hashmap import VoxelHashMap
from ..ops.projection import XyzLut

# (leaf path, dtype) in JAX flatten order of LioState
LEAVES = (
    ("kiss.local_map.meta", np.int32), ("kiss.local_map.points", np.int32),
    ("kiss.pose", np.float32), ("kiss.pose_prev", np.float32),
    ("kiss.model_sse", np.float32), ("kiss.num_samples", np.int32),
    ("kiss.num_scans", np.int32),
    ("ekf.pos", np.float32), ("ekf.vel", np.float32),
    ("ekf.quat", np.float32), ("ekf.bias_gyr", np.float32),
    ("ekf.bias_acc", np.float32), ("ekf.grav", np.float32),
    ("ekf.cov", np.float32), ("ekf.imu_ts", np.float32),
    ("ekf.initialized", np.bool_),
)


def leaf_key(i: int) -> str:
    return f"leaf_{i:03d}"


def lio_state_from_numpy(tree, device) -> LioState:
    """``tree``: a mapping ``leaf_000 ...`` -> array (a checkpoint's
    ``np.load``), or a sequence of the leaves in flatten order."""
    if hasattr(tree, "keys"):
        leaves = [tree[leaf_key(i)] for i in range(len(LEAVES))]
    else:
        leaves = list(tree)
    if len(leaves) != len(LEAVES):
        raise ValueError(f"{len(leaves)} leaves, a LioState has "
                         f"{len(LEAVES)}")
    t = [torch.tensor(np.asarray(x, dt), device=device)
         for x, (_, dt) in zip(leaves, LEAVES)]
    return LioState(
        kiss=KissState(VoxelHashMap(t[0], t[1]), *t[2:7]),
        ekf=EkfState(*t[7:]))


def lio_state_leaves(state: LioState) -> list[torch.Tensor]:
    """The state's tensors in ``LEAVES`` order."""
    k = state.kiss
    return [k.local_map.meta, k.local_map.points, k.pose, k.pose_prev,
            k.model_sse, k.num_samples, k.num_scans, *state.ekf]


def lio_state_to_numpy(state: LioState) -> dict[str, np.ndarray]:
    """The inverse: ``leaf_000 ...`` -> numpy array."""
    return {leaf_key(i): x.detach().cpu().numpy().astype(dt)
            for i, (x, (_, dt)) in enumerate(zip(lio_state_leaves(state),
                                                 LEAVES))}


def lut_from_numpy(lut, device) -> XyzLut:
    """A projection LUT (direction, offset [H, W, 3]) as f32 tensors."""
    return XyzLut(*(torch.tensor(np.asarray(x, np.float32), device=device)
                    for x in lut))
