"""LIO state checkpoint and resume (``ptudes_tpu.utils.checkpoint``).

The same file as the JAX package writes: one ``.npz`` holding the state's
leaves keyed ``leaf_000`` ... in the JAX flatten order of ``LioState``
(``utils.convert.LEAVES``) and a ``__meta__`` entry, the UTF-8 bytes of a
JSON object with the format string, a tree description, the leaf count and
the caller's ``extra``. The JAX loader never parses the tree description,
so a checkpoint of either package resumes in the other: stop a run after
scan k, save, and continue it later (``ekf-bench ouster --save-state``,
then ``--resume-state``, with ``--frozen-map`` for localisation on the saved
map).
"""
from __future__ import annotations

import json

import numpy as np

from ..models.lio import LioState
from .convert import LEAVES, leaf_key, lio_state_from_numpy, \
    lio_state_leaves, lio_state_to_numpy

FORMAT = "ptudes-tpu-state-v1"
TREEDEF = "ptudes_tpu_torch LioState: " + ", ".join(p for p, _ in LEAVES)


def save_state(path: str, state: LioState, extra: dict | None = None
               ) -> None:
    """Write ``state`` (copied to the host) and ``extra`` to ``path``."""
    payload = lio_state_to_numpy(state)
    meta = {"format": FORMAT, "treedef": TREEDEF, "n_leaves": len(payload),
            "extra": extra or {}}
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_state(path: str, like: LioState) -> LioState:
    """The state saved at ``path``, on ``like``'s device. ``like`` is a
    template of the expected configuration (e.g. ``lio.init_state(cfg)``):
    the leaf count, shapes and dtypes must match it, else ``ValueError``
    (a configuration or capacity mismatch)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} checkpoint")
        leaves = [z[leaf_key(i)] for i in range(meta["n_leaves"])]
    want = lio_state_leaves(like)
    if len(leaves) != len(want):
        raise ValueError(
            f"{path}: {len(leaves)} leaves, template has {len(want)} "
            "(config/capacity mismatch?)")
    for i, (a, b, (_, dt)) in enumerate(zip(leaves, want, LEAVES)):
        if a.shape != tuple(b.shape) or a.dtype != dt:
            raise ValueError(
                f"{path}: leaf {i} is {a.shape}/{a.dtype}, template "
                f"expects {tuple(b.shape)}/{np.dtype(dt)} "
                "(config/capacity mismatch?)")
    return lio_state_from_numpy(leaves, like.kiss.pose.device)


def checkpoint_extra(path: str) -> dict:
    """The ``extra`` metadata of a checkpoint."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    return meta.get("extra", {})
