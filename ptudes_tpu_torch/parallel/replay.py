"""Multi-bag replay and parameter sweeps (``ptudes_tpu.parallel.replay``):
independent sequences, stacked along a leading bag axis.

The JAX package vmaps ``run_sequence`` over the bags and shards them over
the ``bag`` mesh axis. Here each bag runs through ``lio.run_sequence`` on
its own; with several cards the bags are dealt over them in turn (the
counterpart of the ``bag`` axis, ``parallel.mesh``). Per bag the result is
the single sequence's, so every configuration runs (the refresh loop, the
``"assoc"`` predict, a frozen map), unlike ``parallel.batched``.
"""
from __future__ import annotations

from ..config import PipelineConfig
from ..models import lio
from ..ops.projection import XyzLut
from ..utils import replicas


def stack_bags(items: list):
    """Stack a list of states or batches along a new leading bag axis."""
    return replicas.stack(items)


def _to(tree, device):
    """``tree``'s tensors on ``device``."""
    if hasattr(tree, "to"):
        return tree.to(device)
    if isinstance(tree, tuple):
        parts = [_to(x, device) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree


def replay_bags(states: lio.LioState, batches: lio.ScanBatch, lut: XyzLut,
                cfg: PipelineConfig, devices=None
                ) -> tuple[lio.LioState, lio.LioOut]:
    """``lio.run_sequence`` of every bag of the stacked [B, ...] ``states``
    and [B, N, ...] ``batches``; returns the stacked final states and
    outputs. ``devices``: cards to deal the bags over (bag i on
    ``devices[i % len(devices)]``, its results gathered back to the
    device of ``states``); None runs every bag where its tensors are."""
    b = batches.range_m.shape[0]
    home = batches.range_m.device
    fins, outs = [], []
    for i in range(b):
        st, bt, lt = (replicas.take(states, i), replicas.take(batches, i),
                      lut)
        if devices:
            dev = devices[i % len(devices)]
            st, bt, lt = _to(st, dev), _to(bt, dev), _to(lut, dev)
        fin, out = lio.run_sequence(st, bt, lt, cfg=cfg)
        fins.append(_to(fin, home))
        outs.append(_to(out, home))
    return replicas.stack(fins), replicas.stack(outs)
