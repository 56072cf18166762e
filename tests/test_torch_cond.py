"""PyTorch port: the graph form's conditional nodes (``models.graph``'s
``while_node`` and ``if_node``) on the CPU.

A CUDA graph cannot be captured here, so the loops and branches run in
their capture-free form (``graph.run_static``, a runner's
``capture=False``): a host ``while`` and ``if`` on the same flags, the same
body code and the same in-place carry as the captured WHILE and IF nodes.
Each graph form against the eager loop it replaces, bit for bit:

- the candidate-refresh loop (``icp._register_refresh``) on
  tests/test_pallas_icp.py's scene, where the re-gather fires and the loop
  converges before its cap; also with a cap it stops at;
- the batched refresh loop (``icp.register_frames_refresh_batched``) on
  tests/test_torch_batched_refresh.py's B = 3 flat table, whose replicas
  converge and re-gather at different iterations (replica 1 never), and
  each replica against the single loop's iterations and re-gathers;
- the every-iteration registration (``icp.register_frame``,
  ``nn_mode="every"``), point and plane;
- ``hashmap.insert_deduped`` with its overflow chunks under IF nodes
  against the all-chunk insert, tables bit for bit, with 1 and 3 chunks
  needed, and the flat B-map table's per-replica chunks.

The 12-scan sequence at ``cli_config``'s structure through a
``capture=False`` runner, against the eager loop and JAX, is in
tests/test_torch_refresh.py beside its JAX run.
"""
import numpy as np
import pytest
import torch

from ptudes_tpu_torch import kernels
from ptudes_tpu_torch.models import graph
from ptudes_tpu_torch.ops import hashmap, icp
from test_torch_batched import CAP
from test_torch_batched_refresh import ICP_KW as BATCH_KW
from test_torch_batched_refresh import _refresh_inputs
from test_torch_refresh import ICP_KW, icp_scene  # noqa: F401

torch.set_num_threads(2)


def _equal(a, b):
    la, lb = graph.leaves(a), graph.leaves(b)
    assert len(la) == len(lb) > 0
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _both(fn, *args, **kw):
    """``fn`` eagerly (its host reads counted) and in its graph form:
    (eager result, its REFRESH_COUNTS, graph result, the graph's counts by
    name)."""
    icp.reset_refresh_counts()
    eager = fn(*args, **kw)
    counts = dict(icp.REFRESH_COUNTS)
    icp.reset_refresh_counts()
    got, cond = graph.run_static(fn, *args, **kw)
    assert icp.REFRESH_COUNTS["host_reads"] == 0
    assert icp.REFRESH_COUNTS["regathers"] == cond.get("regathers", 0)
    return eager, counts, got, cond


@pytest.mark.parametrize("max_iterations", [30, 4])
def test_refresh_loop_graph_form(icp_scene, max_iterations):
    """The refresh loop's WHILE and IF forms against the eager loop, bit
    for bit: the pose, correspondences, iterations, deviation; the same
    re-gathers; one WHILE body a GN iteration. At 30 iterations the loop
    re-gathers and converges before the cap, at 4 it stops at the cap."""
    _, (pm, tsrc, tmask, tguess) = icp_scene
    kw = dict(ICP_KW, max_iterations=max_iterations)
    eager, counts, got, cond = _both(
        icp.register_frame_cached, tsrc, tmask, pm, tguess,
        torch.tensor(0.5), torch.tensor(0.1667), form="cuda", **kw)
    _equal(got, eager)
    iters = int(eager.iterations)
    assert counts["regathers"] >= 1 and cond["regathers"] == \
        counts["regathers"]
    assert cond["gn_iter"] == iters
    capped = iters == max_iterations
    assert capped == (max_iterations == 4)
    # a read a GN iteration from the second on, and the one that stops it
    assert counts["host_reads"] == iters - capped


@pytest.mark.parametrize("loss", ["plane", "point"])
def test_refresh_batched_graph_form(loss):
    """The batched loop's WHILE form, the re-gather of all replicas under
    an IF node with the stale ones' rows taken, against the eager loop's
    subset gather, bit for bit; each replica's iterations and re-gathers
    the single loop's (replica 1 never re-gathers, 0 and 2 do, and they
    converge at different iterations)."""
    tm, src, smask, guess, max_d, kern, base = _refresh_inputs()
    kw = dict(BATCH_KW, loss=loss, refresh_drift=0.5, form="cuda",
              slot_base=base, logical_capacity=CAP)
    eager, counts, got, cond = _both(
        icp.register_frames_refresh_batched, src, smask, tm, guess, max_d,
        kern, **kw)
    _equal(got, eager)
    assert cond["regathers"] == counts["regathers"]
    assert cond["gn_iter"] == int(eager.iterations.max())
    single = []
    for i in range(3):
        one, c1, _, _ = _both(
            icp.register_frame_cached, src[i], smask[i], tm, guess[i],
            max_d[i], kern[i], slot_base=base[i],
            **{k: v for k, v in kw.items() if k != "slot_base"})
        assert int(one.iterations) == int(eager.iterations[i])
        single.append(c1["regathers"])
    assert single[1] == 0 and min(single[0], single[2]) >= 1
    assert sum(single) == cond["regathers"]
    assert len(set(eager.iterations.tolist())) > 1


@pytest.mark.parametrize("loss", ["point", "plane"])
def test_every_iteration_graph_form(icp_scene, loss):
    """``register_frame`` (a map query every GN iteration) as a WHILE
    node against its host loop, bit for bit; one body a GN iteration."""
    _, (pm, tsrc, tmask, tguess) = icp_scene
    eager, counts, got, cond = _both(
        icp.register_frame, tsrc, tmask, pm, tguess, torch.tensor(0.5),
        torch.tensor(0.1667), voxel_size=0.3, max_probes=2,
        max_iterations=30, convergence=1e-4, loss=loss,
        prior_rot_weight=0.01, prior_trans_weight=0.01)
    _equal(got, eager)
    iters = int(eager.iterations)
    assert cond["every_iter"] == iters and 1 < iters < 30
    assert counts["host_reads"] == iters


def _frame(rng, n, spread):
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.2
    return torch.from_numpy(pts)


@pytest.mark.parametrize("n_new, chunks", [(700, 0), (2500, 2)])
def test_insert_if_chunks(n_new, chunks):
    """The overflow chunks under IF nodes on ``c < needed`` against the
    all-chunk insert: the tables bit for bit, ``chunks`` IF bodies run
    (1 and 3 chunks needed of 4), with the fused eviction."""
    rng = np.random.default_rng(3)
    m = hashmap.create(1 << 14, 20, "cpu")
    m = hashmap.insert_deduped(m, _frame(rng, 800, 8.0),
                               torch.ones(800, dtype=torch.bool),
                               voxel_size=0.3, new_capacity=1024)
    pts = _frame(rng, 4096, 14.0)
    mask = torch.zeros(4096, dtype=torch.bool)
    mask[:n_new] = True
    kw = dict(voxel_size=0.3, max_probes=2, new_capacity=1024,
              overflow="cond", evict_origin=torch.zeros(3),
              evict_r2=torch.tensor(400.0))
    eager = hashmap.insert_deduped(m, pts, mask, **kw)
    got, cond = graph.run_static(hashmap.insert_deduped, m, pts, mask, **kw)
    _equal(got, eager)
    assert cond.get("chunks", 0) == chunks
    grew = int(hashmap.num_points(eager)) - int(hashmap.num_points(m))
    assert grew > 1024 * chunks


def test_insert_if_chunks_flat_table():
    """The flat B-map table's insert (``insert_deduped_batched``) with IF
    chunks: needed is the most any replica fills, each replica's chunks
    its own; tables bit for bit."""
    rng = np.random.default_rng(5)
    b = 2
    m = hashmap.create(b * (1 << 13), 20, "cpu")
    pts = torch.stack([_frame(rng, 2048, 12.0), _frame(rng, 2048, 5.0)])
    mask = torch.ones((b, 2048), dtype=torch.bool)
    mask[1, 300:] = False
    kw = dict(voxel_size=0.3, max_probes=2, new_capacity=512,
              overflow=True, logical_capacity=1 << 13)
    eager = hashmap.insert_deduped_batched(m, pts, mask, **kw)
    got, cond = graph.run_static(hashmap.insert_deduped_batched, m, pts,
                                 mask, **kw)
    _equal(got, eager)
    per = hashmap.replica_points(eager, b)
    assert int(per[0]) > 2 * 512 and int(per[1]) < 512
    assert cond["chunks"] >= 2


def test_conditional_layer_registration():
    """The predicate kernel is counted as its own kernel and bound beside
    the others; its host functions are not kernels; a node outside a
    runner raises."""
    assert "graph_cond" in kernels.KERNELS
    assert "ptudes_graph_cond" in kernels._SIGNATURES
    assert not set(kernels._HOST_SIGNATURES) & set(kernels._SIGNATURES)
    assert not graph.conditional_form()
    with pytest.raises(RuntimeError, match="outside"):
        graph.if_node("x", torch.ones((), dtype=torch.bool), lambda: None)
    with pytest.raises(ValueError, match="one bool or int32"):
        graph.run_static(graph.if_node, "x", torch.ones(2, dtype=torch.bool),
                         lambda: None)
