"""The check catches the faults a cell can have: a rehearsal on the CPU
(the harness's look for a card skipped) with the program broken
underneath its timed path, and ``correct`` comes out false. One chip, so
no exchange between chips can be left out."""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.harness import main


def rehearse(workload: str, capsys) -> dict:
    rc = main.main(["--workload", workload, "--seed", "2147483659",
                    "--seconds", "0.5", "--device", "cpu"],
                   time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def state_unchanged(monkeypatch):
    """Every scan step returns the state it was given (its row as
    computed)."""
    from ptudes_tpu_torch.models import lio
    from ptudes_tpu_torch.parallel import batched
    make, make_b = lio.make_scan_step, batched.make_batched_step

    def frozen(maker):
        def wrapped(*args, **kwargs):
            step = maker(*args, **kwargs)

            def stuck(state, *a, **kw):
                _, *rest = step(state, *a, **kw)
                return (state, *rest)
            return stuck
        return wrapped

    monkeypatch.setattr(lio, "make_scan_step", frozen(make))
    monkeypatch.setattr(batched, "make_batched_step", frozen(make_b))


def pose_altered(monkeypatch):
    """Each scan's packed row gets its EKF position moved by 5 mm where
    it is produced."""
    from ptudes_tpu_torch.models import lio
    pack = lio._pack_out

    def altered(out):
        row = pack(out)
        bump = torch.zeros_like(row)
        bump[..., 16 + 3] = 0.005
        return row + bump
    monkeypatch.setattr(lio, "_pack_out", altered)


def half_batch(monkeypatch):
    """The batched replay runs the first half of its replicas and hands
    their results to the other half."""
    from ptudes_tpu_torch.parallel import batched
    from ptudes_tpu_torch.utils import replicas
    run = batched.run_sequence_batched

    def half(states, batches, lut, **kw):
        b = batches.range_m.shape[0]
        keep = b // 2
        st, out = run(replicas.stack([replicas.take(states, i)
                                      for i in range(keep)]),
                      replicas.stack([replicas.take(batches, i)
                                      for i in range(keep)]), lut, **kw)
        idx = [i % keep for i in range(b)]
        return (replicas.stack([replicas.take(st, i) for i in idx]),
                replicas.stack([replicas.take(out, i) for i in idx]))
    monkeypatch.setattr(batched, "run_sequence_batched", half)


@pytest.mark.parametrize("workload,fault", [
    ("cli.replay", state_unchanged), ("bench.replay", state_unchanged),
    ("cli.online", state_unchanged), ("cli.fleet4", state_unchanged),
    ("cli.replay", pose_altered), ("cli.online", pose_altered),
    ("cli.fleet4", pose_altered), ("cli.fleet4", half_batch)])
def test_a_broken_program_is_not_correct(workload, fault, monkeypatch,
                                         capsys):
    fault(monkeypatch)
    res = rehearse(workload, capsys)
    assert res["correct"] is False
    over = [n for n, c in res["checked"].items() if c["value"] > c["limit"]]
    assert over, res["checked"]


def test_the_unbroken_program_is_correct(capsys):
    assert rehearse("cli.fleet4", capsys)["correct"] is True
