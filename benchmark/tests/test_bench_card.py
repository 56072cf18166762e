"""On the card: the check's control. Each cell runs at its own size with
the plain reference also computed with TF32 products (the precision below
the configurations' float32), put in the program's place; that control
must fail one of the cell's numbers, while the program passes all of
them. Run on the card: ``python -m pytest benchmark/tests -m card``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct(workload, card):
    r = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         workload, "--seed", "2147483747", "--seconds", "10", "--trace",
         "0", "--control", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()
             if x.startswith("{")]
    control = next(x for x in lines if "control" in x)["control"]
    result = lines[-1]
    limits = spec.limits_file(spec.cell(spec.benchmark(), workload))
    assert result["correct"] is True, result["checked"]
    failed = [k for k, v in control.items()
              if limits.get(k) is not None and v > limits[k]]
    assert failed, (control, limits)
