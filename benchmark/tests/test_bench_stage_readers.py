"""The readers of the program's stage clock (``layers/*``: the front end,
the map insert, the EKF, the ICP, the replay's wait between steps, the
online step and the online wait) on a synthetic traced run: values from
given totals, and None without a traced stretch or where the program
keeps no stage clock."""
from __future__ import annotations

import types

import pytest

from benchmark.harness import spec
from benchmark.harness import trace as bench_trace
from ptudes_tpu_torch.utils import trace

# ns of each stage over a stretch of 250 steps of 4 replicas (1000 scans)
TOTALS = {"graph.io": (250, 2_000_000), "ekf.predict": (250, 3_000_000),
          "frontend": (250, 40_000_000), "icp": (250, 120_000_000),
          "map.insert": (250, 30_000_000), "ekf.update": (250, 5_000_000),
          trace.BETWEEN: (249, 10_000_000)}
STEP_NS = 200_000_000
WANT = {
    "frontend_us_per_scan": 40.0,
    "map_insert_us_per_scan": 30.0,
    "ekf_us_per_scan": 8.0,
    "icp_us_per_scan": 120.0,
    "step_gap_pct.replay": 100.0 * 10 / 210,
    "step_ms.online": STEP_NS * 1e-6 / 1000,
    "host_gap_ms.online": 10.0 / 249,
}


def _run(scans: int | None):
    stretch = None if scans is None else bench_trace.Stretch(
        window_s=1.0, busy_s=0.5, device_ops=10, by_name={}, gaps=[],
        scans=scans)
    return types.SimpleNamespace(stretch=stretch)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_its_value_from_the_totals(name, monkeypatch):
    monkeypatch.setattr(trace, "stages", lambda: dict(TOTALS))
    assert sum(TOTALS[k][1] for k in trace.STAGES) == STEP_NS
    reader = spec.layer_reader(name)
    assert reader.read(_run(1000)) == pytest.approx(WANT[name])
    assert reader.read(_run(None)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_silent_without_a_stage_clock(name, monkeypatch):
    """A program that timed no stage (tracing off, or a program without the
    stage clock) gives None, not an error."""
    monkeypatch.setattr(trace, "stages", dict)
    assert spec.layer_reader(name).read(_run(1000)) is None


def test_every_reader_is_in_the_benchmark():
    names = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in WANT:
        m = names[name]
        assert m["source"] == "program_counter"
        assert m["moves"] == ("scan_latency_p95_ms" if name.endswith(
            ".online") else "scans_per_s")
