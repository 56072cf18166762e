"""The benchmark's harness on the CPU: its files found by name, the
contract of ``BENCHMARK.json`` and of the result line, the configuration
files against the program's configurations, the torch scene against the
port's numpy scene, the kernels' counts against PERF.md's bounds, a cell
added from new files alone, and the import checks."""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.harness import main, peaks, spec, window
from benchmark.reference import step

ROOT = spec.ROOT
HERE = spec.HERE
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def rehearse(workload: str, capsys, seed: int = 2 ** 31 + 7) -> dict:
    """One CPU rehearsal of ``workload`` in this process: its result."""
    rc = main.main(["--workload", workload, "--seed", str(seed),
                    "--seconds", "0.5", "--device", "cpu"],
                   time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_finds_every_file_by_name():
    for w in BENCH["workloads"]:
        cfg = spec.config_file(BENCH, w)
        assert cfg["name"] == w["config"]
        mix = spec.traffic_file(w)
        assert callable(spec.driver(mix["driver"]).run)
        assert callable(spec.scene_kind(mix["scene"]["kind"]).recording)
        assert spec.limits_file(w) is not None
    for m in BENCH["per_layer"]:
        assert callable(spec.layer_reader(m["name"]).read)
    for k in range(1, 8):
        mod = spec.kernel_count(f"k{k}")
        assert mod.SYMBOL.endswith("_kernel")
        assert callable(mod.n_bytes) and callable(mod.flops)


@pytest.mark.parametrize("lookup", [spec.driver, spec.scene_kind,
                                    spec.layer_reader, spec.kernel_count])
def test_an_unknown_name_raises(lookup):
    with pytest.raises(KeyError, match="is not in the benchmark"):
        lookup("no_such_name")


def test_state_leaves_follow_the_programs_layout():
    """The harness flattens a program state in the order of the program's
    own leaf list (the layout the reference's ``state_from_leaves``
    reads)."""
    from ptudes_tpu_torch import config
    from ptudes_tpu_torch.models import lio
    from ptudes_tpu_torch.utils import convert, replicas
    cfg = config.bench_config()
    cfg = dataclasses.replace(cfg, cap=dataclasses.replace(
        cfg.cap, map_capacity=1 << 10))
    state = lio.init_state(cfg, "cpu")
    want = convert.lio_state_leaves(state)
    got = window.leaves(state)
    assert len(got) == len(want) == len(step.LEAF_DTYPES)
    assert all(a is b for a, b in zip(got, want))
    pair = replicas.stack([state, state])
    assert all(torch.equal(a, b) for a, b in zip(
        window.leaves(pair, 1), convert.lio_state_leaves(
            replicas.take(pair, 1))))


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, two
    # compiles of 90 s a cell and 1200 s spare, with 24 cells
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(x) for x in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == n
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m \
            else True
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert m["moves"] in [x["name"] for x in
                                  spec.end_to_end(BENCH, c)]
    for c in CELLS:
        reported = [m["name"] for m in spec.end_to_end(BENCH, c)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(BENCH, c)
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("name,make", [
    ("ouster128_cli", lambda c: c.cli_config(128, 1024)),
    ("ouster128_bench", lambda c: c.bench_config())])
def test_config_files_build_todays_configs(name, make):
    from ptudes_tpu_torch import config
    d = spec.load_json(os.path.join(HERE, "configs", name + ".json"))
    ctx_cfg = main.Context.__new__(main.Context)
    ctx_cfg.config, ctx_cfg.device = d, torch.device("cpu")
    main.Context.__post_init__(ctx_cfg)
    assert ctx_cfg.cfg == make(config)
    # the reference reads the same values, its kernels replaced by twins
    twin = config.twin_config(make(config))
    ref = step.pipeline_config(d["pipeline"])
    assert ref.kiss.__dict__ == twin.kiss.__dict__
    assert ref.cap.__dict__ == twin.cap.__dict__
    assert ref.ekf.__dict__ == twin.ekf.__dict__
    s = d["sensor"]
    assert s["h"] * s["w"] == ctx_cfg.cfg.cap.max_points


def test_scene_matches_the_ports_numpy_render():
    from ptudes_tpu_torch.models import sim
    sen = scene.make_sensor(16, 128, 90.0)
    ref_sen = sim.make_sim_sensor(16, 128, 90.0)
    assert np.array_equal(sen.direction, ref_sen.lut.direction)
    kin = dict(radius=8.0, speed=2.0, ramp=1.0)
    ts = np.arange(6) * 0.1
    for phase in (0.0, 1.3):
        sweep = scene.circle_poses_at(ts, **kin, phase=phase)
        if phase == 0.0:
            np.testing.assert_array_equal(sweep,
                                          sim.circle_poses_at(ts, **kin))
        world = scene.make_world(3, 30.0, 40,
                                 keepout_points=sweep[:, :3, 3])
        ref_world = sim.make_sim_world(seed=3, extent=30.0, n_boxes=40,
                                       keepout_points=sweep[:, :3, 3])
        np.testing.assert_array_equal(world.box_lo, ref_world.box_lo)
        got = scene.render(world, sweep, sen, 70.0, "cpu",
                           frames_per_call=2)
        want = np.stack([sim.render_range_image(
            ref_world, sweep[i], ref_sen, max_range=70.0,
            end_pose=sweep[i + 1]) for i in range(5)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert (got > 0).mean() > 0.5
    t = np.arange(1, 50) * 0.01
    lacc, avel = scene.imu_for_circle(t, **kin)
    ref = sim.imu_for_circle(t, **kin)
    np.testing.assert_array_equal(lacc, ref.lacc)
    np.testing.assert_array_equal(avel, ref.avel)


# PERF.md's Bound column (us, bytes or operations at these shapes)
@pytest.mark.parametrize("k,args,flop_args,us,mb", [
    ("k1", (16,), (16,), 0.00097, None),
    ("k2", (), (), 0.000884, None),   # PERF.md: 0.0009, rounded
    ("k3", (2048, 32), (2048, 32), 0.595, 1.99),
    ("k4", (2048, 32), (2048, 32, 9), 0.340, 1.14),
    ("k5", (8192, 80), (8192, 80), 3.24, 10.85),
    ("k6", (2048, 32), (2048, 32, 7), 0.341, 1.14),
    ("k7", (2048, 32), (2048, 32), 0.359, 1.20),
    ("k7", (8192, 80), (8192, 80), 3.316, None)])
def test_kernel_counts_give_perf_bounds(k, args, flop_args, us, mb):
    mod = spec.kernel_count(k)
    n_bytes, flops = mod.n_bytes(*args), mod.flops(*flop_args)
    assert peaks.bound_s(n_bytes, flops) * 1e6 == pytest.approx(us,
                                                                rel=0.01)
    if mb is not None:
        assert n_bytes / 1e6 == pytest.approx(mb, rel=0.01)


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_prints_a_contract_line(workload, capsys):
    res = rehearse(workload, capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checked"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(res["device"])
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert "setup_s" in res["metrics"]
    for name, c in res["checked"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"]


def test_a_cell_added_from_new_files_runs(tmp_path):
    """A new configuration, traffic mix, per-layer metric, kernel count
    and cell, added as new files and new entries of ``BENCHMARK.json``,
    run with no file of the benchmark edited."""
    work = tmp_path / "checkout"
    shutil.copytree(HERE, work / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (work / "benchmark" / p).read_bytes()
              for p in _files(work / "benchmark")}
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(os.path.join(HERE, "configs",
                                      "ouster128_bench.json"))
    cfg["name"] = "ouster64_bench"
    cfg["sensor"]["h"] = 64
    cfg["pipeline"]["cap"]["max_points"] = 64 * 1024
    (work / "benchmark/configs/ouster64_bench.json").write_text(
        json.dumps(cfg))
    mix = spec.load_json(os.path.join(HERE, "traffic", "replay.json"))
    mix["chunk_scans"] = 5
    mix["driver"] = "replay_marked"
    mix["scene"]["kind"] = "circle_wide"
    (work / "benchmark/traffic/replay_short.json").write_text(
        json.dumps(mix))
    # a driver and a scene kind of their own, as new files
    (work / "benchmark/drivers/replay_marked.py").write_text(
        "from benchmark.harness import spec\n\n\ndef run(ctx):\n"
        "    win = spec.driver('replay').run(ctx)\n"
        "    win.marked = ctx.recs[0].gt_mid[0, 1, 3]\n"
        "    return win\n")
    (work / "benchmark/scenes/circle_wide.py").write_text(
        "from benchmark.harness import spec\n\n\n"
        "def recording(ctx, seed, geo):\n"
        "    return spec.scene_kind('circle').recording(\n"
        "        ctx, seed, dict(geo, radius_m=2 * geo['radius_m']))\n")
    (work / "benchmark/limits/b64.replay_short.json").write_text(
        (work / "benchmark/limits/bench.replay.json").read_text())
    (work / "benchmark/kernels/k8.py").write_text(
        'SYMBOL = "none_kernel"\n\n\ndef n_bytes(n):\n    return 4 * n\n'
        '\n\ndef flops(n):\n    return n\n')
    (work / "benchmark/layers/checks_run.py").write_text(
        "def read(run):\n    return float(len(run.window.checks))\n")
    (work / "benchmark/layers/start_y_m.py").write_text(
        "def read(run):\n    return float(run.window.marked)\n")
    bench["configs"].append({
        "name": "ouster64_bench", "source": "a test",
        "file": "benchmark/configs/ouster64_bench.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "b64.replay_short", "config": "ouster64_bench",
        "traffic": "replay_short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "checks_run", "unit": "checks", "better": "higher",
        "source": "host_clock", "layer": "driver", "moves": "scans_per_s",
        "workloads": ["b64.replay_short"]})
    bench["per_layer"].append({
        "name": "start_y_m", "unit": "m", "better": "higher",
        "source": "host_clock", "layer": "driver", "moves": "scans_per_s",
        "workloads": ["b64.replay_short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "scans_per_s":
            m["workloads"].append("b64.replay_short")
    (work / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=ROOT)
    for trace in ("0", "1"):
        r = subprocess.run(
            [sys.executable, str(work / "benchmark/run.py"), "--workload",
             "b64.replay_short", "--seed", "5", "--seconds", "0.5",
             "--trace", trace, "--device", "cpu"],
            cwd=work, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        res = json.loads(r.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        if trace == "1":
            assert res["metrics"]["checks_run"]["value"] >= 1
            # the new driver ran, on the new scene: the first mid-sweep
            # pose lies on the circle of twice the radius
            phase = np.random.default_rng(5).uniform(0.0, 2.0 * np.pi)
            want = scene.circle_poses_at(
                [0.05], radius=2 * mix["scene"]["radius_m"], speed=2.0,
                ramp=1.0, phase=phase)[0, 1, 3]
            assert res["metrics"]["start_y_m"]["value"] == pytest.approx(
                want, rel=1e-9)
        else:
            assert "scans_per_s" in res["metrics"]
    assert spec.kernel_count("k8", str(work / "benchmark")).n_bytes(2) == 8
    for p, data in before.items():
        assert (work / "benchmark" / p).read_bytes() == data


def _files(root):
    return [os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d]


def _imports(path: str) -> set[str]:
    """Top-level names of the modules a Python file imports (absolute
    imports only; relative ones stay inside their package)."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    """No file of the benchmark imports JAX, its libraries or the JAX
    package (top-level names compared whole: the port's name begins with
    the JAX package's); the reference imports nothing of the program
    either."""
    for path in _files(HERE):
        if not path.endswith(".py"):
            continue
        names = _imports(os.path.join(HERE, path))
        assert not names & set(main.FORBIDDEN), (path, names)
        if path.startswith("reference"):
            assert "ptudes_tpu_torch" not in names, path
            assert "benchmark" not in names, path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ptudes_tpu_torch_fake", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ptudes_tpu.models", sys)
    assert main.forbidden_modules() == ["ptudes_tpu.models"]


def test_a_run_loads_no_jax():
    """A whole rehearsal in a fresh process leaves no module of JAX or the
    JAX package loaded, and the reference run loads nothing of the
    program."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.harness import main\n"
        "rc = main.main(['--workload', 'cli.replay', '--seed', '3',"
        " '--seconds', '0.5', '--device', 'cpu'], time.perf_counter())\n"
        "assert rc == 0\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'ptudes_tpu'})\n"
        "print('LOADED', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=dict(
                           os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.reference import step\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'ptudes_tpu', 'ptudes_tpu_torch'}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert "LOADED []" in r.stdout, r.stderr[-3000:]


def test_no_card_gives_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "cli.replay", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_large_seeds_give_the_same_recording():
    sen = scene.make_sensor(8, 64, 90.0)
    kw = dict(n_scans=3, scan_dt=0.1, imu_dt=0.01, radius=8.0, speed=2.0,
              ramp=1.0, extent=30.0, n_boxes=10, world_seed=0,
              max_range=70.0, noise_std=0.01, device="cpu")
    a = scene.circle_recording(2 ** 33 + 5, sen, **kw)
    b = scene.circle_recording(2 ** 33 + 5, sen, **kw)
    c = scene.circle_recording(2 ** 33 + 6, sen, **kw)
    assert np.array_equal(a.scans, b.scans)
    assert not np.array_equal(a.scans, c.scans)
    np.testing.assert_array_equal(a.imu_lacc, c.imu_lacc)


class _FakeRun:
    """A traced run's view for the layer readers, from numbers."""

    def __init__(self, cfg, replicas, by_name, scans, aux, k5):
        from benchmark.harness import trace as tr
        self.stretch = tr.Stretch(window_s=1.0, busy_s=0.5, device_ops=10,
                                  by_name=by_name, gaps=[], scans=scans)
        self.ctx = type("C", (), dict(cfg=cfg, device_kind=None,
                                      traffic={"replicas": replicas}))
        self.window = type("W", (), dict(stretch_k5=k5))
        self._aux = aux

    def kernel(self, name):
        return spec.kernel_count(name)

    def aux(self, field):
        return np.asarray(self._aux[field])


@pytest.mark.parametrize("held", [250, 249])
def test_k5_readers_hold_when_the_trace_drops_a_record(held):
    """Per held launch the same share and time a scan whether the trace
    holds every first build of a scan's loop or drops one."""
    from ptudes_tpu_torch import config
    cfg = config.cli_config(128, 1024)
    aux = {"source_count": [2000] * 1000, "iterations": [4] * 1000}
    run = _FakeRun(cfg, 4, {"void gn_iter_kernel<1>(float*)": (
        held, held * 12e-6)}, 1000, aux, 1300)
    share = spec.layer_reader("k5_roofline_pct").read(run)
    us = spec.layer_reader("k5_us_per_scan").read(run)
    one = peaks.bound_s(spec.kernel_count("k5").n_bytes(2000, 80),
                        spec.kernel_count("k5").flops(2000, 80))
    assert share == pytest.approx(100 * 4 * one / 12e-6)
    assert us == pytest.approx(12.0 * 1300 / 1000)
    run = _FakeRun(config.bench_config(), 1, {"icp_loop_kernel": (
        held, held * 35e-6)}, 250, {"source_count": [2048] * 250,
                                    "iterations": [5] * 250}, 0)
    assert spec.layer_reader("k4_us_per_scan").read(run) == \
        pytest.approx(35.0)
    k4 = spec.kernel_count("k4")
    assert spec.layer_reader("k4_roofline_pct").read(run) == pytest.approx(
        100 * peaks.bound_s(k4.n_bytes(2048, 32), k4.flops(2048, 32, 5))
        / 35e-6)
