"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration file, its traffic file (``traffic/<name>.json``), the
driver and the scene kind that file names (``drivers/<driver>.py``,
``scenes/<kind>.py``), its correctness limits (``limits/<cell>.json``),
the reader of each per-layer metric (``layers/<metric>.py``) and each
kernel's count (``kernels/<k>.py``). A later cell, mix, driver, scene,
metric or kernel is new files and new entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return by_name(bench["workloads"], name, "workload")


def config_file(bench: dict, cell_: dict, root: str = ROOT) -> dict:
    entry = by_name(bench["configs"], cell_["config"], "configuration")
    return load_json(os.path.join(root, entry["file"]))


def traffic_file(cell_: dict, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "traffic", cell_["traffic"] + ".json"))


def limits_file(cell_: dict, here: str = HERE) -> dict | None:
    path = os.path.join(here, "limits", cell_["name"] + ".json")
    return load_json(path) if os.path.exists(path) else None


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a traced run of the cell reports: those that
    list it, or list no cells and move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def load_module(path: str, tag: str):
    """The Python file at ``path`` as a module of its own."""
    name = "benchmark_" + tag + "_" + "".join(
        ch if ch.isalnum() else "_" for ch in os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(folder: str, name: str, what: str, here: str):
    path = os.path.join(here, folder, name + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no {what} {name!r}: {folder}/{name}.py is not in "
                       "the benchmark")
    return load_module(path, folder)


def driver(name: str, here: str = HERE):
    """``drivers/<name>.py``: its ``run(ctx)`` makes the cell's recordings,
    sets up, runs the window and returns a ``window.Window``."""
    return _named("drivers", name, "driver", here)


def scene_kind(kind: str, here: str = HERE):
    """``scenes/<kind>.py``: its ``recording(ctx, seed, scene)`` makes one
    recording of the traffic file's ``scene`` parameters."""
    return _named("scenes", kind, "scene kind", here)


def layer_reader(metric: str, here: str = HERE):
    """``layers/<metric>.py``: its ``read(run)`` gives the metric's value,
    or None where the run holds nothing to read."""
    return _named("layers", metric, "per-layer metric reader", here)


def kernel_count(kernel: str, here: str = HERE):
    """``kernels/<kernel>.py``: ``SYMBOL``, ``n_bytes`` and ``flops``."""
    return _named("kernels", kernel, "kernel count", here)
