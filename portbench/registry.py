"""Finds the benchmark's parts by the names in BENCHMARK.json.

A cell (an entry of "workloads") names a configuration and a traffic mix.
A configuration is the JSON file that its entry of "configs" names; a
traffic mix is portbench/traffic/<name>.json; a per-layer metric's reader
is portbench/metrics/<name>.py, a module with read(run) -> float | None.
Adding any of them is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
TRAFFIC_DIR = HERE / "traffic"
METRICS_DIR = HERE / "metrics"


def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no traffic mix {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def end_to_end(bench: dict, cell: str) -> list:
    """The cell's end-to-end metrics: every cell reports each."""
    return list(bench["end_to_end"])


def per_layer(bench: dict, cell: str) -> list:
    """The cell's per-layer metrics: those whose end-to-end metric the cell
    reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"] if m["moves"] in reported]


def reader(name: str):
    """The read(run) function of metrics/<name>.py."""
    path = METRICS_DIR / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
