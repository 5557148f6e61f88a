"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and the readers of its metrics
(``metrics/<metric>.py``).  A new cell, configuration, mix or metric is
a new entry and a new file; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def mix(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: an end-to-end
    metric without a ``workloads`` list is every cell's (``setup_s``); a
    per-layer metric is reported in the cells it lists."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable[[dict], object]:
    """``read(record)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(bench: dict, workload: str, kind: str, record: dict,
                 bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """Every metric of ``kind`` the cell reports, read from ``record``;
    a reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in metrics_of(bench, workload, kind):
        value = reader(m["name"], bench_dir)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
