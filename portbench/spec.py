"""Finds what ``BENCHMARK.json`` names: a cell, its configuration file, its
traffic mix file, its limits and the readers of its per-layer metrics. Each
is a file of its own, found by name, so that a later cell, configuration,
mix or metric is added as files and entries alone."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file ``BENCHMARK.json`` gives the configuration."""
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return _json(base / "traffic" / f"{name}.json")


def limits(name: str, base: Path = HERE) -> dict:
    """{number: limit} that decide ``correct`` in the cell ``name``."""
    return _json(base / "limits" / f"{name}.json")["limits"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(metric: str, base: Path = HERE) -> ModuleType:
    """The module ``metrics/<metric>.py``; its ``read(record)`` gives the
    metric's value or None where it finds nothing to read."""
    path = base / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def read_per_layer(bench: dict, cell: str, record: dict, base: Path = HERE) -> Dict[str, dict]:
    out = {}
    for m in per_layer(bench, cell):
        value = reader(m["name"], base).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
