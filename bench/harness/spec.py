"""A cell as ``BENCHMARK.json`` names it, and the data files it is made of.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by its name:
``configs/<name>.json`` (through the configuration's ``file``),
``traffic/<name>.json`` and ``metrics/<name>.py``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]      # the entries this cell reports
    per_layer: list[dict]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(by_name)})")
    w = by_name[name]
    [cfg] = [c for c in spec["configs"] if c["name"] == w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def reader(name: str, root: Path = ROOT):
    """The module of ``metrics/<name>.py``; its ``read(window)`` returns the
    metric's value, or None where the run has nothing to read."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
