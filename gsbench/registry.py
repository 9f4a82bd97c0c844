"""Finds every piece of a cell by name, so that a new configuration, mix or
metric is a new file and never an edit:

- ``BENCHMARK.json`` (the checkout's root): the cells and the metrics;
- ``configs/<config>.json``: one configuration;
- ``traffic/<mix>.json``: one traffic mix; its ``driver`` key names
  ``drivers/<driver>.py``, the general generator of that entry point;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``checks/<cell>.json``: the limits of the numbers the cell compares with
  the plain reference, and the readings they were set from.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = HERE.parent) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = HERE) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def limits(workload: str, root: Path = HERE) -> dict:
    """The limits of the numbers a cell compares: ``checks/<cell>.json``."""
    return load_json(root / "checks" / f"{workload}.json")["limits"]


def module(kind: str, name: str, root: Path = HERE):
    """The Python file ``<kind>/<name>.py`` as a module (names may hold
    dots and dashes)."""
    path = root / kind / f"{name}.py"
    key = re.sub(r"\W", "_", f"gsbench_{kind}_{name}_{path}")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = HERE):
    return module("drivers", name, root)


def metric(name: str, root: Path = HERE):
    return module("metrics", name, root)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]    # this cell's end-to-end metrics
    per_layer: List[dict]     # this cell's per-layer metrics


def _in_cell(metric_entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric_entry:
        return cell in metric_entry["workloads"]
    moves = metric_entry.get("moves")
    return moves is None or moves in e2e_names


def cell(bench: dict, workload: str, root: Path = HERE) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload, ())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _in_cell(m, workload, names)]
    cfg = config(entry["config"], root)
    cfg.setdefault("name", entry["config"])
    mix = traffic(entry["traffic"], root)
    mix.setdefault("name", entry["traffic"])
    return Cell(workload, int(entry["chips"]), cfg, mix, e2e, per)
