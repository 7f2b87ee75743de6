"""A cell, found by name: ``BENCHMARK.json``'s entry, its configuration's
file, its traffic mix's file, and the metrics it reports.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` or a data file
gives it: ``configs/<config>.json``, ``traffic/<mix>.json``, and the
generators and readers those name, ``topologies/<kind>.py``,
``tenants/<gen>.py``, ``feeds/<gen>.py`` and ``metrics/<metric>.py``
(:func:`plugin`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_PLUGINS = {}


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: tuple  # BENCHMARK.json entries this cell reports
    per_layer: tuple


def _load(path):
    with open(path) as f:
        return json.load(f)


def plugin(kind: str, name: str):
    """The module ``bench/<kind>/<name>.py``, loaded once."""
    if not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    key = (kind, name)
    if key not in _PLUGINS:
        path = os.path.join(BENCH_DIR, kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind} named {name!r} ({path})")
        mod_name = "bench_{}_{}".format(kind, re.sub(r"\W", "_", name))
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PLUGINS[key] = mod
    return _PLUGINS[key]


def _reports(metric: dict, cell: str, end_to_end=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or metric["moves"] in end_to_end


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` as ``BENCHMARK.json`` at ``root`` names it."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    end_to_end = tuple(m for m in bench["end_to_end"]
                       if _reports(m, workload))
    names = {m["name"] for m in end_to_end}
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=end_to_end,
        per_layer=tuple(m for m in bench["per_layer"]
                        if _reports(m, workload, names)))
