"""The benchmark's entries, found by name.

``BENCHMARK.json`` at the repository root names the cells, configurations
and metrics.  Everything that belongs to one of them sits in a file of its
own that the harness finds by that name:

* ``benchmark/workloads/<cell>.json``: the cell's limits of correctness and
  how many rounds its traced run profiles;
* the configuration's ``file`` (``benchmark/configs/<config>.json``): the
  model's sizes, the launcher script, the method as it must run, and what
  was assumed;
* ``benchmark/traffic/<traffic>.json``: the parameters of the fixture the
  generator (``inputs.py``) writes;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, with its
  layer, unit, direction, source and the end-to-end metric it moves.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK_JSON = REPO / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None, root: Path = HERE) -> Cell:
    """Cell ``name`` of ``bench`` (by default ``BENCHMARK.json``) with its
    files under ``root``."""
    bench = load_json(BENCHMARK_JSON) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in the benchmark (cells: {sorted(entries)})")
    entry = entries[name]
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config_file = REPO / config_entry["file"] if root == HERE else root / "configs" / Path(
        config_entry["file"]).name
    return Cell(
        name=name, entry=entry,
        workload=load_json(root / "workloads" / f"{name}.json"),
        config=load_json(config_file),
        traffic=load_json(root / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_metric(name: str, root: Path = HERE):
    """The reader module ``<root>/metrics/<name>.py``."""
    module = f"{__package__}.metrics.{name}"
    if module in sys.modules:
        return sys.modules[module]
    spec = importlib.util.spec_from_file_location(module, root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod
