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
* ``benchmark/archs/<kind>.py``, by the configuration's ``arch.kind``: the
  image tower's checkpoint leaves, its multiply-adds and attention calls per
  image, and its plain float32 reference;
* ``benchmark/modalities/<modality>.py``, by the traffic's ``modality``: how
  a split's stored arrays are made and named, what the dataset gives the
  model, images per sample, and the reference's front end before the tower;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, with its
  layer, unit, direction, source and the end-to-end metric it moves.

Plug-ins are looked up by name in the folders of ``PLUGIN_ROOTS``, in
order (the harness's own folder; a test may put a root of its own first);
a module is loaded once for each file, so a plug-in of another root never
stands in for the harness's own of the same name.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK_JSON = REPO / "BENCHMARK.json"
PLUGIN_ROOTS = [HERE]  # where plug-ins are looked up, in order


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
    data files (configuration, traffic, workload) under ``root``."""
    bench = load_json(BENCHMARK_JSON) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in the benchmark (cells: {sorted(entries)})")
    entry = entries[name]
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config_file = REPO / config_entry["file"] if root == HERE else root / "configs" / Path(
        config_entry["file"]).name
    config = load_json(config_file)
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name, entry=entry,
        workload=load_json(root / "workloads" / f"{name}.json"),
        config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_plugin(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the first of ``PLUGIN_ROOTS``
    that has it, loaded once for its file: the harness's own as
    ``benchmark.<folder>.<name>``, another root's under a name made from
    its path."""
    for root in PLUGIN_ROOTS:
        path = (Path(root) / folder / f"{name}.py").resolve()
        if path.exists():
            break
    else:
        raise KeyError(f"no {folder} plug-in {name!r} under {[str(r) for r in PLUGIN_ROOTS]}")
    module = f"{__package__}.{folder}.{name}"
    if path != HERE / folder / f"{name}.py":
        digest = hashlib.blake2b(str(path).encode(), digest_size=6).hexdigest()
        module = f"{__package__}.{folder}._{digest}_{name}"
    if module in sys.modules:
        return sys.modules[module]
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[module]
        raise
    return mod


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    return load_plugin("metrics", name)


def load_arch(kind: str):
    """The image tower's module ``archs/<kind>.py``."""
    return load_plugin("archs", kind)


def load_modality(name: str):
    """The traffic modality's module ``modalities/<name>.py``."""
    return load_plugin("modalities", name)
