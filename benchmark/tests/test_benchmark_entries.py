"""BENCHMARK.json against the contract and against its files, and the
harness's look-up by name (adding a cell, a configuration or a metric is
adding files and entries)."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import check, harness, inputs, spec

BENCH = spec.load_json(spec.BENCHMARK_JSON)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTHS = re.compile(r"(_dim|_rank|width|hidden|intermediate|latent|state|proj|head|expansion|per_tok)")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        if "/" in word:
            assert word.startswith("benchmark/") and ".." not in word
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_sources():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_configs_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == used
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_per_layer_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one layer, one spelling


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(name):
    cell = spec.load_cell(name)
    assert set(cell.workload["limits"]) == set(check.NUMBERS)
    assert cell.workload["trace_rounds"] >= 1
    assert cell.workload["check_round"] in (1, 2, 3)
    config = next(c for c in BENCH["configs"] if c["name"] == cell.entry["config"])
    assert cell.config["name"] == config["name"] and cell.config["reduced"] == config["reduced"]
    assert (spec.REPO / cell.config["launcher"]).exists()
    arch, modality = spec.load_arch(cell.config["arch"]["kind"]), spec.load_modality(
        cell.traffic["modality"])
    for part in ("image_leaves", "image_macs", "attention", "tokens"):
        assert callable(getattr(arch, part))
    for part in ("make_split", "npz_members", "fed", "images_per_sample", "front_macs", "front"):
        assert callable(getattr(modality, part))
    assert isinstance(modality.TRAINABLE_FRONT, bool)
    assert "assumed" in cell.config and cell.traffic["dataset"] == "FairFedMed"


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(entry):
    mod = spec.load_metric(entry["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (entry["unit"], entry["better"], entry["source"])
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    assert callable(mod.read)


def test_a_new_cell_config_and_metric_are_files(tmp_path, monkeypatch):
    """A throwaway cell, configuration, traffic and metric, added as files and
    entries, load through the harness's look-up without an edit to it."""
    harness_files = {p: p.read_bytes() for p in spec.HERE.rglob("*.py")}
    for sub in ("workloads", "configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    config = json.loads((spec.HERE / "configs" / "clip_vit_b16_fairlora.json").read_text())
    (tmp_path / "configs" / "extra_cfg.json").write_text(json.dumps({**config, "name": "extra_cfg"}))
    (tmp_path / "traffic" / "extra_mix.json").write_text(
        (spec.HERE / "traffic" / "slo_fundus.json").read_text())
    workload = json.loads((spec.HERE / "workloads" / "vit_slo_fairlora.json").read_text())
    (tmp_path / "workloads" / "extra_cell.json").write_text(json.dumps(workload))
    (tmp_path / "metrics" / "extra_metric.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nBETTER = "lower"\nMOVES = "round_s"\n'
        'SOURCE = "device_trace"\n\n\ndef read(run):\n    return 42.0\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "extra_cfg", "source": "x", "file": "benchmark/configs/extra_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra_cell", "config": "extra_cfg", "traffic": "extra_mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "extra_metric", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "round_s",
                               "workloads": ["extra_cell"]})
    cell = spec.load_cell("extra_cell", bench, root=tmp_path)
    assert cell.config["name"] == "extra_cfg"
    assert [m["name"] for m in cell.per_layer][-1] == "extra_metric"
    monkeypatch.setattr(spec, "PLUGIN_ROOTS", [tmp_path, spec.HERE])
    assert spec.load_metric("extra_metric").read(None) == 42.0
    assert "extra_metric" not in [m["name"] for m in spec.load_cell("vit_slo_fairlora", bench).per_layer]
    assert harness_files == {p: p.read_bytes() for p in spec.HERE.rglob("*.py")}


def test_oct_cell_runs_the_oct_launcher():
    """The OCT cell's configuration (the SLO launcher) with its traffic's
    flags parses to what ``scripts/fairfedlora_fairfedmed_oct.sh`` runs,
    flag for flag."""
    from fairfedmed_tpu_torch import federated_main as fm

    cell = spec.load_cell("vit_oct_fairlora")
    argv = harness.build_argv(cell, "/data", "/out", 5)
    want = inputs.launcher_flags(str(spec.REPO / "scripts" / "fairfedlora_fairfedmed_oct.sh"))
    for flag, value in {"--root": "/data", "--output-dir": "/out", "--seed": "5",
                        **cell.config["flags"]}.items():
        want = inputs.set_flag(want, flag, value)
    for flag in ("--config-file", "--dataset-config-file"):
        want[want.index(flag) + 1] = str(spec.REPO / want[want.index(flag) + 1])
    parser = fm.build_arg_parser()
    assert vars(parser.parse_args(argv)) == vars(parser.parse_args(want))
    assert cell.traffic["flags"]["--dim_per_3d_slice"] == str(cell.traffic["dim_per_3d_slice"])
    assert spec.load_modality("oct_bscans").images_per_sample(cell.traffic) == 2


def _loaded_top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
                          "for m in sys.modules}))"], capture_output=True, text=True,
                         cwd=spec.REPO, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_reference_loads_no_program_and_no_jax():
    loaded = _loaded_top_levels("import benchmark.reference.model, benchmark.check, benchmark.inputs")
    assert not loaded & {"jax", "jaxlib", "optax", "flax", "fairfedmed_tpu", "fairfedmed_tpu_torch"}


def test_harness_and_metrics_load_no_jax():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    loaded = _loaded_top_levels(
        "import benchmark.harness, benchmark.spec, benchmark.timeline, benchmark.control\n"
        "import fairfedmed_tpu_torch.federated_main\n"
        + "".join(f"benchmark.spec.load_metric({n!r})\n" for n in names))
    assert "fairfedmed_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "optax", "flax", "fairfedmed_tpu"}
