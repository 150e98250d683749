"""A whole run of the harness on the CPU at a tiny size (no look for a
card), on SLO images and on OCT volumes, first sound, then with the timed
path broken underneath in each way a single-card training cell can break:
``correct`` has to come out false.
(The exchange between cards is a fault only of a cell on several cards;
this benchmark has none.)"""

import time

import pytest
import torch

from benchmark import harness, spec

DATA = spec.HERE / "tests" / "data"
SECONDS = 0.3


def _cell(kind, traffic="slo"):
    name = f"tiny_{kind}_{traffic}"
    bench = {"configs": [{"name": f"tiny_{kind}", "file": f"benchmark/tests/data/configs/tiny_{kind}.json"}],
             "workloads": [{"name": name, "config": f"tiny_{kind}", "traffic": f"tiny_{traffic}",
                            "chips": 1}], "end_to_end": [], "per_layer": []}
    return spec.load_cell(name, bench, root=DATA)


def _run(cell, tmp_path, faults=None):
    run = harness.run_cell(cell, 2 ** 31 + 77, SECONDS, False, "cpu", str(tmp_path / "work"),
                           time.perf_counter(), faults=faults)
    return harness.verdict(run.readings, cell.workload["limits"])[0], run


def _wrap_step(fn):
    def install(runner, live=lambda: True):
        key = (None, None)
        inner = runner._steps[key]
        runner._steps[key] = lambda p, o, b, lr, ctx=None: (
            fn(inner, p, o, b, lr, ctx) if live() else inner(p, o, b, lr, ctx))
    return install


def _unchanged(inner, p, o, b, lr, ctx):
    _, _, metrics = inner(p, o, b, lr, ctx)
    return p, o, metrics


def _half_batch(inner, p, o, b, lr, ctx):
    half = b["label"].shape[0] // 2
    return inner(p, o, {k: v[:half] for k, v in b.items()}, lr, ctx)


def _altered_answer(runner, live=lambda: True):
    inner = runner._infer

    def infer(params, image, attr):
        logits = inner(params, image, attr)
        if not live():
            return logits
        logits = logits.clone()
        logits[0] = logits[0].flip(-1)
        return logits
    runner._infer = infer


def _from_epoch(first, fault):
    """``fault`` live only in the rounds from epoch ``first`` on (as work that
    starts only after warm-up, or state that goes stale, could break)."""
    def install(runner):
        epoch, run_round = [0], runner.run_round

        def round_(e, *args, **kwargs):
            epoch[0] = e
            return run_round(e, *args, **kwargs)

        fault(runner, lambda: epoch[0] >= first)
        runner.run_round = round_
    return install


_unchanged_after_round_0 = _from_epoch(1, _wrap_step(_unchanged))


@pytest.mark.parametrize("kind,traffic", [("vit", "slo"), ("rn", "slo"), ("vit", "oct")],
                         ids=["vit_slo", "rn_slo", "vit_oct"])
def test_sound_run_is_correct(kind, traffic, tmp_path):
    ok, run = _run(_cell(kind, traffic), tmp_path)
    assert ok, run.readings
    assert run.n_rounds >= 1 and run.failed == 0


@pytest.mark.parametrize("traffic", ["slo", "oct"])
@pytest.mark.parametrize("fault,number", [
    (_wrap_step(_unchanged), "change_gap"),
    (_unchanged_after_round_0, "change_gap"),
    (_wrap_step(_half_batch), "grad_gap"),
    (_altered_answer, "eval_gap"),
], ids=["state_unchanged", "state_unchanged_after_round_0", "half_batch", "altered_answer"])
def test_broken_timed_path_is_not_correct(fault, number, traffic, tmp_path):
    cell = _cell("vit", traffic)
    ok, run = _run(cell, tmp_path, faults=fault)
    assert not ok
    assert run.readings[number] > cell.workload["limits"][number]


@pytest.mark.parametrize("fault,number", [
    (_from_epoch(2, _wrap_step(_unchanged)), "late_change_gap"),
    (_from_epoch(2, _altered_answer), "late_eval_gap"),
], ids=["state_unchanged", "altered_answer"])
def test_path_broken_after_the_check_round_is_not_correct(fault, number, tmp_path):
    """A fault that starts in the window, after the check round (epoch 1),
    fails the numbers of the round after the window."""
    cell = _cell("vit", "slo")
    assert cell.workload["check_round"] < 2
    ok, run = _run(cell, tmp_path, faults=fault)
    assert not ok
    assert run.readings[number] > cell.workload["limits"][number]
    assert run.readings[number.replace("late_", "")] <= cell.workload["limits"][
        number.replace("late_", "")]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from benchmark import run
    assert run.main(["--workload", "vit_slo_fairlora", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
