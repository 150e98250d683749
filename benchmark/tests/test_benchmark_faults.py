"""A whole run of the harness on the CPU at a tiny size (no look for a
card), first sound, then with the timed path broken underneath in each way
a single-card training cell can break: ``correct`` has to come out false.
(The exchange between cards is a fault only of a cell on several cards;
this benchmark has none.)"""

import time

import pytest
import torch

from benchmark import harness, spec

DATA = spec.HERE / "tests" / "data"
SECONDS = 0.3


def _cell(kind):
    bench = {"configs": [{"name": f"tiny_{kind}", "file": f"benchmark/tests/data/configs/tiny_{kind}.json"}],
             "workloads": [{"name": f"tiny_{kind}_slo", "config": f"tiny_{kind}",
                            "traffic": "tiny_slo", "chips": 1}], "end_to_end": [], "per_layer": []}
    return spec.load_cell(f"tiny_{kind}_slo", bench, root=DATA)


def _run(cell, tmp_path, faults=None):
    run = harness.run_cell(cell, 2 ** 31 + 77, SECONDS, False, "cpu", str(tmp_path / "work"),
                           time.perf_counter(), faults=faults)
    return harness.verdict(run.readings, cell.workload["limits"])[0], run


def _wrap_step(fn):
    def install(runner):
        key = (None, None)
        inner = runner._steps[key]
        runner._steps[key] = lambda p, o, b, lr, ctx=None: fn(inner, p, o, b, lr, ctx)
    return install


def _unchanged(inner, p, o, b, lr, ctx):
    _, _, metrics = inner(p, o, b, lr, ctx)
    return p, o, metrics


def _half_batch(inner, p, o, b, lr, ctx):
    half = b["label"].shape[0] // 2
    return inner(p, o, {k: v[:half] for k, v in b.items()}, lr, ctx)


def _unchanged_after_round_0(runner):
    """The step returns its state unchanged in every round after round 0
    (as work that starts only after a warm-up round could)."""
    key, run_round = (None, None), runner.run_round
    inner = runner._steps[key]

    def step(p, o, b, lr, ctx=None):
        return _unchanged(inner, p, o, b, lr, ctx) if warm[0] else inner(p, o, b, lr, ctx)

    def round_(epoch, *args, **kwargs):
        warm[0] = epoch >= 1
        return run_round(epoch, *args, **kwargs)

    warm = [False]
    runner._steps[key] = step
    runner.run_round = round_


def _altered_answer(runner):
    inner = runner._infer

    def infer(params, image, attr):
        logits = inner(params, image, attr).clone()
        logits[0] = logits[0].flip(-1)
        return logits
    runner._infer = infer


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_sound_run_is_correct(kind, tmp_path):
    ok, run = _run(_cell(kind), tmp_path)
    assert ok, run.readings
    assert run.n_rounds >= 1 and run.failed == 0


@pytest.mark.parametrize("fault,number", [
    (_wrap_step(_unchanged), "change_gap"),
    (_unchanged_after_round_0, "change_gap"),
    (_wrap_step(_half_batch), "grad_gap"),
    (_altered_answer, "eval_gap"),
], ids=["state_unchanged", "state_unchanged_after_round_0", "half_batch", "altered_answer"])
def test_broken_timed_path_is_not_correct(fault, number, tmp_path):
    cell = _cell("vit")
    ok, run = _run(cell, tmp_path, faults=fault)
    assert not ok
    assert run.readings[number] > cell.workload["limits"][number]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from benchmark import run
    assert run.main(["--workload", "vit_slo_fairlora", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
