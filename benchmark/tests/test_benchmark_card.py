"""On the card: the control (the plain reference in float8, one step below
the configuration's bfloat16, put in the program's place) has to come out
not correct at the cell's own size.  Skips without a card."""

import time

import pytest

from benchmark import harness, spec
from benchmark.control import control_readings


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vit_slo_fairlora", "rn50_slo_fairlora", "vit_oct_fairlora"])
def test_control_is_not_correct(name, card, tmp_path):
    cell = spec.load_cell(name)
    run = harness.run_cell(cell, 2 ** 31 + 101, 3.0, False, "cuda", str(tmp_path / "work"),
                           time.perf_counter(), extra=control_readings)
    assert harness.verdict(run.readings, cell.workload["limits"])[0], run.readings
    control = {k.split(".", 1)[1]: v for k, v in run.readings.items() if k.startswith("control.")}
    assert not harness.verdict(control, cell.workload["limits"])[0], control
