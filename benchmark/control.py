#!/usr/bin/env python3
"""The readings the limits of correctness are set from, for one cell over
several seeds in one process (the benchmark's own runs do not run this):

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 3

For each seed: a short run of the cell (set-up, round 0, a window of
``--seconds``), then, besides the program's own numbers, the same numbers
read from

* ``control.*``: the control, the plain reference computed in float8 (e4m3,
  one scale per tensor; the step below the configuration's bfloat16) put in
  the program's place: its three steps, its aggregation of the recorded
  round's clients, its evaluation logits from that aggregation;
* ``half.*``: the fault "half of the batch left out, the mean taken over the
  rest" (the step sees the batch's first half only, BatchNorm statistics
  included), planted in the float32 reference put in the program's place;
* ``altered.eval_gap``: the fault "an answer altered where it is produced",
  the two logits of the evaluated row of median margin swapped.

A step that returns its state unchanged reads ``change_gap`` 1 by its
definition and needs no run.  One JSON line per seed on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:] = [REPO] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, REPO)]


def control_readings(cell, fixture, data_root, round0, recorded, device) -> dict:
    import numpy as np
    import torch

    from benchmark import check, harness

    out = {}
    ev = recorded["eval"]
    with harness.no_tf32():
        m32 = harness.reference_model(cell, data_root, device, "fp32")
        m8 = harness.reference_model(cell, data_root, device, "fp8")
        readings = {
            "control": check.step_readings(
                check.reference_as_program(recorded, fixture, m8, cell, device), fixture, m32,
                cell, device),
            "half": check.step_readings(
                check.reference_as_program(recorded, fixture, m32, cell, device,
                                           rows_of=lambda n: slice(0, n // 2)),
                fixture, m32, cell, device)}
        agg32 = check.agg_reference(recorded, fixture, cell)
        agg8 = check.agg_reference(recorded, fixture, cell, "fp8")
        users = next(iter(recorded["personal"].values())).shape[0]
        cap8 = {**recorded, "global": agg8,
                "personal": {k: v[None].expand(users, *v.shape) for k, v in agg8.items()}}
        readings["control"].update(check.agg_readings(cap8, agg32))
        want = check.eval_logits(ev, fixture, m32, cell, device, agg32)
        ev8 = {**ev, "logits": check.eval_logits(ev, fixture, m8, cell, device, agg8)}
        readings["control"].update(check.eval_readings(ev8, want, m32))
        swapped = ev["logits"].copy()
        margin = np.where(check.valid_rows(ev), np.abs(np.diff(swapped, axis=-1))[..., 0], np.nan)
        row = np.unravel_index(np.nanargmin(np.abs(margin - np.nanmedian(margin))), margin.shape)
        swapped[row] = swapped[row][::-1]
        readings["altered"] = check.eval_readings({**ev, "logits": swapped}, want, m32)
    for kind, r in readings.items():
        for name, value in r.items():
            if isinstance(value, (int, float, str, dict)):
                out[f"{kind}.{name}"] = value
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    workdir = os.path.join(tempfile.gettempdir(), "fairfedmed_benchmark", f"{cell.name}_control")
    for seed in a.seeds:
        t = time.perf_counter()
        try:
            run = harness.run_cell(cell, seed, a.seconds, False, "cuda", workdir, t,
                                   extra=control_readings)
        finally:
            import shutil
            shutil.rmtree(workdir, ignore_errors=True)
        correct, _ = harness.verdict(run.readings, cell.workload["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": correct,
                          "setup_s": run.setup_s, "rounds": run.n_rounds,
                          "readings": {k: v for k, v in run.readings.items()
                                       if isinstance(v, (int, float, str, dict))}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
