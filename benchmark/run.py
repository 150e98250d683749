#!/usr/bin/env python3
"""Run one cell of the benchmark of ``fairfedmed_tpu_torch`` on this
machine's CUDA card(s) and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...`` from the repository root).  Earlier
lines on standard error give the card, the set-up's parts, the round count
and, last, every number the correctness check compared beside its limit.
The last line on standard output is the result object: ``correct``,
``attempted`` (rounds in the window), ``failed`` (rounds with a non-finite
loss or metric), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and ``checks``.  The run fails, printing no result, when no
CUDA card is present.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# run as a script, the harness's own folder would shadow modules of the same
# names: import it as the package it is
sys.path[:] = [REPO] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, REPO)]

NAME_CHARS = 160  # a kernel's name in the breakdown is cut to this length


def card_line(torch) -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return (f"card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: "
            f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness, spec
    from benchmark.metrics import _attention

    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on a card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{cell.name} needs {cell.entry['chips']} cards, {torch.cuda.device_count()} "
              "are visible", file=sys.stderr)
        return 2
    # any kernel cache of the run's libraries lives in the checkout, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build", "triton_cache"))
    print(card_line(torch), file=sys.stderr)
    workdir = os.path.join(tempfile.gettempdir(), "fairfedmed_benchmark", cell.name)
    try:
        run = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", workdir, T_START)
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)

    entries = cell.per_layer if a.trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = spec.load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, rows = harness.verdict(run.readings, cell.workload["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.entry["chips"], "memory_peak_bytes": int(run.peak)}
    result = {"correct": bool(correct), "attempted": run.n_rounds, "failed": run.failed,
              "metrics": metrics, "device": device}
    if a.trace:
        att = _attention.counts(run)
        print(f"attention in the traced rounds (informative): calls from shapes fwd "
              f"{att['fwd_calls']} bwd {att['bwd_calls']}; traced kernels matching FWD "
              f"{att['fwd_kernels']} BWD {att['bwd_kernels']}", file=sys.stderr)
        device["busy_s"], device["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in run.trace.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in run.trace.gaps[:10]]}
    result["checks"] = {name: {"value": value if math.isfinite(value) else None, "limit": limit}
                        for name, value, limit in rows if limit is not None}
    for name, value, limit in rows:
        print(f"check {name} {value!r} " + (f"limit {limit!r}" if limit is not None
                                              else "(read, not compared)"), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
