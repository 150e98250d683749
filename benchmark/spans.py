#!/usr/bin/env python3
"""The program's spans (``fairfedmed_tpu_torch/utils/profiling.py``) in a
run of one cell: the readings a benchmark can take from them, the traced
rounds' idle gaps named by what the host was doing, and what the recorder
costs.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> \\
        --recorder on|off|alternate --trace 0|1

runs the cell as ``run.py`` does (``harness.run_cell``), with the recorder
switched on before round 0 (``on``), left off (``off``), or switched on for
every other call of the local step and off for the rest (``alternate``,
:class:`AlternateSteps`).
Standard error gets the recorder's table of the window's rounds (name,
calls, total and self seconds); the last line on standard output is a JSON
object with the run's end-to-end and host-clock readings, ``correct``, and:

* ``spans`` (recorder on): ``step_host_ms`` (``step`` seconds over ``step``
  calls, the window's rounds, in ms), ``step_update_host_ms`` (the same of
  ``step.update``), ``host_wait_s`` (``fetch`` seconds of the window's
  flushed rounds over those rounds), ``cache_fill_s`` (``cache.decode`` +
  ``cache.upload`` seconds in round 0);
* ``trace`` (``--trace 1``): :func:`reduce_program_trace` of the traced
  rounds: ``step_launches`` (host launch events inside ``ffm:step`` ranges
  over their count), its check against the device operations matched to
  launches by correlation id, the attention calls worked out from the
  traced rounds' shapes (``_flops.attention_calls``), and the idle
  gaps labelled ``<harness span>/<innermost program span>``;
* ``alternate``: the host seconds of a local step with the recorder on
  less those of its neighbour with it off, over the window's rounds;
* ``span_cost``: what one span site costs the host with the recorder off
  and on (:func:`span_cost_us`, measured after the run), and times the
  window's spans a round.

The benchmark's own reduction (``timeline.reduce_trace``) is left as it is;
this file reads the same trace beside it, and its gap seconds, busy
seconds and device operations are the same numbers.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time

T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:] = [REPO] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, REPO)]

from benchmark.timeline import DEVICE_CATEGORIES, SPAN_PREFIX, _union  # noqa: E402

PROGRAM_PREFIX = "ffm:"
GAPS = 20  # the longest idle gaps printed
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch", "MemcpyAsync",
                "Memcpy2DAsync", "MemsetAsync", "MemsetD8Async", "MemsetD32Async")


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _outer_first(span):
    return span[0], -span[1]


def _innermost(spans, times) -> list:
    """For each of the ascending ``times`` the name of the innermost of
    ``spans`` (nested (start, end, name), sorted by ``_outer_first``) open
    then, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_program_trace(path: str) -> dict:
    """The trace's program spans against its harness spans, launches and
    device operations (see the module's docstring).  Launches are given to
    the program spans by time, whatever thread made them: autograd's device
    thread launches the backward's kernels inside the main thread's
    ``step.backward``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    bench, program, ops, launches, calls = [], [], [], [], {}
    for e in events:
        cat, name = e.get("cat", ""), e["name"]
        if cat in DEVICE_CATEGORIES:
            ops.append((*_interval(e), name, e.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            bench.append((*_interval(e), name[len(SPAN_PREFIX):]))
        elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            program.append((*_interval(e), name[len(PROGRAM_PREFIX):]))
        elif cat in LAUNCH_CATEGORIES:
            calls[name] = calls.get(name, 0) + 1
            if any(w in name for w in LAUNCH_WORDS):
                launches.append((float(e["ts"]), e.get("args", {}).get("correlation"), name))
    if not bench:
        raise RuntimeError(f"the trace {path} holds no {SPAN_PREFIX}* span")
    bench.sort(key=_outer_first)
    program.sort(key=_outer_first)
    launches.sort()
    lo, hi = bench[0][0], max(s[1] for s in bench)
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _, _ in ops if e > lo and s < hi])
    starts, cursor = [], lo  # each idle gap's start and seconds
    for s, e in busy + [[hi, hi]]:
        if s > cursor:
            starts.append((cursor, (s - cursor) * 1e-6))
        cursor = max(cursor, e)
    times = [t for t, _ in starts]
    gaps, by_label = [], {}
    for outer, inner, (_, seconds) in zip(_innermost(bench, times), _innermost(program, times),
                                          starts):
        label = (outer or "between") + ("" if inner is None else f"/{inner}")
        gaps.append((label, seconds))
        by_label[label] = by_label.get(label, 0.0) + seconds

    launch_times = [t for t, _, _ in launches]
    by_span = {}
    for name in _innermost(program, launch_times):
        by_span[name] = by_span.get(name, 0) + 1
    steps = [(s, e) for s, e, n in program if n == "step"]
    in_steps, correlations = 0, set()
    for s, e in steps:
        i, j = bisect.bisect_left(launch_times, s), bisect.bisect_right(launch_times, e)
        in_steps += j - i
        correlations.update(c for _, c, _ in launches[i:j] if c is not None)
    launched = {c for _, c, _ in launches if c is not None}
    inside = [(n, c) for s, e, n, c in ops if e > lo and s < hi]
    unlaunched = [n for n, c in inside if c not in launched]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "gaps": sorted(gaps, key=lambda g: -g[1]),
            "gap_s_by_label": sorted(by_label.items(), key=lambda kv: -kv[1]),
            "launches_by_span": sorted(by_span.items(), key=lambda kv: -kv[1]),
            "steps": len(steps), "launches_in_steps": in_steps,
            "step_launches": in_steps / len(steps) if steps else None,
            "device_ops_of_step_launches": sum(1 for _, c in inside if c in correlations),
            "device_ops_without_launch_event": len(unlaunched),
            "unlaunched_names": sorted(set(unlaunched))[:10],
            "runtime_calls": sorted(calls.items(), key=lambda kv: -kv[1])[:16]}


def span_readings(spans, window_rounds) -> dict:
    """The readings of the module's docstring from the recorder's spans;
    a reading whose spans were not recorded is None."""
    window = set(window_rounds)

    def seconds(name, rounds):
        picked = [s for s in spans if s.name == name and s.round in rounds]
        return sum(s.seconds for s in picked), picked

    out = {}
    for key, name in (("step_host_ms", "step"), ("step_update_host_ms", "step.update")):
        total, picked = seconds(name, window)
        out[key] = 1e3 * total / len(picked) if picked else None
    total, picked = seconds("fetch", window)
    flushed = {s.round for s in picked}
    out["host_wait_s"] = total / len(flushed) if flushed else None
    fill = [s for s in spans if s.name in ("cache.decode", "cache.upload") and s.round == 0]
    out["cache_fill_s"] = sum(s.seconds for s in fill) if fill else None
    return out


class AlternateSteps:
    """A faults hook of ``harness.run_cell``: the recorder on for every
    other call of the runner's local step and off for the rest (on for the
    even calls of an even round, the odd calls of an odd one), each call's
    host seconds kept as (round, on, seconds).  The calls inside a step
    (``step.forward``, ``step.backward``, ``step.update``) follow the state;
    the ``step`` span around the call takes the previous call's."""

    def __init__(self, recorder):
        self.recorder, self.calls, self.epoch, self.index = recorder, [], None, 0

    def __call__(self, runner):
        key, run_round = (None, None), runner.run_round
        inner = runner._steps[key]

        def round_(epoch, *args, **kwargs):
            self.epoch, self.index = epoch, 0
            return run_round(epoch, *args, **kwargs)

        def step(*args):
            on = (self.index + self.epoch) % 2 == 0
            self.index += 1
            (self.recorder.enable if on else self.recorder.disable)()
            t = time.perf_counter()
            out = inner(*args)
            self.calls.append((self.epoch, on, time.perf_counter() - t))
            return out

        runner.run_round, runner._steps[key] = round_, step

    def paired(self, rounds) -> dict:
        """On against off over neighbouring calls of the same round."""
        rounds, diffs, off = set(rounds), [], []
        for (r0, on0, s0), (r1, on1, s1) in zip(self.calls, self.calls[1:]):
            if r0 == r1 and r0 in rounds and on0 != on1:
                diffs.append((s0 - s1) if on0 else (s1 - s0))
                off.append(s1 if on0 else s0)
        if not diffs:
            return {}
        q = statistics.quantiles(diffs, n=4) if len(diffs) > 1 else [diffs[0]] * 3
        return {"pairs": len(diffs), "step_off_ms": 1e3 * statistics.fmean(off),
                "on_minus_off_ms_mean": 1e3 * statistics.fmean(diffs),
                "on_minus_off_ms_quartiles": [1e3 * v for v in q]}


def span_cost_us(recorder, n: int = 20000) -> dict:
    """Host microseconds a span site costs with the recorder off and on
    (an empty span, over ``n`` calls, less the empty loop)."""
    def loop(body):
        t = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t) / n * 1e6

    def site():
        with recorder.span("cost"):
            pass

    bare = loop(lambda: None)
    off = loop(site) - bare
    recorder.enable()
    try:
        on = loop(site) - bare
    finally:
        recorder.disable()
        recorder.reset()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--recorder", choices=("on", "off", "alternate"), required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness, spec
    from benchmark.metrics import _attention
    from fairfedmed_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("no CUDA device: the spans are read on a card", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build", "triton_cache"))
    traced = {}

    def reduce_trace(path):  # the harness's reduction, and this file's beside it
        traced.update(reduce_program_trace(path))
        return harness_reduce(path)

    harness_reduce, harness.reduce_trace = harness.reduce_trace, reduce_trace
    faults = AlternateSteps(profiling) if a.recorder == "alternate" else None
    if a.recorder != "off":
        profiling.enable()
    workdir = os.path.join(tempfile.gettempdir(), "fairfedmed_spans", cell.name)
    try:
        run = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", workdir, T_START,
                               faults=faults)
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
        harness.reduce_trace = harness_reduce
        profiling.disable()
    spans = profiling.snapshot()

    window = [r["epoch"] for r in run.rounds]
    result = {"workload": cell.name, "seed": a.seed, "recorder": a.recorder,
              "card": torch.cuda.get_device_name(0),
              "correct": harness.verdict(run.readings, cell.workload["limits"])[0],
              "rounds": run.n_rounds}
    for m in cell.end_to_end + [m for m in cell.per_layer
                                if m["source"] == "host_clock" and m["name"] != "round_mfu"]:
        result[m["name"]] = spec.load_metric(m["name"]).read(run)
    cost = span_cost_us(profiling)
    per_round = sum(s.round in set(window) for s in spans) / max(len(window), 1)
    result["span_cost"] = {**cost, "spans_per_round": per_round,
                           "ms_per_round_on": cost["on"] * per_round * 1e-3,
                           "ms_per_round_off": cost["off"] * per_round * 1e-3}
    if a.recorder == "on":
        result["spans"] = span_readings(spans, window)
        for label, rounds in (("round 0", {0}),
                              (f"the window's {len(window)} rounds", set(window))):
            timers = profiling.HostTimers.of([s for s in spans if s.round in rounds])
            print(f"recorder, {label}:\n{timers.table()}", file=sys.stderr)
    if a.recorder == "alternate":
        result["alternate"] = faults.paired(window)
    if a.trace:
        att = _attention.counts(run)
        traced["attention_calls"] = {"fwd": att["fwd_calls"], "bwd": att["bwd_calls"]}
        traced["traced_rounds"] = [r["epoch"] for r in run.traced_rounds]
        traced["gaps"] = traced["gaps"][:GAPS]
        result["trace"] = traced
        result["busy_s_harness"] = run.trace.busy_s
        result["gap_s_harness"] = sum(s for _, s in run.trace.gaps)
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
