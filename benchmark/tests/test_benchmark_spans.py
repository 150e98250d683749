"""``benchmark/spans.py``: the program's spans read beside the harness's
trace reduction, on a synthetic chrome trace, on synthetic spans, and in a
tiny run of the harness on the CPU with the recorder on."""

import json
import time

import pytest

from benchmark import harness, spans, spec, timeline
from fairfedmed_tpu_torch.utils import profiling

DATA = spec.HERE / "tests" / "data"


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def trace(tmp_path):
    """A dispatch with one step (the backward's launch on autograd's thread)
    and a launch after it, then a fetch with its copy."""
    events = [
        _x("bench:dispatch", "user_annotation", 0, 1000),
        _x("ffm:step", "user_annotation", 100, 500),
        _x("ffm:step.forward", "user_annotation", 100, 200),
        _x("ffm:step.backward", "user_annotation", 300, 200),
        _x("ffm:step.update", "user_annotation", 500, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 350, 5, tid=2, corr=2),
        _x("cuLaunchKernel", "cuda_driver", 550, 5, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=4),
        _x("cudaStreamSynchronize", "cuda_runtime", 1020, 60, corr=6),
        _x("gemm", "kernel", 200, 50, tid=7, corr=1),
        _x("add", "kernel", 400, 20, tid=7, corr=2),
        _x("sgd", "kernel", 560, 20, tid=7, corr=3),
        _x("copy", "kernel", 800, 100, tid=7, corr=4),
        _x("bench:fetch", "user_annotation", 1000, 200),
        _x("ffm:fetch", "user_annotation", 1005, 190),
        _x("cudaMemcpyAsync", "cuda_runtime", 1010, 5, corr=5),
        _x("Memcpy DtoH", "gpu_memcpy", 1050, 50, tid=7, corr=5),
        _x("attention_fwd", "kernel", 1150, 10, tid=7, corr=99),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_gap_labels_name_the_program_span(trace):
    got = spans.reduce_program_trace(trace)
    want = [("dispatch/step.update", 220), ("dispatch", 200), ("dispatch/step.forward", 150),
            ("dispatch", 150), ("dispatch/step.backward", 140), ("fetch/fetch", 50),
            ("fetch/fetch", 40)]  # longest first
    assert [label for label, _ in got["gaps"]] == [label for label, _ in want]
    assert [s for _, s in got["gaps"]] == pytest.approx([us * 1e-6 for _, us in want])


def test_launches_go_to_spans_by_time_whatever_the_thread(trace):
    got = spans.reduce_program_trace(trace)
    by_span = dict(got["launches_by_span"])
    assert by_span == {"step.forward": 1, "step.backward": 1, "step.update": 1, None: 1,
                       "fetch": 1}
    assert got["steps"] == 1 and got["step_launches"] == 3
    assert got["device_ops_of_step_launches"] == 3  # matched by correlation id
    assert got["device_ops_without_launch_event"] == 1
    assert got["unlaunched_names"] == ["attention_fwd"]


def test_same_busy_gaps_and_operations_as_the_harness(trace):
    mine, theirs = spans.reduce_program_trace(trace), timeline.reduce_trace(trace)
    assert mine["busy_s"] == theirs.busy_s and mine["window_s"] == theirs.window_s
    assert sorted(s for _, s in mine["gaps"]) == sorted(s for _, s in theirs.gaps)
    assert [label.split("/")[0] for label, _ in sorted(mine["gaps"], key=lambda g: -g[1])] \
        == [label for label, _ in theirs.gaps]


def _span(i, name, round, start, end, parent=None):
    return profiling.SpanRecord(i, name, parent, round, start, end, end - start, {})


def test_span_readings():
    recorded = [
        _span(0, "cache.decode", 0, 0.0, 2.0), _span(1, "cache.upload", 0, 2.0, 2.5),
        _span(2, "step", 0, 3.0, 4.0),
        _span(3, "step", 1, 10.0, 10.1), _span(4, "step.update", 1, 10.05, 10.09, 3),
        _span(5, "step", 1, 11.0, 11.3), _span(6, "step.update", 1, 11.1, 11.2, 5),
        _span(7, "fetch", 0, 12.0, 12.5), _span(8, "fetch", 1, 20.0, 20.1),
        _span(9, "step", 2, 30.0, 40.0), _span(10, "cache.decode", 1, 50.0, 60.0),
    ]
    got = spans.span_readings(recorded, window_rounds=[1])
    assert got["step_host_ms"] == pytest.approx(200.0)
    assert got["step_update_host_ms"] == pytest.approx(70.0)
    assert got["host_wait_s"] == pytest.approx(0.1)
    assert got["cache_fill_s"] == pytest.approx(2.5)
    assert spans.span_readings([], [1]) == {"step_host_ms": None, "step_update_host_ms": None,
                                             "host_wait_s": None, "cache_fill_s": None}


def test_tiny_run_with_the_recorder_on_every_other_step(tmp_path):
    bench = {"configs": [{"name": "tiny_vit",
                          "file": "benchmark/tests/data/configs/tiny_vit.json"}],
             "workloads": [{"name": "tiny_vit_slo", "config": "tiny_vit", "traffic": "tiny_slo",
                            "chips": 1}], "end_to_end": [], "per_layer": []}
    cell = spec.load_cell("tiny_vit_slo", bench, root=DATA)
    hook = spans.AlternateSteps(profiling)
    profiling.reset()
    profiling.enable()
    try:
        run = harness.run_cell(cell, 2 ** 31 + 5, 0.3, False, "cpu", str(tmp_path / "work"),
                               time.perf_counter(), faults=hook)
    finally:
        profiling.disable()
    recorded = profiling.snapshot()
    profiling.reset()
    window = [r["epoch"] for r in run.rounds]
    steps = sum(sum(r["n_steps"]) for r in run.rounds)
    assert len([c for c in hook.calls if c[0] in window]) == steps
    assert [on for _, on, _ in hook.calls[:4]] == [True, False, True, False]  # round 0
    forward = [s for s in recorded if s.name == "step.forward"]
    assert len(forward) == sum(on for _, on, _ in hook.calls)  # recorded only when on
    paired = hook.paired(window)
    assert paired["pairs"] >= steps // 2 > 0 and paired["step_off_ms"] > 0
    assert spans.span_readings(recorded, [0])["cache_fill_s"] > 0
