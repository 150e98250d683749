"""The port's span recorder (``fairfedmed_tpu_torch/utils/profiling.py``) and
its spans in the client-parallel round driver and the local step.

Unit tests of the recorder, then the port's CLI (``small_argv``: FairLoRA at
``test-vit``, 32x32, fp32, 2 users, 1 client a round, ``--parallel_clients``)
over 2 rounds on ``make_fairfedmed_fixture``'s SLO sites, once with the
recorder on and ``TRAIN.PROFILE_DIR`` set, once with both off:

* the span tree: each span's parent, its interval inside its parent's, its
  round; ``step`` spans as many as the steps the log reports, each with one
  ``step.forward``, ``step.backward`` and ``step.update``;
* one ``fetch`` per resolved round, tagged with that round, run after the
  next round's dispatch;
* self seconds between 0 and the span's seconds;
* with the recorder off nothing is recorded, and the log's metrics and the
  final weights equal the recorded run's bit for bit;
* the ``TRAIN.PROFILE_DIR`` trace holds the ``ffm:`` annotations.

The ``gpu`` test runs a round's dispatch half (a round after the first) on a
card with the recorder on under ``torch.cuda.set_sync_debug_mode("error")``:
no span waits for the device.  This file imports no JAX; on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_spans.py -q -m gpu
"""

import contextlib
import glob
import io
import json
import re
import sys

import numpy as np
import pytest
import torch

from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.utils import profiling
# ``fixtures`` from this folder, which pytest puts first on sys.path: on a
# card the environment may hold another package named ``tests``
from fixtures import make_fairfedmed_fixture, small_argv

torch.set_num_threads(1)

PARENTS = {  # span -> the spans it may sit in (None: the top level)
    "round.batches": {None}, "round.device_put": {None}, "round.train": {None},
    "round.aggregate": {None}, "round.eval_dispatch": {None}, "eval.logits": {None},
    "eval.host_metrics": {None}, "fetch": {None, "eval.logits"},
    "step": {"round.train"}, "step.forward": {"step"}, "step.backward": {"step"},
    "step.update": {"step"}, "cache.decode": {"round.batches", "round.eval_dispatch"},
    "cache.upload": {"round.batches", "round.eval_dispatch"},
}
CLIENT_LINE = re.compile(r"^client \d+: steps (\d+) .*$", re.M)


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


# --------------------------------------------------------------------------- #
# the recorder alone
# --------------------------------------------------------------------------- #

def test_off_records_nothing(recorder):
    with recorder.span("a", round=3, bytes=1) as sp:
        sp.quiet()
    assert recorder.snapshot() == []


def test_nesting_rounds_and_self_seconds(recorder):
    recorder.enable()
    with recorder.span("outer", round=4):
        with recorder.span("inner", bytes=8):
            sum(range(10000))
        with recorder.span("inner"):
            pass
    with recorder.span("alone"):
        pass
    spans = {s.name: s for s in recorder.snapshot()}
    inner = [s for s in recorder.snapshot() if s.name == "inner"]
    outer = spans["outer"]
    assert [s.parent for s in inner] == [outer.id] * 2 and outer.parent is None
    assert [s.round for s in inner] == [4, 4] and spans["alone"].round is None
    assert inner[0].attrs == {"bytes": 8}
    assert outer.self_s == pytest.approx(outer.seconds - sum(s.seconds for s in inner))
    timers = recorder.HostTimers.of(recorder.snapshot())
    assert len(timers.laps["inner"]) == 2 and timers.totals["outer"] == outer.seconds
    assert timers.table().splitlines()[1].split()[:2] == ["alone", "1"]
    assert [s.name for s in recorder.snapshot(rounds=[4])] == ["inner", "inner", "outer"]
    recorder.reset()
    assert recorder.snapshot() == []


def test_recording_restores_the_state(recorder):
    with recorder.recording():
        with recorder.span("a"):
            pass
    with recorder.span("b"):
        pass
    assert [s.name for s in recorder.snapshot()] == ["a"]


@pytest.mark.parametrize("env", [None, "1"])
def test_timing_lines(recorder, monkeypatch, capsys, env):
    monkeypatch.delenv("FAIRFEDMED_TIMING", raising=False)
    if env:
        monkeypatch.setenv("FAIRFEDMED_TIMING", env)
    recorder.read_timing_env()
    try:
        with recorder.span("x", line="phase x", fence=torch.device("cpu")):
            pass
        with recorder.span("y", line="phase y") as sp:
            sp.quiet()
        with recorder.span("z"):
            pass
    finally:
        monkeypatch.delenv("FAIRFEDMED_TIMING", raising=False)
        recorder.read_timing_env()
    out = capsys.readouterr().out
    assert re.findall(r"^\[timing\] (.+): \S+s$", out, re.M) == (["phase x"] if env else [])
    assert recorder.snapshot() == []  # printing records nothing


def test_profiler_trace_holds_the_annotations(recorder, tmp_path):
    recorder.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with recorder.span("outer"):
            with recorder.span("inner"):
                torch.ones(4).add_(1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"ffm:outer", "ffm:inner"} <= set(got)
    o, i = got["ffm:outer"], got["ffm:inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


# --------------------------------------------------------------------------- #
# the CLI's rounds
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_spans")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    # the first import of the scalars' writer draws from numpy's global RNG
    # (TensorFlow's import, where it is installed): import it before the runs
    # that are compared, so that both draw their batches alike
    with contextlib.suppress(ImportError):
        import torch.utils.tensorboard  # noqa: F401
    return root


def run_cli(root, out_dir, record, opts=()):
    """2 parallel rounds through the port's CLI: (stdout, spans, final
    weights)."""
    argv = small_argv(root, out_dir, 2, extra=["--parallel_clients"]) + list(opts)
    profiling.disable()
    profiling.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            (profiling.recording() if record else contextlib.nullcontext()):
        try:
            tfm.main(tfm.build_arg_parser().parse_args(argv), device="cpu")
        finally:
            if sys.stdout is not out:  # the CLI's log tee, over ``out``
                sys.stdout.close()
    spans = profiling.snapshot()
    profiling.reset()
    weights = {}
    for path in sorted(glob.glob(str(out_dir / "global_client*_final.npz"))):
        with np.load(path) as z:
            weights[path.rsplit("/", 1)[1]] = {k: z[k] for k in z.files}
    return out.getvalue(), spans, weights


@pytest.fixture(scope="module")
def recorded(fixture_root, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("on")
    profile_dir = out_dir / "profile"
    run = run_cli(fixture_root, out_dir, True, ["TRAIN.PROFILE_DIR", str(profile_dir)])
    return run + (profile_dir,)


def _round_log(stdout):
    """The log from round 0 on, without the profiler's line and the time."""
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("------------local train"))
    return [ln for ln in lines[start:] if not ln.startswith(("Wrote profiler trace", "Elapsed"))]


def test_span_tree(recorded):
    _, spans, _, _ = recorded
    by_id = {s.id: s for s in spans}
    assert set(s.name for s in spans) == set(PARENTS)
    for s in spans:
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) in PARENTS[s.name], (s, parent)
        if parent is not None:
            assert parent.start <= s.start <= s.end <= parent.end
            assert s.round == parent.round
    for r in (0, 1):
        names = [s.name for s in spans if s.round == r and s.parent is None]
        for phase in ("round.batches", "round.device_put", "round.train", "round.aggregate",
                      "round.eval_dispatch", "eval.logits", "eval.host_metrics", "fetch"):
            assert names.count(phase) == 1, (r, names)
    fill = [s for s in spans if s.name.startswith("cache.")]
    assert {s.name for s in fill if s.round == 0} == {"cache.decode", "cache.upload"}
    assert all(s.attrs["bytes"] > 0 for s in fill if s.name == "cache.upload")


def test_steps_match_the_log(recorded):
    stdout, spans, _, _ = recorded
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == sum(int(n) for n in CLIENT_LINE.findall(stdout)) > 0
    for step in steps:
        kids = [s.name for s in spans if s.parent == step.id]
        assert kids == ["step.forward", "step.backward", "step.update"]


def test_one_fetch_per_round_after_the_next_dispatch(recorded):
    _, spans, _, _ = recorded
    fetches = [s for s in spans if s.name == "fetch"]
    assert [s.round for s in fetches] == [0, 1] and all(s.attrs["bytes"] > 0 for s in fetches)
    batches_1 = next(s for s in spans if s.name == "round.batches" and s.round == 1)
    assert fetches[0].start > batches_1.end  # round 0 resolved after round 1's dispatch


def test_self_seconds_within_the_span(recorded):
    _, spans, _, _ = recorded
    assert all(0 <= s.self_s <= s.seconds for s in spans)


def test_recorder_off_records_nothing_and_changes_nothing(recorded, fixture_root,
                                                          tmp_path_factory):
    out_on, _, weights_on, _ = recorded
    out_off, spans_off, weights_off = run_cli(fixture_root, tmp_path_factory.mktemp("off"),
                                              False)
    assert spans_off == []
    assert _round_log(out_off) == _round_log(out_on)
    assert CLIENT_LINE.findall(out_on) and "Global test acc" in out_on
    assert weights_off.keys() == weights_on.keys() and weights_on
    for name in weights_on:
        for k, v in weights_on[name].items():
            np.testing.assert_array_equal(weights_off[name][k], v, err_msg=f"{name}:{k}")


def test_profile_dir_traces_the_second_round(recorded):
    _, _, _, profile_dir = recorded
    paths = glob.glob(str(profile_dir / "trace_*.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"ffm:step", "ffm:step.backward", "ffm:round.train", "ffm:fetch"} <= names


# --------------------------------------------------------------------------- #
# on a card
# --------------------------------------------------------------------------- #

@pytest.mark.gpu
def test_dispatch_half_with_spans_never_waits_on_card(fixture_root, tmp_path, recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the round's device waits exist only there")
    argv = small_argv(fixture_root, tmp_path, 3, extra=["--parallel_clients"])
    args = tfm.build_arg_parser().parse_args(argv)
    args.idxs_users_train = tfm._int_list(args.idxs_users_train)
    args.idxs_users_test = tfm._int_list(args.idxs_users_test)
    cfg = tfm.setup_cfg(args)
    trainer = tfm.build_trainer(cfg, device=torch.device("cuda"))
    counts = [len(trainer.fed_train_loader_x_dict[i].dataset) for i in range(2)]
    by_attr = [trainer.fed_train_loader_x_dict[i].dataset.count_by_attribute(
        args.attribute_type) for i in range(2)]
    width = max(len(c) for c in by_attr)
    by_attr = [c + [0] * (width - len(c)) for c in by_attr]
    runner = tfm._build_runner(cfg, args, trainer, counts, by_attr)
    users = [0, 1]
    with contextlib.redirect_stdout(io.StringIO()):
        handle = runner.run_round(0, [0], 3, eval_users=users, deferred=True)
        runner.resolve_round(handle)
        runner.parallel_eval(users, 0)
        recorder.enable()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = runner.run_round(1, [0], 3, eval_users=users, deferred=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runner.resolve_round(handle)
        runner.parallel_eval(users, 1)
    spans = recorder.snapshot(rounds=[1])
    assert sum(s.name == "step" for s in spans) == int(handle["n_steps"][0]) > 0
    assert [s.name for s in spans if s.name == "fetch"] == ["fetch"]
