"""``FAIRFEDMED_TIMING`` and ``FAIRFEDMED_BUILD_STAMPS`` in the port's CLI
against ``federated_main.py``.

Both CLIs run ``test_torch_port_cli.small_argv`` (FairLoRA at ``test-vit``,
32x32, fp32, 2 users) with ``--parallel_clients`` for 1 round and its
evaluation on ``make_fairfedmed_fixture``'s SLO sites, their stdout and
stderr captured:

* with ``FAIRFEDMED_TIMING=1`` the port's ``[timing] <label>: <s>s`` lines
  on stdout (the round's phases, the metrics fetch, the evaluation's) are
  JAX's labels in JAX's order, each time finite and >= 0, and its stamps on
  stderr (the trainer build, the device caches, ``round:start``,
  ``eval:dispatch_start``) equal JAX's with the ``+<s>s`` deltas stripped;
* with ``FAIRFEDMED_BUILD_STAMPS=1`` alone the port prints the same stamps
  (the JAX package prints its stamps under either variable) and no round
  line;
* with neither, no ``[timing]`` line at all.

Over two gloo ranks only rank 0 prints: ``test_torch_port_dist.py``'s
``check_two_ranks`` runs with ``FAIRFEDMED_TIMING=1`` and counts the lines.
"""

import contextlib
import io
import math
import re
import sys

import pytest
import torch

import federated_main as jfm
from fairfedmed_tpu_torch import federated_main as tfm
from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_cli import small_argv

torch.set_num_threads(1)

ROUND_LINE = re.compile(r"^\[timing\] (.+): (\S+)s$", re.M)
STAMP_LINE = re.compile(r"^\[timing\] (.+?)(?: \+\S+s)?$", re.M)
ROUND_LABELS = ["batch assembly", "device_put", "train program", "aggregate+scatter",
                "eval assemble+dispatch", "metrics fetch", "eval logits fetch",
                "eval host metrics"]
ENV = ("FAIRFEDMED_TIMING", "FAIRFEDMED_BUILD_STAMPS")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_timing")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


def run(cli, root, out_dir, env):
    """One parallel round through ``cli`` under ``env``: (stdout, stderr)."""
    argv = small_argv(root, out_dir, 1, extra=["--parallel_clients"])
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for name in ENV:
            mp.delenv(name, raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                cli.main(cli.build_arg_parser().parse_args(argv),
                         **({"device": "cpu"} if cli is tfm else {}))
            finally:
                if sys.stdout is not out:  # the CLI's log tee, over ``out``
                    sys.stdout.close()
    return out.getvalue(), err.getvalue()


def round_lines(stdout):
    return [(label, float(t)) for label, t in ROUND_LINE.findall(stdout)]


def stamps(stderr):
    return STAMP_LINE.findall(stderr)


@pytest.fixture(scope="module")
def jax_timing(fixture_root, tmp_path_factory):
    return run(jfm, fixture_root, tmp_path_factory.mktemp("jax"), {"FAIRFEDMED_TIMING": "1"})


def test_timing_lines_and_stamps_match_jax(fixture_root, tmp_path, jax_timing):
    out, err = run(tfm, fixture_root, tmp_path / "port", {"FAIRFEDMED_TIMING": "1"})
    want = round_lines(jax_timing[0])
    got = round_lines(out)
    assert [label for label, _ in want] == ROUND_LABELS, want
    assert [label for label, _ in got] == ROUND_LABELS, got
    assert all(math.isfinite(t) and t >= 0 for _, t in got), got
    assert stamps(err) == stamps(jax_timing[1]) and "round:start epoch=0" in stamps(err), \
        (stamps(err), stamps(jax_timing[1]))


def test_build_stamps_alone_print_no_round_line(fixture_root, tmp_path, jax_timing):
    out, err = run(tfm, fixture_root, tmp_path / "port", {"FAIRFEDMED_BUILD_STAMPS": "1"})
    assert stamps(err) == stamps(jax_timing[1])
    assert "build:opt_init_done" in stamps(err)
    assert "[timing]" not in out


def test_no_timing_line_without_the_variables(fixture_root, tmp_path):
    out, err = run(tfm, fixture_root, tmp_path / "port", {})
    assert "[timing]" not in out and "[timing]" not in err
    assert "client 0: steps" in out  # the run printed its log
