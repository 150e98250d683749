"""The port's CLI on 2 gloo ranks on the host assembly path: the JAX CLI's
own default run (FedOTP / GLP_OT / ``rn50.yaml`` on Caltech101, COT, 10
users of 2 shots) at ``test-rn`` with ``--parallel_clients``.

The host transforms (random resized crop, flip) draw from numpy's global
RNG and refuse every device cache, so each rank drains every selected
client's loader in order and keeps its own clients' batches: ``m = 10``
over 2 ranks is ``c = 2, d = 1``, 5 clients per rank.  The run is bit-equal
to one rank (weights and log), which it can only be while the ranks' draws
stay in lockstep with the one-rank runner's.

Beside it, the FairLoRA flags of ``test_torch_port_dist`` on 4 ranks: 2
clients make a ``2 x 2`` grid, 2 data groups of 2 ranks and 2 client
columns, every group made on every rank; within 1e-5 (weights) and 1e-6
(acc/AUC) of one rank.  And the sequential loop raises under 2 ranks,
naming ``--parallel_clients``.
"""

import numpy as np
import pytest

from tests.fixtures import make_imagefolder_fixture
from tests.test_torch_port_dist import (ACC_TOL, WEIGHT_TOL, fairlora_argv, finals,  # noqa: F401
                                        fixture_root, log_lines, log_metrics, torchrun)


@pytest.fixture(scope="module")
def caltech_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("caltech_dist")
    make_imagefolder_fixture(str(root), n_classes=20)
    return root


def test_the_default_run_on_the_host_path_is_bit_equal_over_two_ranks(caltech_root, tmp_path):
    for name, n in (("one", 1), ("two", 2)):
        torchrun(n, ["--root", str(caltech_root), "--output-dir", str(tmp_path / name),
                     "--round", "2", "--backbone", "test-rn", "--parallel_clients",
                     "INPUT.SIZE", "(32, 32)", "TRAINER.GLP_OT.PREC", "fp32", "USE_CUDA", "False"])
    # the first run writes the split file and says so
    assert [x for x in log_lines(tmp_path / "one") if not x.startswith("Saved split")] == \
        log_lines(tmp_path / "two")
    assert len(log_metrics(tmp_path / "two")["acc"]) == 2
    one, two = finals(tmp_path / "one", 10), finals(tmp_path / "two", 10)
    for i in range(10):
        for k, v in one[i].items():
            assert np.array_equal(two[i][k], v), (i, k)


def test_four_ranks_in_a_two_by_two_grid_match_one_rank(fixture_root, tmp_path):
    for name, n in (("one", 1), ("four", 4)):
        torchrun(n, fairlora_argv(fixture_root, tmp_path / name))
    one, four = log_metrics(tmp_path / "one"), log_metrics(tmp_path / "four")
    for k in ("acc", "auc"):
        assert len(four[k]) == 2
        np.testing.assert_allclose(four[k], one[k], atol=ACC_TOL, rtol=0)
    want, got = finals(tmp_path / "one", 2), finals(tmp_path / "four", 2)
    for i, w in want.items():
        for k, v in w.items():
            np.testing.assert_allclose(got[i][k], v, atol=WEIGHT_TOL, rtol=0, err_msg=k)


def test_the_sequential_loop_raises_over_two_ranks(fixture_root, tmp_path):
    argv = [a for a in fairlora_argv(fixture_root, tmp_path / "seq") if a != "--parallel_clients"]
    out = torchrun(2, argv, expect_ok=False)
    assert out.returncode != 0 and "pass --parallel_clients" in out.stderr, out.stderr[-4000:]
