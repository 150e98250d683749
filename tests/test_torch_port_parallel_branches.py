"""The port's client-parallel rounds against the JAX package's on the
other CLI branches, through both CLIs as in ``test_torch_port_parallel.py``
(``test-vit`` at 32x32, fp32, 2 users, 2 rounds, SGD momentum 0.9, the same
weights): fedavg with PromptFL, FedOTP with the prompt-only GLP_OT and COT,
fedprox with PromptFL (the term detached, as the reference has it) and with
GLP_OT (``--differentiable_fedprox``, so the pull toward the round's global
context moves the weights), and FedOTPLinearFT with ``LOCAL_S``.  Rounds of
fedavg and fedprox take every client (frac 1.0): the JAX runner cannot run
a FedProx round on part of the 8-device CPU mesh of these tests.  The
acc/AUC trajectories agree to atol 1e-6, the final per-client weights to
atol 1e-5 and the ``client ...`` lines to their printed digits.
"""

import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_parallel import parallel_argv, run_and_compare

torch.set_num_threads(1)

PROMPTFL_FP32 = ["TRAINER.PROMPTFL.PREC", "fp32"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_parallel_branches")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


@pytest.mark.parametrize("case,extra,opts,with_auc,n_lines", [
    ("fedavg_promptfl", ["--model", "fedavg", "--trainer", "PromptFL", "--frac", "1.0"],
     PROMPTFL_FP32, False, 4),
    ("fedotp_cot", ["--model", "FedOTP", "--trainer", "GLP_OT", "--OT", "COT"], [], True, 3),
    ("fedprox_promptfl", ["--model", "fedprox", "--trainer", "PromptFL", "--frac", "1.0",
                          "--mu", "0.5"], PROMPTFL_FP32, False, 4),
    ("fedprox_glp_ot_differentiable", ["--model", "fedprox", "--trainer", "GLP_OT", "--OT",
                                       "COT", "--frac", "1.0", "--differentiable_fedprox"],
     [], False, 4),
    ("fedotplinearft_local_s", ["--model", "FedOTPLinearFT", "--lora_local_s", "True"], [],
     True, 3),
])
def test_parallel_branch_matches_jax(fixture_root, tmp_path, monkeypatch, restore_stdout, case,
                                     extra, opts, with_auc, n_lines):
    lines = run_and_compare(
        monkeypatch, tmp_path,
        lambda name: parallel_argv(fixture_root, tmp_path / name, 2, extra, opts), 2,
        with_auc=with_auc)
    assert len(lines) == n_lines, lines
    if case.startswith("fedprox"):
        # each round evaluates only its own users, here both
        log = (tmp_path / "port" / "log.txt").read_text()
        assert log.count("Evaluate on the client") == 4
    with np.load(tmp_path / "port" / "global_client0_final.npz") as z:
        assert z["prompt_learner.ctx"].shape[0] == (1 if "promptfl" in case else 2)
