"""The port's client-parallel rounds against the JAX package's where the
rounds' clients and data vary, through both CLIs as in
``test_torch_port_parallel.py`` (FedOTPLoRA, ``test-vit`` at 32x32, fp32,
2 users, SGD momentum 0.9, the same weights; acc/AUC to atol 1e-6, final
per-client weights to atol 1e-5, the ``client ...`` lines to their
printed digits):

* frac sampling over 3 rounds (rounds 1 and 2 each draw one client);
* ``--idxs_users_train 0`` with ``LOCAL_S``: only client 0 trains, and it
  keeps its local prompt rows and ``lora_S`` (the keep mask);
* an empty client (site 2 has no training data): it trains zero steps and
  enters the aggregation with weight 0 (the host batch path);
* the group-width fallback: no client sees the last race group, so lora_S
  averages by client weights and ``shared_half_s`` is skipped.

And the evaluation gate at 50 or more users (the port's run only): no
round before 140 evaluates, while training runs and stays finite.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from fairfedmed_tpu_torch import federated_main as tfm
from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_parallel import client_lines, parallel_argv, run_and_compare

torch.set_num_threads(1)


@pytest.fixture
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_parallel_sampling")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.mark.parametrize("case,rounds,extra,n_lines", [
    ("frac_3_rounds", 3, [], 4),
    ("idxs_users_train_local_s", 2, ["--idxs_users_train", "0", "--lora_local_s", "True"], 2),
])
def test_parallel_sampling_matches_jax(fixture_root, tmp_path, monkeypatch, restore_stdout, case,
                                       rounds, extra, n_lines):
    lines = run_and_compare(
        monkeypatch, tmp_path,
        lambda name: parallel_argv(fixture_root, tmp_path / name, rounds, extra), rounds,
        with_auc=True)
    assert len(lines) == n_lines, lines
    if case == "idxs_users_train_local_s":
        assert all(line.startswith("client 0:") for line in lines)


def _empty_site2(root):
    base = make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    for attr in ("gender", "race", "ethnicity", "language", "maritalstatus"):
        with open(os.path.join(base, f"meta_site2_{attr}_train.csv"), "w") as f:
            f.write("filename\n")


def _narrow_race(root):
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    for p in glob.glob(str(root / "fairfedmed" / "all" / "*.npz")):
        raw = dict(np.load(p, allow_pickle=True))
        raw["race"] = np.minimum(raw["race"], 1)
        np.savez(p, **raw)


@pytest.mark.parametrize("case,make", [("empty_client", _empty_site2),
                                       ("group_width_fallback", _narrow_race)])
def test_parallel_data_edges_match_jax(tmp_path, monkeypatch, restore_stdout, case, make):
    root = tmp_path / "data"
    make(root)
    lines = run_and_compare(
        monkeypatch, tmp_path,
        lambda name: parallel_argv(root, tmp_path / name, 2, ["--frac", "1.0"]), 2,
        with_auc=True)
    assert len(lines) == 4, lines
    if case == "empty_client":
        assert sum(line.startswith("client 1: steps 0 ") for line in lines) == 2, lines


def test_parallel_eval_gate_at_50_users(tmp_path, restore_stdout):
    root = tmp_path / "data"
    make_fairfedmed_fixture(str(root), n_sites=50, n_train=2, n_test=1, size=32)
    argv = parallel_argv(root, tmp_path / "out", 2, ["--num_users", "50", "--frac", "0.04"])
    saved = sys.stdout
    try:
        out = tfm.main(tfm.build_arg_parser().parse_args(argv), device="cpu")
    finally:
        sys.stdout = saved
    assert out["acc"] == [] and out["auc"] == []  # gated: no evaluation before round 140
    log = (tmp_path / "out" / "log.txt").read_text()
    assert "Evaluate on the client" not in log
    assert len(client_lines(tmp_path / "out")) == 50 + 2  # every client, then int(0.04 * 50)
    for idx in (0, 7, 49):
        with np.load(tmp_path / "out" / f"global_client{idx}_final.npz") as z:
            assert all(np.isfinite(z[k]).all() for k in z.files)
