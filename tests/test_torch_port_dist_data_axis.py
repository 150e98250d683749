"""The port's CLI on 2 gloo ranks where a client's batch splits over the
ranks, and where a ResNet's cannot.

* FairLoRA, 3 users at frac 1.0, ``--lambda_fairness 0.5`` and
  ``--differentiable_fairness``: ``m = 3`` clients over 2 ranks gives ``c =
  1, d = 2``; each rank trains every client on half of each batch, the
  fairness term sums its group counts and confidence sums over the ranks
  before it forms the gap, and the gradients, loss and accuracy are
  averaged over them.  Weights within 1e-5 of one rank and of the JAX CLI
  (whose 8-device CPU mesh splits the batch 4 ways), acc/AUC within 1e-6
  (fp32, sums in another order).
* ``test-rn`` with COT (the RN50 launcher's OT, top 0.8), 3 users at frac
  0.8: BatchNorm keeps ``d = 1``, so round 0 (3 clients) runs on rank 0
  with rank 1 idle and round 1 (2 clients) one client per rank; bit-equal
  to one rank.
"""

import numpy as np

from tests.test_torch_port_dist import (WEIGHT_TOL, check_two_ranks, fairlora_argv,  # noqa: F401
                                        finals, fixture_root, log_lines, log_metrics, torchrun)


def test_a_batch_split_over_two_ranks_matches_one_rank_and_the_jax_cli(fixture_root, tmp_path,
                                                                       monkeypatch):
    check_two_ranks(fixture_root, tmp_path, monkeypatch, 3, ["--differentiable_fairness"],
                    WEIGHT_TOL)


def test_resnet_keeps_its_batch_whole_with_a_rank_idle(fixture_root, tmp_path):
    extra = ["--num_users", "3", "--frac", "0.8", "--backbone", "test-rn", "--OT", "COT",
             "--top_percent", "0.8", "--config-file", "configs/trainers/GLP_OT/rn50_oph.yaml"]
    for name, n in (("one", 1), ("two", 2)):
        torchrun(n, fairlora_argv(fixture_root, tmp_path / name, extra))
    assert log_lines(tmp_path / "two") == log_lines(tmp_path / "one")
    assert len(log_metrics(tmp_path / "two")["auc"]) == 2
    one, two = finals(tmp_path / "one", 3), finals(tmp_path / "two", 3)
    for i in range(3):
        assert any(k.endswith("running_var") for k in two[i])
        for k, v in one[i].items():
            assert np.array_equal(two[i][k], v), (i, k)
