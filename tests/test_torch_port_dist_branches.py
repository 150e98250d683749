"""The port's CLI on 2 gloo ranks: fedprox PromptFL, a round checkpoint
saved over 2 ranks and resumed on 1, and CLIP, which has no client-parallel
rounds.

* ``--model fedprox --trainer PromptFL``, 3 users: ``m = 3`` gives ``c = 1,
  d = 2`` (PromptFL's towers are frozen, so its batch splits); the
  proximal pull toward the round's global prompt on both ranks; weights
  within 1e-5 of one rank, acc within 1e-6.
* FairLoRA, 2 users, ``TRAIN.CHECKPOINT_FREQ 1 --resume DIR``: 2 rounds on
  2 ranks leave ``step_1`` (written by rank 0; its fingerprint leaves out
  the world size), and ``--round 3`` on one rank continues at epoch 2; the
  result is bit-equal to the same save and resume on one rank.
* ``--trainer CLIP`` under 2 ranks raises, naming ``--parallel_clients``.
"""

import numpy as np

from tests.test_torch_port_dist import (ACC_TOL, WEIGHT_TOL, fairlora_argv, finals,  # noqa: F401
                                        fixture_root, log_lines, log_metrics, torchrun)


def promptfl_argv(root, out_dir, extra=()):
    return ["--root", str(root), "--output-dir", str(out_dir), "--model", "fedprox",
            "--mu", "0.5", "--trainer", "PromptFL", "--num_users", "3", "--round", "2",
            "--n_ctx", "4", "--backbone", "test-vit", "--train_batch_size", "4",
            "--test_batch_size", "4", "--dataset-config-file", "configs/datasets/fairfedmed.yaml",
            "--config-file", "configs/trainers/GLP_OT/vit_b16_oph.yaml", *extra,
            "INPUT.SIZE", "(32, 32)", "TRAINER.PROMPTFL.PREC", "fp32", "USE_CUDA", "False"]


def test_fedprox_promptfl_splits_its_batch_over_two_ranks(fixture_root, tmp_path):
    for name, n in (("one", 1), ("two", 2)):
        torchrun(n, promptfl_argv(fixture_root, tmp_path / name, ["--parallel_clients"]))
    one, two = log_metrics(tmp_path / "one"), log_metrics(tmp_path / "two")
    assert len(two["acc"]) == 2
    np.testing.assert_allclose(two["acc"], one["acc"], atol=ACC_TOL, rtol=0)
    want, got = finals(tmp_path / "one", 3), finals(tmp_path / "two", 3)
    for i, w in want.items():
        for k, v in w.items():
            np.testing.assert_allclose(got[i][k], v, atol=WEIGHT_TOL, rtol=0, err_msg=k)


def test_a_checkpoint_saved_on_two_ranks_resumes_on_one(fixture_root, tmp_path):
    def argv(name, rounds, ckpt):
        return fairlora_argv(fixture_root, tmp_path / name,
                             ["--round", str(rounds), "--resume", str(tmp_path / ckpt)]) + [
            "TRAIN.CHECKPOINT_FREQ", "1"]

    torchrun(2, argv("saved_two", 2, "ckpt_two"))
    assert sorted(p.name for p in (tmp_path / "ckpt_two").iterdir()) == ["step_1"]
    torchrun(1, argv("resumed_two", 3, "ckpt_two"))
    torchrun(1, argv("saved_one", 2, "ckpt_one"))
    torchrun(1, argv("resumed_one", 3, "ckpt_one"))
    log = (tmp_path / "resumed_two" / "log.txt").read_text()
    assert "(continuing at epoch 2)" in log
    assert log_lines(tmp_path / "resumed_two") == [
        line.replace("ckpt_one", "ckpt_two") for line in log_lines(tmp_path / "resumed_one")]
    want, got = finals(tmp_path / "resumed_one", 2), finals(tmp_path / "resumed_two", 2)
    for i, w in want.items():
        for k, v in w.items():
            assert np.array_equal(got[i][k], v), (i, k)


def test_clip_raises_over_two_ranks(fixture_root, tmp_path):
    argv = promptfl_argv(fixture_root, tmp_path / "clip", ["--trainer", "CLIP",
                                                           "--parallel_clients"])
    out = torchrun(2, argv, expect_ok=False)
    assert out.returncode != 0 and "--parallel_clients does not take" in out.stderr, \
        out.stderr[-4000:]
