"""The port's CLI against the JAX CLI on the branches beyond FairLoRA:
fedavg, fedprox, PromptFL/FedOTP and CLIP zero-shot.

Both CLIs run on the same fixture (``make_fairfedmed_fixture``: 2 sites of
32x32 SLO fundus, ``test-vit``, fp32, 2 users, frac 0.5 so fedavg and
fedprox train one drawn client per round and PromptFL/FedOTP all clients in
round 0, one in round 1), the port's trainer holding the JAX trainer's
frozen parameters and initial trainable state (``test_torch_port_cli.py``'s
harness).  Cases: fedavg / fedprox / PromptFL with the PromptFL trainer,
FedOTP with the prompt-only GLP_OT (COT, as
``scripts/fedchexmimic/fedotp_fedchexmimic.sh`` runs it) and fedprox with
GLP_OT, 2 rounds each, and CLIP for its one round.  The acc (and AUC where
the branch reports it) trajectories agree to atol 1e-6 and the final
per-client weights to atol 1e-5 (fp32 on both sides, sums in another
order).  The ``Baseline`` trainer builds (its parity with the JAX
trainer: tests/test_torch_port_baseline.py) and raises for an unknown
backbone.
"""

import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_cli import _assert_runs_match, _run_both_clis, small_argv

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_branches")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture
def restore_stdout():
    """Both CLIs replace sys.stdout with their log tee."""
    saved = sys.stdout
    yield
    sys.stdout = saved


CASES = [  # (model, trainer, rounds, extra flags)
    ("fedavg", "PromptFL", 2, []),
    ("fedprox", "PromptFL", 2, ["--mu", "0.5"]),
    ("PromptFL", "PromptFL", 2, []),
    ("FedOTP", "GLP_OT", 2, ["--OT", "COT", "--top_percent", "0.8",
                              "--unfreeze_image_encoder", "False"]),
    ("fedprox", "GLP_OT", 2, ["--mu", "0.5"]),
    ("fedavg", "CLIP", 1, []),
]


@pytest.mark.parametrize("model,trainer,rounds,extra", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_branch_matches_jax_cli(fixture_root, tmp_path, monkeypatch, restore_stdout, model,
                                trainer, rounds, extra):
    def argv_for(name):
        return small_argv(fixture_root, tmp_path / name, rounds,
                          extra=["--model", model, "--trainer", trainer, *extra]) + [
            "TRAINER.PROMPTFL.PREC", "fp32"]

    outs = _run_both_clis(monkeypatch, argv_for)
    with_auc = model in ("PromptFL", "FedOTP")
    ckpts = _assert_runs_match(outs, {n: tmp_path / n for n in ("jax", "port")}, rounds,
                               with_auc=with_auc, n_users=2)
    if trainer == "CLIP":  # evaluation only: nothing trains
        assert ckpts == []
    else:  # fedavg / fedprox draw one client per round; FedOTP trains both in round 0
        assert len(ckpts) == (3 if model in ("PromptFL", "FedOTP") else 2), ckpts
    with np.load(tmp_path / "port" / "global_client0_final.npz") as z:
        n_prompts = 1 if trainer in ("PromptFL", "CLIP") else 2
        assert z["prompt_learner.ctx"].shape[0] == n_prompts


def test_baseline_trainer_raises():
    """The Baseline trainer builds over any data manager (cnn3 when no
    backbone is named) and raises, as the JAX one does, only for a backbone
    it does not know."""
    import types

    from fairfedmed_tpu_torch.config import get_cfg_default
    from fairfedmed_tpu_torch.train.engine import build_trainer
    from fairfedmed_tpu_torch.train.trainers.promptfl import Baseline

    dm = types.SimpleNamespace(fed_train_loader_x_dict={}, fed_test_loader_x_dict={},
                               num_classes=3, lab2cname={0: "a", 1: "b", 2: "c"})
    cfg = get_cfg_default()
    cfg.TRAINER.NAME = "Baseline"
    tr = build_trainer(cfg, dm=dm, device="cpu")
    assert isinstance(tr, Baseline) and tr.trainable["classifier"]["weight"].shape == (3, 256)
    cfg.MODEL.BACKBONE.NAME = "alexnet9000"
    with pytest.raises(KeyError, match="not registered"):
        build_trainer(cfg, dm=dm, device="cpu")
