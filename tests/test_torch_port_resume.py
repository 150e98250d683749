"""Round checkpoints and ``--resume`` on the port's client-parallel rounds
(``fed/parallel_driver.py``), the ports of ``tests/test_parallel_cli.py``'s
round-state tests (``:254-445``) on the port's CLI, and the port's CLI
against the JAX CLI across a resume.

All on ``make_fairfedmed_fixture`` (2 sites of 32x32 SLO fundus,
``test-vit`` or ``test-rn``, fp32, 2 users, SGD momentum 0.9, so every
client's optimizer state is part of what a checkpoint must restore):

* the round trip: ``FAIRFEDMED_ROUND_CKPT`` with ``TRAIN.CHECKPOINT_FREQ 1``
  leaves only ``step_1`` after 2 rounds; it holds epoch 1, the LR step
  counter (2 clients x 2 rounds x 2 steps per local epoch) and, bit for
  bit, the runner's own global, per-client and optimizer state after round
  1; it reloads through a template;
* a relaunch with ``--round 4`` continues at epoch 2, runs 2 rounds and
  leaves only ``step_3``; the same with ``--resume DIR`` alone; a
  checkpoint at or past ``--round`` runs no round;
* the fingerprint: another backbone's or attribute's checkpoint is ignored
  with a message and the run starts at 0; a checkpoint with the legacy
  fingerprint resumes with its note; a checkpoint of this run shape that
  does not match the state raises (no quiet restart from 0);
* deferral: round 0 resolves (and saves) after round 1 has been enqueued,
  and its checkpoint holds round 0's state, not round 1's;
* parity: the JAX CLI and the port's CLI each run 2 rounds with round
  checkpoints, then resume for 2 more, from the same weights
  (``test_torch_port_cli.py``'s harness): acc/AUC agree per round to atol
  1e-6 and the final per-client weights to atol 1e-5 (fp32 on both sides,
  sums in another order).
"""

import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.fed import parallel_driver as tpd
from fairfedmed_tpu_torch.train.checkpoint import latest_step, load_pytree, save_pytree
from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_cli import _assert_runs_match, _run_both_clis, small_argv

torch.set_num_threads(1)

CKPT_ENV = "FAIRFEDMED_ROUND_CKPT"


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_resume")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture(autouse=True)
def restore_stdout(monkeypatch):
    monkeypatch.delenv(CKPT_ENV, raising=False)
    saved = sys.stdout
    yield
    sys.stdout = saved


def _argv(root, out_dir, rounds, extra=(), opts=()):
    return small_argv(root, out_dir, rounds, extra=["--frac", "1.0", "--parallel_clients",
                                                    *extra]) + [
        "OPTIM.MOMENTUM", "0.9", "TRAIN.CHECKPOINT_FREQ", "1", *opts]


class Recorder(tpd.ParallelRoundRunner):
    """The runner with each round's state as ``run_round`` left it, and each
    checkpoint's state and the live state when it was written."""

    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.after_round, self.saves = {}, {}
        Recorder.last = self

    def run_round(self, epoch, *a, **kw):
        out = super().run_round(epoch, *a, **kw)
        self.after_round[epoch] = _clone((self.global_t, self.personal_t, self.stacked_o))
        return out

    def save_round_state(self, directory, epoch, state=None, lr_steps=None):
        self.saves[epoch] = {"state": _clone(state), "lr_steps": lr_steps,
                             "live": _clone((self.global_t, self.personal_t, self.stacked_o))}
        return super().save_round_state(directory, epoch, state=state, lr_steps=lr_steps)


def _clone(state):
    return tuple({k: v.clone() for k, v in d.items()} for d in state)


def _run(argv, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(tfm, "ParallelRoundRunner", Recorder)
    saved = sys.stdout
    try:
        return tfm.main(tfm.build_arg_parser().parse_args(argv), device="cpu")
    finally:
        sys.stdout = saved


def _states_equal(a, b):
    return all(set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
               for x, y in zip(a, b))


def _log(out_dir):
    return (out_dir / "log.txt").read_text()


def test_round_state_checkpoint_roundtrip(fixture_root, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "rounds")
    monkeypatch.setenv(CKPT_ENV, ckpt)
    out = _run(_argv(fixture_root, tmp_path / "run", 2), monkeypatch)
    assert len(out["acc"]) == 2
    runner = Recorder.last
    assert os.listdir(ckpt) == ["step_1"] and latest_step(ckpt) == 1
    assert sorted(runner.saves) == [0, 1]
    tree = load_pytree(f"{ckpt}/step_1")
    assert int(tree["epoch"]) == 1
    assert int(tree["lr_steps"]) == 8 == runner.trainer._lr_steps
    assert int(tree["fingerprint"]) == runner._run_fingerprint()
    state = (tree["global_t"], tree["personal_t"], tree["stacked_o"])
    assert _states_equal(state, (runner.global_t, runner.personal_t, runner.stacked_o))
    assert all(v.shape[0] == 2 for v in tree["personal_t"].values())
    assert "count" in tree["stacked_o"] and any(k.startswith("trace:") for k in tree["stacked_o"])
    template = {"global_t": runner.global_t, "personal_t": runner.personal_t,
                "stacked_o": runner.stacked_o, "lr_steps": 0, "epoch": 0, "fingerprint": 0}
    again = load_pytree(f"{ckpt}/step_1", template=template)
    assert _states_equal((again["global_t"], again["personal_t"], again["stacked_o"]), state)
    assert "round state -> " in _log(tmp_path / "run")


@pytest.mark.parametrize("how", ["env", "resume_flag"])
def test_round_state_resume_continues(fixture_root, tmp_path, monkeypatch, how):
    ckpt = str(tmp_path / "rounds")
    extra = ()
    if how == "env":
        monkeypatch.setenv(CKPT_ENV, ckpt)
    else:
        extra = ("--resume", ckpt)
    _run(_argv(fixture_root, tmp_path / "run1", 2, extra))
    assert os.listdir(ckpt) == ["step_1"]
    out2 = _run(_argv(fixture_root, tmp_path / "run2", 4, extra), monkeypatch)
    assert len(out2["acc"]) == 2 and np.isfinite(out2["acc"]).all()
    assert os.listdir(ckpt) == ["step_3"]
    log = _log(tmp_path / "run2")
    assert f"resumed round state from {ckpt}/step_1 (continuing at epoch 2)" in log
    assert re.findall(r"local train start epoch: (\d+)", log) == ["2", "3"]
    # the resumed state is what round 2 started from: its clients' LR steps
    # continue the counter
    assert Recorder.last.trainer._lr_steps == 16
    # at or past --round: nothing to train, the final weights are re-saved
    out3 = _run(_argv(fixture_root, tmp_path / "run3", 4, extra))
    assert out3["acc"] == [] and "training already complete" in _log(tmp_path / "run3")
    assert os.path.exists(tmp_path / "run3" / "global_client1_final.npz")


@pytest.mark.parametrize("change", [("--backbone", "test-rn"), ("--attribute_type", "gender")])
def test_round_state_fingerprint_guards_resume(fixture_root, tmp_path, monkeypatch, change):
    ckpt = str(tmp_path / "rounds")
    monkeypatch.setenv(CKPT_ENV, ckpt)
    _run(_argv(fixture_root, tmp_path / "run1", 2))
    first = int(load_pytree(f"{ckpt}/step_1")["fingerprint"])
    out2 = _run(_argv(fixture_root, tmp_path / "run2", 2, change))
    assert len(out2["acc"]) == 2  # started fresh, trained every round
    log = _log(tmp_path / "run2")
    assert f"ignoring round checkpoint {ckpt}/step_1: round checkpoint belongs to a " \
           "different run shape" in log
    assert "resumed round state" not in log
    # the new run wrote its own rounds (its step_1 replaced the other's)
    assert sorted(os.listdir(ckpt)) == ["step_1"]
    assert int(load_pytree(f"{ckpt}/step_1")["fingerprint"]) != first


def _bare_runner():
    r = tpd.ParallelRoundRunner.__new__(tpd.ParallelRoundRunner)
    r.num_users = 2
    r.args = types.SimpleNamespace(model="FedOTPLoRA", attribute_type="race")
    r.cfg = types.SimpleNamespace(
        TRAINER=types.SimpleNamespace(NAME="GLP_OT_SVLoRA"),
        MODEL=types.SimpleNamespace(BACKBONE=types.SimpleNamespace(NAME="ViT-B/16")),
        DATASET=types.SimpleNamespace(NAME="FairFedMed", MODALITY_TYPE="slo_fundus"),
        RESUME="")
    r.global_t = {"w": torch.zeros(2)}
    r.personal_t = {"w": torch.zeros(2, 2)}
    r.stacked_o = {"m": torch.zeros(2, 2)}
    r.trainer = types.SimpleNamespace(_lr_steps=0)
    r.device = torch.device("cpu")
    r._saved_steps = set()
    return r


def test_fingerprints_equal_the_jax_runners():
    from fairfedmed_tpu.fed.parallel_driver import ParallelRoundRunner as JaxRunner

    r = _bare_runner()
    j = JaxRunner.__new__(JaxRunner)
    j.num_users, j.args, j.cfg = r.num_users, r.args, r.cfg
    assert r._run_fingerprint() == j._run_fingerprint()
    assert r._run_fingerprint_legacy() == j._run_fingerprint_legacy()
    assert r._run_fingerprint() != r._run_fingerprint_legacy()


def test_legacy_and_foreign_fingerprints(tmp_path, capsys, monkeypatch):
    r = _bare_runner()
    tree = {"global_t": {"w": torch.ones(2)}, "personal_t": {"w": torch.ones(2, 2)},
            "stacked_o": {"m": torch.ones(2, 2)}, "lr_steps": 7, "epoch": 3,
            "fingerprint": r._run_fingerprint_legacy()}
    path = save_pytree(str(tmp_path / "ck"), tree, step=3)
    assert r.load_round_state(path) == 3
    assert r.trainer._lr_steps == 7 and torch.equal(r.global_t["w"], torch.ones(2))
    assert "pre-dataset-identity" in capsys.readouterr().out

    tree["fingerprint"] = r._run_fingerprint_legacy() ^ 1
    path2 = save_pytree(str(tmp_path / "ck2"), tree, step=3)
    with pytest.raises(tpd.ForeignCheckpoint, match="different run shape"):
        r.load_round_state(path2)
    monkeypatch.setenv(CKPT_ENV, str(tmp_path / "ck2"))
    assert r.maybe_resume() == 0
    assert "ignoring round checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("bad", ["shape", "missing"])
def test_own_checkpoint_that_does_not_load_raises(tmp_path, monkeypatch, bad):
    r = _bare_runner()
    tree = {"global_t": {"w": torch.ones(2)}, "personal_t": {"w": torch.ones(2, 2)},
            "stacked_o": {"m": torch.ones(2, 2)}, "lr_steps": 7, "epoch": 3,
            "fingerprint": r._run_fingerprint()}
    if bad == "shape":
        tree["personal_t"] = {"w": torch.ones(3, 2)}
    else:
        del tree["stacked_o"]["m"]
    save_pytree(str(tmp_path / "ck"), tree, step=3)
    monkeypatch.setenv(CKPT_ENV, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="checkpoint"):
        r.maybe_resume()
    assert torch.equal(r.global_t["w"], torch.zeros(2))  # nothing adopted


def test_deferred_round_saves_its_own_state(fixture_root, tmp_path, monkeypatch):
    """FedOTPLoRA rounds are deferred: round 0 resolves, and writes its
    checkpoint, after round 1 has been enqueued; the checkpoint holds round
    0's state although the runner's tensors already hold round 1's."""
    monkeypatch.setenv(CKPT_ENV, str(tmp_path / "rounds"))
    _run(_argv(fixture_root, tmp_path / "run", 2), monkeypatch)
    r = Recorder.last
    save0 = r.saves[0]
    assert _states_equal(save0["state"], r.after_round[0])
    assert not _states_equal(save0["state"], r.after_round[1])
    assert _states_equal(save0["live"], r.after_round[1])  # deferred: round 1 was enqueued
    assert save0["lr_steps"] == 4  # round 0's counter: 2 clients x 2 steps
    assert _states_equal(r.saves[1]["state"], r.after_round[1]) and r.saves[1]["lr_steps"] == 8


def test_resume_matches_jax_cli(fixture_root, tmp_path, monkeypatch):
    """2 rounds with checkpoints, then 2 more after a resume, through both
    CLIs from the same weights; frac 0.5, so each later round draws its
    client."""
    outs = {}
    for phase, rounds in (("first", 2), ("resumed", 4)):
        def argv_for(name, rounds=rounds, phase=phase):
            return small_argv(fixture_root, tmp_path / phase / name, rounds,
                              extra=["--parallel_clients", "--resume",
                                     str(tmp_path / f"ckpt_{name}")]) + [
                "OPTIM.MOMENTUM", "0.9", "TRAIN.CHECKPOINT_FREQ", "1"]

        outs[phase] = _run_both_clis(monkeypatch, argv_for)
        dirs = {n: tmp_path / phase / n for n in ("jax", "port")}
        _assert_runs_match(outs[phase], dirs, 2, with_auc=True, n_users=2)
        for name in ("jax", "port"):
            assert os.listdir(tmp_path / f"ckpt_{name}") == [f"step_{rounds - 1}"]
        if phase == "resumed":
            for name in ("jax", "port"):
                assert "(continuing at epoch 2)" in _log(dirs[name])
            lines = {n: re.findall(r"^client \d+: steps .*$", _log(d), re.M)
                     for n, d in dirs.items()}
            assert lines["port"] == lines["jax"] and len(lines["jax"]) == 2
    # round 0 trains both clients, rounds 1-3 one each, 2 LR steps per client
    port = load_pytree(str(tmp_path / "ckpt_port" / "step_3"))
    assert int(port["lr_steps"]) == 2 * 2 + 3 * 2
