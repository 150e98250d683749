"""The port's standalone training CLI (``python -m
fairfedmed_tpu_torch.tools.train``) against the repository's
``tools/train.py``.

Both run one site from the same weights (the port's trainer built from the
JAX trainer's frozen parameters and initial state, ``test_torch_port_cli.py``'s
harness), fp32, ``test-vit`` at 32x32: PromptFL on the CIFAR-10 fixture
and GLP_OT_SVLoRA (FairLoRA) on the FairFedMed fixture, 2 local epochs.
The JAX CLI's ``clean_cfg`` drops the plain key ``TRAINER.LAMBDA_FAIRNESS``
with the other trainers' nodes, so it cannot build GLP_OT_SVLoRA (held
below); the port's keeps plain keys, and for that trainer the JAX side runs
with the port's ``clean_cfg`` in its place.

* train -> ``save_checkpoint`` -> test: the test results agree to atol
  1e-6 and the checkpoints' weights to atol 1e-5 (fp32 on both sides, sums
  in another order), under the same ``model.pth.tar-1`` and pointer file;
* ``--eval-only --model-dir`` (pointer file, and ``--load-epoch 1``) gives
  the trainer's own test results, on both sides;
* ``--resume`` at the saved epoch trains nothing more and tests the same;
  with ``OPTIM.MAX_EPOCH 3`` both train the third epoch from their own
  checkpoints (weights and optimizer state) and agree again;
* ``--no-train`` does nothing; ``setup_cfg`` gives both CLIs' config nodes
  and one site.
"""

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fairfedmed_tpu_torch.tools import train as ttrain
from fairfedmed_tpu_torch.train import engine as tengine
from fairfedmed_tpu_torch.train.engine import load_checkpoint
from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp
from fairfedmed_tpu_torch.train.trainers import promptfl as tpfl
from tests.fixtures import make_cifar10_fixture, make_fairfedmed_fixture
from tests.test_torch_port_cli import _capture, _port_bundle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_cli():
    spec = importlib.util.spec_from_file_location("standalone_train_jax",
                                                  os.path.join(ROOT, "tools", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtrain = _load_jax_cli()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    cifar = tmp_path_factory.mktemp("sa_cifar")
    make_cifar10_fixture(str(cifar), n_train=40, n_test=20)
    ffm = tmp_path_factory.mktemp("sa_ffm")
    make_fairfedmed_fixture(str(ffm), n_sites=1, n_train=8, n_test=6, size=32)
    return {"PromptFL": cifar, "GLP_OT_SVLoRA": ffm}


@pytest.fixture(autouse=True)
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


def argv(trainer, root, out_dir, *extra, epochs=2):
    common = ["--root", str(root), "--output-dir", str(out_dir), "--seed", "1",
              "--trainer", trainer, "--backbone", "test-vit", *extra]
    if trainer == "PromptFL":
        return common + ["DATASET.NAME", "Cifar10", "INPUT.SIZE", "(32, 32)",
                         "OPTIM.MAX_EPOCH", str(epochs), "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
                         "DATALOADER.TEST.BATCH_SIZE", "10", "TRAINER.PROMPTFL.PREC", "fp32"]
    configs = os.path.join(ROOT, "configs")
    return common + ["--dataset-config-file", os.path.join(configs, "datasets/fairfedmed.yaml"),
                     "--config-file", os.path.join(configs, "trainers/GLP_OT/vit_b16_oph.yaml"),
                     "INPUT.SIZE", "(32, 32)", "OPTIM.MAX_EPOCH", str(epochs),
                     "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "DATALOADER.TEST.BATCH_SIZE", "4",
                     "TRAINER.GLP_OT.PREC", "fp32", "TRAINER.GLP_OT.N_CTX", "4",
                     "TRAINER.GLP_OT_LORA.UNFREEZE_IMAGE_ENCODER", "True",
                     "TRAINER.GLP_OT_LORA.RANK", "4", "TRAINER.GLP_OT_LORA.TYPE", "FairLoRA",
                     "TRAINER.GLP_OT.OT", "'None'", "OPTIM.MOMENTUM", "0.9"]


def run_both(monkeypatch, argv_for):
    """Both CLIs, the port's trainer built from the JAX trainer's numbers."""
    monkeypatch.setattr(jtrain, "clean_cfg", ttrain.clean_cfg)
    captured = {}
    jbuild = jtrain.build_trainer

    def jax_build(cfg):
        tr = jbuild(cfg)
        captured.update(_capture(tr))
        return tr

    def port_build(cfg, dm=None, device=None):
        bundle = _port_bundle(captured)
        for module in (tglp, tpfl):
            monkeypatch.setattr(module, "load_clip_bundle", lambda cfg_, prec, device_: bundle)
        tr = tengine.build_trainer(cfg, dm, device=device)
        tr.load_state_dict(captured["state"], strict=True)
        return tr

    monkeypatch.setattr(jtrain, "build_trainer", jax_build)
    monkeypatch.setattr(ttrain, "build_trainer", port_build)
    outs = {}
    for name, cli, extra in (("jax", jtrain, {}), ("port", ttrain, {"device": "cpu"})):
        saved = sys.stdout
        try:
            outs[name] = cli.main(cli.build_arg_parser().parse_args(argv_for(name)), **extra)
        finally:
            sys.stdout = saved
    return outs


def _jax_ckpt(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_close(got, want):
    """Evaluator results (scalars, arrays, per-group dicts) equal to atol 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close(got[k], want[k])
    elif isinstance(want, (list, tuple)) and any(isinstance(w, (dict, list, tuple, np.ndarray))
                                                 for w in want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   atol=1e-6, rtol=0)


def _assert_tests_match(outs, want=None):
    assert set(outs["port"]) == set(outs["jax"]) == {"test"}
    _assert_close(outs["port"]["test"], outs["jax"]["test"] if want is None else want)
    assert np.isfinite(float(outs["port"]["test"][0]))


@pytest.mark.parametrize("trainer", ["PromptFL", "GLP_OT_SVLoRA"])
def test_train_eval_only_and_resume_match_jax(roots, tmp_path, monkeypatch, trainer):
    root = roots[trainer]
    trained = run_both(monkeypatch, lambda n: argv(trainer, root, tmp_path / "train" / n))
    _assert_tests_match(trained)
    ckpt = {n: tmp_path / "train" / n / "checkpoints" for n in ("jax", "port")}
    for n in ckpt:
        assert (ckpt[n] / "checkpoint").read_text() == "model.pth.tar-1"
    want = _jax_ckpt(ckpt["jax"] / "model.pth.tar-1")
    got = load_checkpoint(str(ckpt["port"] / "model.pth.tar-1"))
    assert got["epoch"] == want["epoch"] == 2
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k], v, atol=1e-5, rtol=0, err_msg=k)
    assert got["optimizer"]["state"]  # the optimizer state rides along

    for extra in ((), ("--load-epoch", "1")):
        evald = run_both(monkeypatch, lambda n, extra=extra: argv(
            trainer, root, tmp_path / "eval" / n, "--eval-only", "--model-dir", str(ckpt[n]),
            *extra))
        _assert_tests_match(evald)
        _assert_tests_match(evald, trained["port"]["test"])

    # --resume at the saved epoch: nothing left to train
    resumed = run_both(monkeypatch, lambda n: argv(trainer, root, tmp_path / "resume" / n,
                                                   "--resume", str(ckpt[n])))
    _assert_tests_match(resumed)
    _assert_tests_match(resumed, trained["port"]["test"])
    log = (tmp_path / "resume" / "port" / "log.txt").read_text()
    assert "Resumed from model.pth.tar-1 (epoch=2)" in log
    # one more epoch from each side's own checkpoint
    more = run_both(monkeypatch, lambda n: argv(trainer, root, tmp_path / "more" / n,
                                                "--resume", str(ckpt[n]), epochs=3))
    _assert_tests_match(more)
    want = _jax_ckpt(tmp_path / "more" / "jax" / "checkpoints" / "model.pth.tar-2")
    got = load_checkpoint(str(tmp_path / "more" / "port" / "checkpoints" / "model.pth.tar-2"))
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k], v, atol=1e-5, rtol=0, err_msg=k)
    before = load_checkpoint(str(ckpt["port"] / "model.pth.tar-1"))["state_dict"]
    assert any(not np.array_equal(got["state_dict"][k], v) for k, v in before.items())


def test_no_train_skips_everything(roots, tmp_path):
    args = ttrain.build_arg_parser().parse_args(argv("PromptFL", roots["PromptFL"], tmp_path,
                                                     "--no-train"))
    assert ttrain.main(args, device="cpu") == {}


@pytest.mark.parametrize("trainer", ["GLP_OT_SVLoRA", "GLP_OT", "PromptFL", "CLIP", "Baseline"])
def test_setup_cfg_matches_jax(trainer, capsys):
    av = ["--trainer", trainer, "DATASET.USERS", "10"]
    jcfg = jtrain.setup_cfg(jtrain.build_arg_parser().parse_args(av))
    tcfg = ttrain.setup_cfg(ttrain.build_arg_parser().parse_args(av))
    nodes = [{k for k, v in c.TRAINER.items() if isinstance(v, dict)} for c in (tcfg, jcfg)]
    assert nodes[0] == nodes[1]
    assert tcfg.DATASET.USERS == jcfg.DATASET.USERS == 1
    assert capsys.readouterr().out.count("overriding DATASET.USERS=10") == 2


def test_load_model_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        ttrain.load_model(object(), str(tmp_path), epoch=3)
    with pytest.raises(FileNotFoundError):
        ttrain.load_model(object(), str(tmp_path))


def test_jax_clean_cfg_drops_the_fairness_key_and_the_port_keeps_it():
    av = ["--trainer", "GLP_OT_SVLoRA"]
    jcfg = jtrain.setup_cfg(jtrain.build_arg_parser().parse_args(av))
    tcfg = ttrain.setup_cfg(ttrain.build_arg_parser().parse_args(av))
    assert "LAMBDA_FAIRNESS" not in jcfg.TRAINER
    assert tcfg.TRAINER.LAMBDA_FAIRNESS == 0.0 and "DIFFERENTIABLE_FEDPROX" in tcfg.TRAINER
    assert {k for k, v in tcfg.TRAINER.items() if isinstance(v, dict)} == \
        {k for k, v in jcfg.TRAINER.items() if isinstance(v, dict)}

