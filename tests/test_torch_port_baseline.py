"""The port's ``Baseline`` trainer (``train/trainers/promptfl.py``) against
the JAX package's, and ``--trainer Baseline`` through both CLIs.

* The trainer: the port's trainer takes the JAX trainer's initial weights
  and BatchNorm statistics (its ``state_dict``, ``stats.`` entries
  included) and both take two steps on the same batches: cnn3 and
  ResNet-18 with the mlp head (``MODEL.HEAD.HIDDEN_LAYERS (128,)``, the
  JAX package's own Baseline configuration, ``tests/test_backbones.py``) on
  CIFAR-10's uint8 NHWC images (moved to NCHW and divided by 255), and
  ResNet-18 on FairFedMed's raw float NCHW images (taken as they are), at
  32x32.  Loss, weights and statistics after each step agree to atol 1e-5
  (ResNet-18: 1e-4, rtol 1e-4, as BatchNorm over the last stage's 4-8
  values per channel amplifies the order of fp32 sums), the accuracy to
  1e-5, and the evaluation logits computed from those weights (raw 0-255
  FairFedMed pixels) to ten times the weights' tolerance.
* The CLI: both CLIs run ``--model fedavg --trainer Baseline`` on the CIFAR
  fixture (2 users, 1 round) from the same weights, cnn3 and ResNet-18 with
  the mlp head; acc agrees to atol 1e-6 and the final per-client weights,
  ``stats.*`` included, to atol 1e-5 (1e-4 for ResNet-18).  With
  ``--parallel_clients`` both print the JAX CLI's notice and run the
  rounds sequentially.
"""

import sys

import jax
import numpy as np
import pytest
import torch

import federated_main as jfm
from fairfedmed_tpu.train import build_trainer as jax_build_trainer
from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.train import engine as tengine
from fairfedmed_tpu_torch.train.trainers.promptfl import Baseline
from tests.fixtures import make_cifar10_fixture, make_fairfedmed_fixture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline_cifar")
    make_cifar10_fixture(str(root), n_train=64, n_test=20)
    return root


@pytest.fixture(scope="module")
def ffm_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline_ffm")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture(autouse=True)
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


def cifar_argv(root, out_dir, backbone, head=True, extra=()):
    argv = ["--model", "fedavg", "--trainer", "Baseline", "--round", "1", "--num_users", "2",
            "--frac", "1.0", "--partition", "homo", "--train_batch_size", "8",
            "--test_batch_size", "10", "--backbone", backbone, "--root", str(root),
            "--output-dir", str(out_dir), "--dataset-config-file", "configs/datasets/cifar10.yaml",
            "--config-file", "configs/trainers/GLP_OT/vit_b16.yaml", *extra,
            "INPUT.SIZE", "(32, 32)"]
    if head:
        argv += ["MODEL.HEAD.NAME", "mlp", "MODEL.HEAD.HIDDEN_LAYERS", "(128,)"]
    return argv


def ffm_argv(root, out_dir, backbone):
    return ["--model", "fedavg", "--trainer", "Baseline", "--round", "1", "--num_users", "2",
            "--frac", "1.0", "--train_batch_size", "4", "--test_batch_size", "4",
            "--backbone", backbone, "--root", str(root), "--output-dir", str(out_dir),
            "--dataset-config-file", "configs/datasets/fairfedmed.yaml",
            "--config-file", "configs/trainers/GLP_OT/vit_b16_oph.yaml", "INPUT.SIZE", "(32, 32)"]


def _cfgs(argv):
    jargs = jfm.build_arg_parser().parse_args(argv)
    targs = tfm.build_arg_parser().parse_args(argv)
    for a in (jargs, targs):
        a.idxs_users_train, a.idxs_users_test = [], []
    return jfm.setup_cfg(jargs), tfm.setup_cfg(targs)


CASES = [("cifar", "cnn3", False, 1e-5), ("cifar", "resnet18", True, 1e-4),
         ("ffm", "resnet18", False, 1e-4)]


@pytest.mark.parametrize("data,backbone,head,tol", CASES,
                         ids=[f"{c[0]}-{c[1]}{'-mlp' if c[2] else ''}" for c in CASES])
def test_baseline_steps_match_jax(cifar_root, ffm_root, tmp_path, data, backbone, head, tol):
    argv = (cifar_argv(cifar_root, tmp_path, backbone, head) if data == "cifar"
            else ffm_argv(ffm_root, tmp_path, backbone))
    jcfg, tcfg = _cfgs(argv)
    np.random.seed(0)
    jtr = jax_build_trainer(jcfg)
    np.random.seed(0)
    ttr = tengine.build_trainer(tcfg, device="cpu")
    assert isinstance(ttr, Baseline)
    want0 = jtr.state_dict()
    assert any(k.startswith("stats.") for k in want0) == (backbone != "cnn3")
    assert sorted(ttr.state_dict()) == sorted(want0)
    assert {k: v.shape for k, v in ttr.state_dict().items()} == \
        {k: v.shape for k, v in want0.items()}
    ttr.load_state_dict(want0, strict=True)
    batches = [b for _, b in zip(range(2), ttr.fed_train_loader_x_dict[0])]
    assert len(batches) == 2
    for i, b in enumerate(batches):
        for tr in (jtr, ttr):
            tr.batch_idx, tr.num_batches = i, 2
        jm, tm = jtr.forward_backward(b), ttr.forward_backward(b)
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=tol, atol=tol)
        assert abs(tm["acc"] - jm["acc"]) <= 1e-5
        want, got = jtr.state_dict(), ttr.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)
    assert ttr._lr_steps == jtr._lr_steps == 1  # stepped on the epoch's last batch
    test_batch = next(iter(ttr.fed_test_loader_x_dict[0]))
    np.testing.assert_allclose(ttr.model_inference(test_batch["img"]).numpy(),
                               np.asarray(jtr.model_inference(test_batch["img"])),
                               rtol=10 * tol, atol=10 * tol)


def test_baseline_state_dict_round_trip(cifar_root, tmp_path):
    _, tcfg = _cfgs(cifar_argv(cifar_root, tmp_path, "resnet18"))
    tr = tengine.build_trainer(tcfg, device="cpu")
    assert "layer4" in tr.trainable["backbone"]["conv"]
    assert len(tr.trainable["backbone"]["conv"]["layer1"]) == 2
    assert tr.trainable["classifier"]["weight"].shape == (10, 128)
    sd = tr.state_dict()
    tr.load_state_dict({k: v + 1.0 for k, v in sd.items()})
    sd2 = tr.state_dict()
    for k in sd:
        np.testing.assert_allclose(sd2[k], sd[k] + 1.0, err_msg=k)
    with pytest.raises(KeyError):
        tr.load_state_dict({"classifier.bias": sd["classifier.bias"]}, strict=True)


def _run_both_baseline(monkeypatch, argv_for):
    """Both CLIs on ``argv_for(name)``, the port's trainer loaded with the
    JAX trainer's initial state (weights and statistics)."""
    captured = {}
    jbuild = jfm.build_trainer

    def jax_build(cfg):
        tr = jbuild(cfg)
        captured["state"] = jax.tree_util.tree_map(np.asarray, tr.state_dict())
        return tr

    def port_build(cfg, dm=None, device=None):
        tr = tengine.build_trainer(cfg, dm, device=device)
        tr.load_state_dict(captured["state"], strict=True)
        return tr

    monkeypatch.setattr(jfm, "build_trainer", jax_build)
    monkeypatch.setattr(tfm, "build_trainer", port_build)
    outs = {}
    for name, cli, extra in (("jax", jfm, {}), ("port", tfm, {"device": "cpu"})):
        saved = sys.stdout
        try:
            outs[name] = cli.main(cli.build_arg_parser().parse_args(argv_for(name)), **extra)
        finally:
            sys.stdout = saved
    return outs


@pytest.mark.parametrize("backbone,head,parallel,tol", [
    ("cnn3", False, False, 1e-5), ("resnet18", True, False, 1e-4), ("cnn3", False, True, 1e-5)])
def test_baseline_cli_matches_jax_cli(cifar_root, tmp_path, monkeypatch, backbone, head,
                                      parallel, tol):
    extra = ["--parallel_clients"] if parallel else []
    outs = _run_both_baseline(monkeypatch, lambda name: cifar_argv(
        cifar_root, tmp_path / name, backbone, head, extra))
    assert len(outs["port"]["acc"]) == len(outs["jax"]["acc"]) == 1
    assert outs["port"]["auc"] == outs["jax"]["auc"] == []
    np.testing.assert_allclose(outs["port"]["acc"], outs["jax"]["acc"], atol=1e-6, rtol=0)
    for idx in range(2):
        fname = f"global_client{idx}_final.npz"
        with np.load(tmp_path / "port" / fname) as got, np.load(tmp_path / "jax" / fname) as want:
            assert sorted(got.files) == sorted(want.files)
            assert any(k.startswith("stats.") for k in want.files) == (backbone != "cnn3")
            for k in want.files:
                np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol, err_msg=k)
    log = (tmp_path / "port" / "log.txt").read_text()
    notice = "parallel_clients not supported for this model/trainer; using sequential rounds"
    assert (notice in log) == parallel == (notice in (tmp_path / "jax" / "log.txt").read_text())
