"""The port's CLI against ``federated_main.py`` on FedChexMimic and CIFAR-10.

Both CLIs run 2 rounds (FedOTP 1) from the same weights (the port's trainer holds the
JAX trainer's frozen parameters and initial trainable state, as in
``tests/test_torch_port_cli.py``), at ``test-vit`` with ``INPUT.SIZE (32,
32)`` and fp32:

* ``scripts/fedchexmimic/fairfedlora_fedchexmimic.sh``'s flags (FedOTPLoRA,
  FairLoRA, attributes race / gender / age, frac 0.8 of 2 users) on
  ``make_fedchexmimic_fixture`` (2 sites of 32x32 grayscale JPEGs),
  sequential and with the launcher's own ``--parallel_clients``;
* ``--model fedavg --trainer PromptFL`` on ``make_cifar10_fixture`` split by
  ``noniid-labeldir`` over 2 users, sequential and ``--parallel_clients``
  (the uint8 NHWC images cached on the device as they are, the CIFAR
  preprocessing inside the parallel step), and ``--model FedOTP --trainer
  GLP_OT`` (2 prompts, COT), sequential and with ``--parallel_clients``, 1
  round.

Acc/AUC agree to atol 1e-6, the final per-client weights to atol 1e-5 (fp32
on both sides, sums in another order), the parallel runs' ``client ...``
lines to their printed digits, and the sequential runs' steps report the same
training metrics (on CIFAR no AUC).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.fixtures import make_cifar10_fixture, make_fedchexmimic_fixture
from tests.test_torch_port_cli import _assert_runs_match, _run_both_clis
from tests.test_torch_port_parallel import client_lines

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CHEX_SCRIPT = ROOT / "scripts" / "fedchexmimic" / "fairfedlora_fedchexmimic.sh"


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_cli_datasets")
    make_fedchexmimic_fixture(str(root), n_train=8, n_test=6, size=32)
    make_cifar10_fixture(str(root), n_train=100, n_test=40, seed=2)
    return root


@pytest.fixture
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


def _chex_argv(root, out_dir, parallel, rounds):
    """The launcher's flags (with its --parallel_clients when ``parallel``)
    on the fixture, at the small presets."""
    import chip_smoke

    argv = chip_smoke.script_flags(str(CHEX_SCRIPT), parallel=parallel)
    for flag, value in (("--root", str(root)), ("--output-dir", str(out_dir)),
                        ("--round", str(rounds))):
        argv[argv.index(flag) + 1] = value
    return argv + ["--backbone", "test-vit", "INPUT.SIZE", "(32, 32)",
                   "TRAINER.GLP_OT.PREC", "fp32"]


def _cifar_argv(root, out_dir, parallel, rounds, fedotp=False):
    branch = (["--model", "FedOTP", "--trainer", "GLP_OT", "--num_prompt", "2", "--OT", "COT",
               "--top_percent", "0.8"] if fedotp else ["--model", "fedavg", "--trainer", "PromptFL"])
    return [
        *branch, "--round", str(rounds), "--num_users", "2",
        "--partition", "noniid-labeldir", "--beta", "0.5", "--n_ctx", "4",
        "--train_batch_size", "8", "--test_batch_size", "8", "--backbone", "test-vit",
        "--dataset-config-file", "configs/datasets/cifar10.yaml",
        "--config-file", "configs/trainers/GLP_OT/vit_b16.yaml",
        "--root", str(root), "--output-dir", str(out_dir),
        *(["--parallel_clients"] if parallel else []),
        "INPUT.SIZE", "(32, 32)", "TRAINER.PROMPTFL.PREC", "fp32", "TRAINER.GLP_OT.PREC", "fp32",
    ]


ARGV = {"fedchexmimic_fairlora": _chex_argv, "cifar10_promptfl": _cifar_argv,
        "cifar10_fedotp": lambda *a: _cifar_argv(*a, fedotp=True)}


def _record_step_metrics(monkeypatch):
    """Record the metric names that each CLI's steps hand their meters, by
    package, before the meters drop NaNs."""
    from fairfedmed_tpu.utils import meters as jmeters
    from fairfedmed_tpu_torch.utils import meters as tmeters

    names = {"jax": [], "port": []}
    for key, module in (("jax", jmeters), ("port", tmeters)):
        update = module.MetricMeter.update

        def recording(self, input_dict, _update=update, _out=names[key]):
            _out.append(sorted(input_dict or ()))
            return _update(self, input_dict)

        monkeypatch.setattr(module.MetricMeter, "update", recording)
    return names


@pytest.mark.parametrize("case,parallel,rounds", [
    ("fedchexmimic_fairlora", False, 2), ("fedchexmimic_fairlora", True, 2),
    ("cifar10_promptfl", False, 2), ("cifar10_promptfl", True, 2), ("cifar10_fedotp", False, 1),
    ("cifar10_fedotp", True, 1)])
def test_cli_matches_jax_cli_on_dataset(data_root, tmp_path, monkeypatch, restore_stdout, case,
                                        parallel, rounds):
    argv = ARGV[case]
    names = _record_step_metrics(monkeypatch)
    outs = _run_both_clis(monkeypatch,
                          lambda name: argv(data_root, tmp_path / name, parallel, rounds))
    dirs = {n: tmp_path / n for n in ("jax", "port")}
    # fedavg reports no AUC, nor does FedOTP under the Classification evaluator
    with_auc = case == "fedchexmimic_fairlora"
    _assert_runs_match(outs, dirs, rounds, with_auc=with_auc, n_users=2)
    assert names["port"] == names["jax"] and (names["port"] or parallel), names
    log = (dirs["port"] / "log.txt").read_text()
    assert ("Client-parallel mesh rounds enabled" in log) == parallel
    if parallel:
        lines = {n: client_lines(d) for n, d in dirs.items()}
        assert lines["port"] == lines["jax"] and lines["jax"], lines
    if case == "fedchexmimic_fairlora":
        with np.load(dirs["port"] / "global_client0_final.npz") as z:
            # lora_S per race group (3), FairLoRA on both MLP parts
            key = "image_encoder.transformer.resblocks.0.mlp.c_fc.lora_S.weight"
            assert z[key].shape[0] == 3
    else:
        assert "* accuracy" in log and "result_oph" not in log  # the Classification evaluator
