"""The port's CLI against ``federated_main.py`` on the image-folder datasets.

Both CLIs run from the same weights (the port's trainer holds the JAX
trainer's frozen parameters and initial trainable state, as in
``tests/test_torch_port_cli.py``), fp32, ``INPUT.SIZE (32, 32)``, each on its
own copy of the fixture (the split JSON is written into the dataset
directory on first use, so neither run reads the other's):

* the JAX CLI's default run, no flag but ``--root``, ``--output-dir`` and
  ``--round``: FedOTP / GLP_OT / RN50's config (``rn50.yaml``: bicubic
  ``random_resized_crop`` + ``random_flip`` + ``normalize``) on Caltech101,
  COT, 16 context tokens, 2 prompts, 10 users of 2 shots, at ``test-rn`` on
  ``make_imagefolder_fixture`` (20 classes of 10 JPEGs), 2 rounds
  sequential and 1 round with ``--parallel_clients`` (the host transforms
  refuse the device caches, so every round assembles its batches on the
  host);
* ``--model fedavg --trainer PromptFL`` on Office (``make_domain_fixture``
  at its 4 sites and 10 classes, one client per site), ``test-vit``, 2
  rounds.

Acc agrees to atol 1e-6 and the final per-client weights to atol 1e-5: the
port's numpy resizes differ from cv2's by at most 4e-4 of 255 (bicubic, see
``tests/test_torch_port_transforms.py``), which the normalised inputs carry
into the weights (measured, largest difference of a final weight: 3.4e-8 on
Caltech101 sequential, 3.1e-6 with ``--parallel_clients``, 1.7e-7 on
Office).  The parallel run's ``client ...`` lines agree, the loss to one unit
of its 4th printed decimal (it may round the other way).
"""

import re
import shutil
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_domain_fixture, make_imagefolder_fixture
from tests.test_torch_port_cli import _assert_runs_match, _run_both_clis
from tests.test_torch_port_parallel import client_lines

torch.set_num_threads(1)

# a printed loss (4 decimals) may round the other way: the resize difference
# moves a loss by about 1e-6
LOSS_ATOL = 1e-4 + 1e-6
OFFICE_SITES = ("amazon", "caltech", "dslr", "webcam")
OFFICE_CLASSES = ("back_pack", "bike", "calculator", "headphones", "keyboard",
                  "laptop_computer", "monitor", "mouse", "mug", "projector")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_cli_imagefolder")
    make_imagefolder_fixture(str(root), n_classes=20, n_per_class=10, size=24)
    make_domain_fixture(str(root), pkl_subdir="office_caltech_10", sites=OFFICE_SITES,
                        label_names=OFFICE_CLASSES, n_train=20, n_test=10, size=24)
    return root


@pytest.fixture
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


def _parse_client_line(line):
    """(the line without its loss, the loss) of a ``client ...`` line."""
    m = re.fullmatch(r"(client \d+: steps \d+) loss (\S+) (.*)", line)
    return f"{m.group(1)} {m.group(3)}", float(m.group(2))


def _own_roots(data_root, tmp_path):
    """One copy of the fixture per CLI."""
    roots = {}
    for name in ("jax", "port"):
        roots[name] = tmp_path / f"data_{name}"
        shutil.copytree(data_root, roots[name])
    return roots


def _default_argv(root, out_dir, rounds, parallel):
    return ["--root", str(root), "--output-dir", str(out_dir), "--round", str(rounds),
            *(["--parallel_clients"] if parallel else []),
            "--backbone", "test-rn", "INPUT.SIZE", "(32, 32)", "TRAINER.GLP_OT.PREC", "fp32"]


def _office_argv(root, out_dir, rounds):
    return ["--model", "fedavg", "--trainer", "PromptFL", "--num_users", "4",
            "--round", str(rounds), "--n_ctx", "4", "--train_batch_size", "8",
            "--test_batch_size", "8", "--backbone", "test-vit",
            "--config-file", "configs/trainers/PromptFL/vit_b16.yaml",
            "--dataset-config-file", "configs/datasets/office.yaml",
            "--root", str(root), "--output-dir", str(out_dir),
            "INPUT.SIZE", "(32, 32)", "TRAINER.PROMPTFL.PREC", "fp32"]


@pytest.mark.parametrize("case,parallel,rounds", [
    ("caltech_default", False, 2), ("caltech_default", True, 1), ("office_promptfl", False, 2)])
def test_cli_matches_jax_cli_on_imagefolder(data_root, tmp_path, monkeypatch, restore_stdout,
                                            case, parallel, rounds):
    roots = _own_roots(data_root, tmp_path)
    if case == "caltech_default":
        def argv(name):
            return _default_argv(roots[name], tmp_path / name, rounds, parallel)
        n_users = 10
    else:
        def argv(name):
            return _office_argv(roots[name], tmp_path / name, rounds)
        n_users = 4
    outs = _run_both_clis(monkeypatch, argv)
    dirs = {n: tmp_path / n for n in ("jax", "port")}
    _assert_runs_match(outs, dirs, rounds, with_auc=False, n_users=n_users)
    log = (dirs["port"] / "log.txt").read_text()
    assert ("Client-parallel mesh rounds enabled" in log) == parallel
    assert "* accuracy" in log  # the Classification evaluator
    if parallel:
        lines = {n: [_parse_client_line(x) for x in client_lines(d)] for n, d in dirs.items()}
        assert len(lines["port"]) == len(lines["jax"]) == n_users * rounds, lines
        for got, want in zip(lines["port"], lines["jax"]):
            assert got[0] == want[0], (got, want)
            np.testing.assert_allclose(got[1], want[1], atol=LOSS_ATOL, rtol=0)
    if case == "caltech_default":
        # the default run is the JAX CLI's: FedOTP over GLP_OT, RN50's config
        assert "Caltech101" in log and "random_resized_crop" in log
