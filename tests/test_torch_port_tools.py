"""The port's two host tools against ``tools/get_mean_std.py`` (pandas) and
``tools/parse_test_res.py`` on the same log trees, made by the port's CLIs.

* ``get_mean_std``: two seeds of the port's federated CLI (FedOTPLoRA,
  ``test-vit`` at 32x32, 2 users, 2 rounds, plus a third seed of another
  length to give the means more digits) under one folder; both tools write
  byte-equal CSVs for each round, the port's where pandas cannot be
  imported.
* ``parse_test_res``: two seeds of the port's standalone CLI (PromptFL on a
  CIFAR-10 fixture, 1 epoch), whose test lines follow "Finish training";
  both tools print the same summary, plain, ``--ci95`` and ``--multi-exp``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.tools import train as ttrain
from tests.fixtures import make_cifar10_fixture, make_fairfedmed_fixture

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _quiet(fn):
    saved = sys.stdout
    try:
        return fn()
    finally:
        sys.stdout = saved


@pytest.fixture(scope="module")
def fed_logs(tmp_path_factory):
    data = tmp_path_factory.mktemp("tools_ffm")
    make_fairfedmed_fixture(str(data), n_sites=2, n_train=8, n_test=6, size=32)
    exp = tmp_path_factory.mktemp("tools_fed_exp")
    for seed, test_bs in ((1, 4), (2, 4), (3, 3)):
        argv = ["--root", str(data), "--output-dir", str(exp / f"seed{seed}"), "--seed", str(seed),
                "--model", "FedOTPLoRA", "--trainer", "GLP_OT_SVLoRA", "--round", "2",
                "--num_users", "2", "--OT", "None", "--n_ctx", "4", "--lora_rank", "4",
                "--lora_type", "FairLoRA", "--unfreeze_image_encoder", "True",
                "--train_batch_size", "4", "--test_batch_size", str(test_bs),
                "--backbone", "test-vit", "--dataset-config-file",
                str(ROOT / "configs/datasets/fairfedmed.yaml"), "--config-file",
                str(ROOT / "configs/trainers/GLP_OT/vit_b16_oph.yaml"),
                "INPUT.SIZE", "(32, 32)", "TRAINER.GLP_OT.PREC", "fp32", "USE_CUDA", "False"]
        _quiet(lambda: tfm.main(tfm.build_arg_parser().parse_args(argv)))
    return exp


@pytest.fixture(scope="module")
def standalone_logs(tmp_path_factory):
    data = tmp_path_factory.mktemp("tools_cifar")
    make_cifar10_fixture(str(data), n_train=40, n_test=20)
    top = tmp_path_factory.mktemp("tools_sa")
    for exp in ("exp_a", "exp_b"):
        for seed in (1, 2):
            argv = ["--root", str(data), "--output-dir", str(top / exp / f"seed{seed}"),
                    "--seed", str(seed + (exp == "exp_b")), "--trainer", "PromptFL",
                    "--backbone", "test-vit", "DATASET.NAME", "Cifar10", "INPUT.SIZE", "(32, 32)",
                    "OPTIM.MAX_EPOCH", "1", "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
                    "DATALOADER.TEST.BATCH_SIZE", "10", "TRAINER.PROMPTFL.PREC", "fp32",
                    "USE_CUDA", "False"]
            _quiet(lambda: ttrain.main(ttrain.build_arg_parser().parse_args(argv)))
    return top


def _run(cmd, env=None):
    out = subprocess.run([sys.executable, *cmd], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _no_pandas_env(tmp_path):
    """PYTHONPATH with a ``pandas`` that fails to import, ahead of the real one."""
    stub = tmp_path / "no_pandas"
    stub.mkdir(exist_ok=True)
    (stub / "pandas.py").write_text("raise ImportError('pandas is not installed')\n")
    return dict(os.environ, PYTHONPATH=f"{stub}{os.pathsep}{ROOT}")


@pytest.mark.parametrize("epoch", [0, 1])
def test_get_mean_std_writes_the_pandas_tools_csvs(fed_logs, tmp_path, epoch):
    names = [f"epoch{epoch}_client_metrics.csv", f"epoch{epoch}_client_metrics_with_avg.csv"]
    out = {}
    for tool, cmd, env in (
            ("jax", ["tools/get_mean_std.py"], None),
            ("port", ["-m", "fairfedmed_tpu_torch.tools.get_mean_std"], _no_pandas_env(tmp_path))):
        tree = tmp_path / tool
        shutil.copytree(fed_logs, tree)
        _run([*cmd, str(tree), "--epoch", str(epoch)], env)
        out[tool] = [(tree / n).read_bytes() for n in names]
    assert out["port"] == out["jax"]
    rows = out["port"][1].decode().splitlines()
    assert rows[0] == "client,metric,mean,std" and rows[-1].startswith("client_avg,")
    assert any(row.startswith("client1,auc,") for row in rows)


@pytest.mark.parametrize("flags", [[], ["--ci95"], ["--multi-exp"]])
def test_parse_test_res_prints_the_jax_tools_summary(standalone_logs, flags):
    target = standalone_logs if "--multi-exp" in flags else standalone_logs / "exp_a"
    got = _run(["-m", "fairfedmed_tpu_torch.tools.parse_test_res", str(target), *flags])
    want = _run(["tools/parse_test_res.py", str(target), *flags])
    assert got == want
    assert "* accuracy: " in got and "file: " in got


def test_csv_cells_and_client_means_match_pandas_on_awkward_values(tmp_path):
    """Shortest round-trip floats, exponents, and the compensated mean
    pandas' groupby takes where a naive sum would round otherwise."""
    import numpy as np
    import pandas as pd

    from fairfedmed_tpu_torch.tools import get_mean_std as tgms

    values = (("auc", [61.11, 72.2, 0.1]), ("accuracy", [1e-5, 1e16, 33.333]),
              ("dpd", [0.1, 0.2, 0.3]))
    records = [{"client": f"client{i}", "metric": m, "mean": float(np.mean(v)) * (i + 1),
                "std": float(np.std(v)) / (i + 3)} for i in range(7) for m, v in values]
    # a naive sum of these means over the clients gives 0.7999999999999999
    spread = [1e16, 1.0, 1.0, 1.0, -1e16 + 2, 0.3, 0.3]
    records += [{"client": f"client{i}", "metric": "eod", "mean": x, "std": 0.7}
                for i, x in enumerate(spread)]
    df = pd.DataFrame(records)
    avg = df.groupby("metric").agg({"mean": "mean", "std": "mean"}).reset_index()
    avg["client"] = "client_avg"
    pd.concat([df, avg], ignore_index=True).to_csv(tmp_path / "pandas.csv", index=False)
    tgms.write_csv(str(tmp_path / "port.csv"), records + tgms.client_average(records))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    assert "client_avg,eod,0.6571428571428571," in (tmp_path / "port.csv").read_text()
