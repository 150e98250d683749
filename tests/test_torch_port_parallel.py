"""The port's client-parallel rounds (``--parallel_clients``) against the
JAX package's ``ParallelRoundRunner``, through both CLIs.

* Both CLIs run ``--parallel_clients`` on ``make_fairfedmed_fixture``
  (``test-vit`` or ``test-rn`` at 32x32, fp32, 2 users, 2 rounds) from the
  same weights, at SGD momentum 0.9, where every client keeps its own
  optimizer state: FedOTPLoRA with ``shared_half_s`` (frac 0.5, so round 1
  draws its client), ``local``, and FedOTPLoRA at ``test-rn`` (the
  per-client BatchNorm statistics ride the state as ``__bn_stats__``; frac
  1.0, as the JAX runner cannot run a one-client ResNet round on the
  8-device CPU mesh of these tests), and FedOTPLoRA on 3D OCT B-scans (the
  slice projector; the volumes cached as uint8).  The acc/AUC trajectories agree to
  atol 1e-6, the final per-client weights to atol 1e-5 (fp32 on both sides,
  sums in another order), and the ``client ...`` lines to their printed
  digits.
* The port's parallel run equals its sequential run at momentum 0, where
  the sequential loop's shared optimizer state vanishes (as
  ``tests/test_parallel_cli.py`` holds the JAX package): acc/AUC to 1e-6,
  weights to rtol 1e-4 / atol 1e-5.
* ``load_item_u8`` is bit-identical to the JAX package's for SLO and OCT
  members, and None on both sides where a resize is needed.
* What the port does not run on this path says so: round checkpoints
  (``--resume``, ``FAIRFEDMED_ROUND_CKPT``) raise naming the ROADMAP item,
  and ``--trainer CLIP`` falls back to its sequential evaluation with the
  JAX CLI's notice.  ``chip_smoke.py`` reads each launcher's own
  ``--parallel_clients``.
"""

import re
import sys

import numpy as np
import pytest
import torch

from fairfedmed_tpu.data.datasets import fairfedmed as jffm
from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.data.datasets import fairfedmed as tffm
from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_cli import _assert_runs_match, _run_both_clis, small_argv

torch.set_num_threads(1)

ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_parallel")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


def client_lines(out_dir) -> list:
    """The runner's per-client lines of a CLI log."""
    return re.findall(r"^client \d+: steps .*$", (out_dir / "log.txt").read_text(), re.M)


def parallel_argv(root, out_dir, rounds=2, extra=(), opts=()):
    """``small_argv`` with ``--parallel_clients``, momentum 0.9 and ``opts``
    after the fixture's overrides."""
    return small_argv(root, out_dir, rounds, extra=["--parallel_clients", *extra]) + [
        "OPTIM.MOMENTUM", "0.9", *opts]


def run_and_compare(monkeypatch, tmp_path, argv_for, rounds, with_auc, n_users=2):
    outs = _run_both_clis(monkeypatch, argv_for)
    dirs = {n: tmp_path / n for n in ("jax", "port")}
    _assert_runs_match(outs, dirs, rounds, with_auc=with_auc, n_users=n_users)
    lines = {n: client_lines(d) for n, d in dirs.items()}
    assert lines["port"] == lines["jax"] and lines["jax"], lines
    return lines["port"]


@pytest.mark.parametrize("case,extra", [
    ("fedotplora_shared_half_s", []),
    ("local", ["--model", "local", "--frac", "1.0"]),
    ("fedotplora_rn", ["--backbone", "test-rn", "--frac", "1.0"]),
    ("fedotplora_oct", ["--modality_type", "oct_bscans", "--dim_per_3d_slice", "16",
                        "--frac", "1.0"]),
])
def test_parallel_cli_matches_jax(fixture_root, tmp_path, monkeypatch, restore_stdout, case,
                                  extra):
    rounds = 1 if case == "local" else 2
    lines = run_and_compare(monkeypatch, tmp_path,
                            lambda name: parallel_argv(fixture_root, tmp_path / name, rounds,
                                                       extra),
                            rounds, with_auc=case != "local")
    # round 0 trains both clients; frac 0.5 draws one in round 1
    assert len(lines) == {"fedotplora_shared_half_s": 3}.get(case, 2 * rounds), lines
    log = (tmp_path / "port" / "log.txt").read_text()
    assert "Client-parallel mesh rounds enabled" in log
    if case == "fedotplora_oct":
        with np.load(tmp_path / "port" / "global_client0_final.npz") as z:
            assert z["proj_per_3d_slice.weight"].shape == (3, 16, 5, 5)
    if case == "fedotplora_rn":
        with np.load(tmp_path / "port" / "global_client0_final.npz") as z:
            assert any(k.endswith("running_var") for k in z.files)


def _port_run(root, out_dir, parallel):
    argv = small_argv(root, out_dir, 2, extra=["--frac", "1.0"]
                      + (["--parallel_clients"] if parallel else []))
    argv += ["OPTIM.MOMENTUM", "0.0"]
    saved = sys.stdout
    try:
        return tfm.main(tfm.build_arg_parser().parse_args(argv), device="cpu")
    finally:
        sys.stdout = saved


def test_parallel_equals_sequential_at_momentum_0(fixture_root, tmp_path, restore_stdout):
    seq = _port_run(fixture_root, tmp_path / "seq", parallel=False)
    par = _port_run(fixture_root, tmp_path / "par", parallel=True)
    for key in ("acc", "auc"):
        assert len(par[key]) == len(seq[key]) == 2
        np.testing.assert_allclose(par[key], seq[key], atol=1e-6, rtol=0)
    for idx in range(2):
        fname = f"global_client{idx}_final.npz"
        with np.load(tmp_path / "seq" / fname) as s, np.load(tmp_path / "par" / fname) as p:
            assert sorted(s.files) == sorted(p.files)
            for k in s.files:
                np.testing.assert_allclose(p[k], s[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert len(client_lines(tmp_path / "par")) == 4 and not client_lines(tmp_path / "seq")


@pytest.mark.parametrize("modality,res", [("slo_fundus", 32), ("oct_bscans", 32),
                                          ("oct_bscans_3d", 32), ("slo_fundus", 16),
                                          ("oct_bscans", 16)])
def test_load_item_u8_matches_jax(fixture_root, modality, res):
    base = str(fixture_root / "fairfedmed")
    common = (base, 1, "race", ATTRIBUTES, modality, res)
    port, jax_ds = tffm.FairFedMedDataset(*common), jffm.FairFedMedDataset(*common)
    assert len(port) == len(jax_ds) > 0
    for i in range(len(port)):
        got, want = port.load_item_u8(i), jax_ds.load_item_u8(i)
        if res != 32 and modality != "oct_bscans_3d":  # a resize is needed
            assert got is None and want is None
            continue
        assert got[0].dtype == want[0].dtype == np.uint8
        assert got[0].shape == want[0].shape and got[0].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        # the same values as the float decode
        np.testing.assert_array_equal(got[0].astype(np.float32), port.load_item(i)[0])


def test_round_checkpoints_raise_and_clip_falls_back(fixture_root, tmp_path, monkeypatch,
                                                      restore_stdout):
    monkeypatch.setenv("FAIRFEDMED_ROUND_CKPT", str(tmp_path / "ckpt"))
    args = tfm.build_arg_parser().parse_args(parallel_argv(fixture_root, tmp_path / "a", 1))
    with pytest.raises(NotImplementedError, match="ROADMAP M18"):
        tfm.main(args, device="cpu")
    monkeypatch.delenv("FAIRFEDMED_ROUND_CKPT")
    argv = parallel_argv(fixture_root, tmp_path / "clip", 1, ["--trainer", "CLIP"],
                         ["TRAINER.PROMPTFL.PREC", "fp32"])
    out = tfm.main(tfm.build_arg_parser().parse_args(argv), device="cpu")
    sys.stdout = sys.__stdout__
    assert len(out["acc"]) == 1 and np.isfinite(out["acc"]).all()
    log = (tmp_path / "clip" / "log.txt").read_text()
    assert "parallel_clients not supported for this model/trainer; using sequential rounds" in log


def test_chip_smoke_keeps_the_launchers_parallel_switch():
    import glob

    import chip_smoke

    scripts = sorted(glob.glob(str(chip_smoke.REPO) + "/scripts/**/*.sh", recursive=True))
    assert len(scripts) == 8
    for path in scripts:
        seq, par = chip_smoke.script_flags(path), chip_smoke.script_flags(path, parallel=True)
        assert "--parallel_clients" not in seq and par.count("--parallel_clients") == 1, path
        assert [f for f in par if f != "--parallel_clients"] == seq, path
