"""The port's CLI over several ranks (``torch.distributed``, gloo, CPU
processes under ``python -m torch.distributed.run``) against the port's CLI
on one rank and against ``federated_main.py``.

* Both CLIs run the FairLoRA flags of ``test_torch_port_cli.small_argv``
  with ``--parallel_clients`` (``test-vit`` at 32x32, fp32) on the same
  fixture; the port's ranks hold the JAX trainer's frozen parameters and
  initial trainable state, written to a file and read by each rank.
* 2 users at frac 1.0: ``m = 2`` clients over 2 ranks is ``c = 2, d = 1``,
  one client per rank; the 2-rank run is bit-equal to the 1-rank run (the
  same code on the same data, the states gathered as bytes): every final
  weight and every line of the log but the paths.
* Against the JAX CLI (8-device CPU mesh): acc/AUC to 1e-6, weights to
  1e-5, as the one-rank tests hold them.
* A rank whose state is nudged after the aggregation makes both ranks raise
  at the round's fetch (the round digest).
Every launch has a timeout; each rank runs one thread.  This file is also
the ranks' entry point (run as a script); the other ``test_torch_port_dist_*``
files launch it.
"""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 240
ACC_TOL, WEIGHT_TOL = 1e-6, 1e-5

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# the ranks' entry point: this file run as a script under torchrun
# --------------------------------------------------------------------------- #

def _worker(argv):
    """``argv``: the captured JAX trainer (a pickle) or ``-``, then the CLI's
    argv.  ``FAIRFEDMED_TEST_NUDGE_RANK`` names a rank whose new global
    state is nudged after each aggregation."""
    sys.modules["torch.utils.tensorboard"] = None  # no writer, no TensorFlow import
    from fairfedmed_tpu_torch import federated_main as tfm
    from fairfedmed_tpu_torch.fed import parallel_driver as tdriver
    from fairfedmed_tpu_torch.models import clip_model as tclip
    from fairfedmed_tpu_torch.models import converter as tconv
    from fairfedmed_tpu_torch.models import resnet_clip as tresnet
    from fairfedmed_tpu_torch.train import clip_common as tcc
    from fairfedmed_tpu_torch.train import engine as tengine
    from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp
    from fairfedmed_tpu_torch.train.trainers import promptfl as tpfl

    captured_path, argv = argv[0], argv[1:]
    if captured_path != "-":
        with open(captured_path, "rb") as f:
            captured = pickle.load(f)
        kw = {}
        if "resnet" in captured:
            r = captured["resnet"]
            kw = dict(backbone_type="resnet", rn_cfg=tresnet.ResNetConfig(**r["rn_cfg"]),
                      visual_bn=tconv.params_from_numpy(r["visual_bn"], "cpu"),
                      visual_stats=tconv.params_from_numpy(r["visual_stats"], "cpu"))
        bundle = tcc.CLIPBundle(params=tconv.params_from_numpy(captured["frozen"], "cpu"),
                                clip_cfg=tclip.CLIPConfig(**captured["clip_cfg"]),
                                policy=tcc.policy_from_prec("fp32"), pretrained=False, **kw)
        for module in (tglp, tpfl):
            module.load_clip_bundle = lambda cfg_, prec, device_: bundle

        def build(cfg, dm=None, device=None):
            tr = tengine.build_trainer(cfg, dm, device=device)
            tr.load_state_dict(captured["state"], strict=True)
            return tr

        tfm.build_trainer = build
    nudge = os.environ.get("FAIRFEDMED_TEST_NUDGE_RANK")
    if nudge is not None and int(os.environ["RANK"]) == int(nudge):
        aggregate = tdriver.ParallelRoundRunner._aggregate

        def nudged(self, *args):
            new_global, personal = aggregate(self, *args)
            key = next(iter(new_global))
            return {**new_global, key: new_global[key] + 1e-3}, personal

        tdriver.ParallelRoundRunner._aggregate = nudged
    tfm.main(tfm.build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1:])
    sys.exit(0)

import pytest  # noqa: E402

from tests.fixtures import make_fairfedmed_fixture  # noqa: E402

OPTS = ["INPUT.SIZE", "(32, 32)", "TRAINER.GLP_OT.PREC", "fp32", "USE_CUDA", "False"]


def fairlora_argv(root, out_dir, extra=()):
    """``test_torch_port_cli.small_argv``'s run with ``--parallel_clients``
    (``--opts`` last)."""
    return ["--model", "FedOTPLoRA", "--trainer", "GLP_OT_SVLoRA", "--round", "2",
            "--num_users", "2", "--frac", "1.0", "--OT", "None", "--n_ctx", "4",
            "--num_prompt", "2", "--unfreeze_image_encoder", "True", "--lora_rank", "6",
            "--lora_alpha", "2", "--lora_type", "FairLoRA", "--shared_half_s", "True",
            "--lambda_fairness", "0.5", "--train_batch_size", "4", "--test_batch_size", "4",
            "--stepsize", "200", "--backbone", "test-vit",
            "--dataset-config-file", "configs/datasets/fairfedmed.yaml",
            "--config-file", "configs/trainers/GLP_OT/vit_b16_oph.yaml",
            "--root", str(root), "--output-dir", str(out_dir), "--parallel_clients", *extra,
            *OPTS]


def torchrun(nproc, argv, captured="-", env=(), expect_ok=True):
    """The port's CLI on ``nproc`` gloo ranks (one rank: no group)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(Path(__file__).resolve()), str(captured), *argv]
    full_env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **dict(env))
    full_env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(cmd, cwd=ROOT, env=full_env, capture_output=True, text=True,
                         timeout=RUN_TIMEOUT_S)
    if expect_ok:
        assert out.returncode == 0, out.stderr[-6000:]
    return out


def log_metrics(out_dir):
    """The per-round ``Global test acc`` / ``auc`` of a run's log."""
    log = (Path(out_dir) / "log.txt").read_text()
    return {k: [float(v) for v in re.findall(rf"^Global test {k}: (\S+)$", log, re.M)]
            for k in ("acc", "auc")}


def log_lines(out_dir):
    """The log without the lines that name the output directory or the time
    (``Elapsed``, the ``FAIRFEDMED_TIMING`` lines)."""
    return [line for line in (Path(out_dir) / "log.txt").read_text().splitlines()
            if str(out_dir) not in line and not line.startswith(("Elapsed", "[timing]"))]


def finals(out_dir, n_users):
    out = {}
    for i in range(n_users):
        with np.load(Path(out_dir) / f"global_client{i}_final.npz") as z:
            out[i] = {k: z[k] for k in z.files}
    return out


def assert_weights(got, want, atol):
    for i, w in want.items():
        assert sorted(got[i]) == sorted(w)
        for k, v in w.items():
            if atol == 0:
                assert np.array_equal(got[i][k], v), (i, k)
            else:
                np.testing.assert_allclose(got[i][k], v, atol=atol, rtol=0, err_msg=k)


def run_jax(argv, tmp_path, monkeypatch):
    """The JAX CLI in this process; returns its results and the pickled
    capture of its trainer for the port's ranks."""
    import federated_main as jfm
    from tests.test_torch_port_cli import _capture

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as the ranks
    captured = {}
    jbuild = jfm.build_trainer

    def jax_build(cfg):
        tr = jbuild(cfg)
        captured.update(_capture(tr))
        return tr

    monkeypatch.setattr(jfm, "build_trainer", jax_build)
    saved = sys.stdout
    try:
        res = jfm.main(jfm.build_arg_parser().parse_args(argv))
    finally:
        sys.stdout = saved
    path = tmp_path / "captured.pkl"
    with open(path, "wb") as f:
        pickle.dump(captured, f)
    return res, path


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_dist")
    make_fairfedmed_fixture(str(root), n_sites=3, n_train=8, n_test=6, size=32)
    return root


def check_two_ranks(fixture_root, tmp_path, monkeypatch, n_users, extra, tol):
    """FairLoRA on 1 and 2 ranks and through the JAX CLI; the ranks run
    under ``FAIRFEDMED_TIMING=1``, where rank 0 alone prints the round lines
    and the stamps."""
    extra = ["--num_users", str(n_users), *extra]
    res, captured = run_jax(fairlora_argv(fixture_root, tmp_path / "jax", extra), tmp_path,
                            monkeypatch)
    for name, n in (("one", 1), ("two", 2)):
        out = torchrun(n, fairlora_argv(fixture_root, tmp_path / name, extra), captured,
                       env={"FAIRFEDMED_TIMING": "1"})
        # 2 rounds: one line of each phase per round, one stamp per round
        assert out.stdout.count("[timing] batch assembly:") == 2, out.stdout[-4000:]
        assert out.stderr.count("[timing] round:start epoch=0") == 1, out.stderr[-4000:]
    one, two = (log_metrics(tmp_path / n) for n in ("one", "two"))
    assert len(one["acc"]) == len(one["auc"]) == 2
    if tol == 0:
        assert log_lines(tmp_path / "two") == log_lines(tmp_path / "one")
    for k in ("acc", "auc"):
        np.testing.assert_allclose(two[k], one[k], atol=0 if tol == 0 else ACC_TOL, rtol=0)
        np.testing.assert_allclose(one[k], res[k], atol=ACC_TOL, rtol=0)
    want = finals(tmp_path / "one", n_users)
    assert_weights(finals(tmp_path / "two", n_users), want, tol)
    assert_weights(want, finals(tmp_path / "jax", n_users), WEIGHT_TOL)
    # one line per trained client and round, from rank 0 only
    assert len(re.findall(r"^client \d+: steps", (tmp_path / "two" / "log.txt").read_text(),
                          re.M)) == 2 * n_users


def test_two_ranks_one_client_each_are_bit_equal_to_one_rank(fixture_root, tmp_path,
                                                             monkeypatch):
    check_two_ranks(fixture_root, tmp_path, monkeypatch, 2, [], 0.0)


def test_a_diverged_rank_raises_at_the_round_fetch(fixture_root, tmp_path):
    out = torchrun(2, fairlora_argv(fixture_root, tmp_path / "nudged"),
                   env={"FAIRFEDMED_TEST_NUDGE_RANK": "1"}, expect_ok=False)
    assert out.returncode != 0
    assert "the ranks diverged in round 0" in out.stderr, out.stderr[-4000:]
