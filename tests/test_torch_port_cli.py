"""The port's CLI (``fairfedmed_tpu_torch.federated_main``) against the
JAX package's (``federated_main.py``), with the port's YAML reader and ViT
checkpoint converter.

* both parsers have the same flags and defaults;
* ``setup_cfg`` gives equal configs for the flags of
  ``scripts/fairfedlora_fairfedmed.sh`` and for every YAML under ``configs/``;
  the port's YAML reader gives ``yaml.safe_load``'s values;
* in a process where yaml, cv2, pandas, jax and tensorboard cannot be
  imported, the port's CLI runs a FedOTPLoRA round on the CPU;
* the whole slice: both CLIs run 2 FedOTPLoRA rounds on the same fixture
  (``test-vit`` at 32x32, fp32, 2 users, frac 0.5 so round 1 draws its
  client), the port's trainer holding the JAX trainer's frozen parameters
  and initial trainable state.  The acc/AUC trajectories agree to atol 1e-6
  and the final per-client weights to atol 1e-5 (fp32 on both sides, sums
  in another order).  The FedOTPLinearFT (2 rounds) and local (1 round)
  branches are held the same way, and so are 2 rounds with the flags of
  ``scripts/fairfedlora_fairfedmed_oct.sh`` (``test-vit`` on 3D OCT B-scans)
  and ``scripts/fairfedlora_fairfedmed_rn50.sh`` (``test-rn``), 3 users;
* the ViT converter on a small torch-keyed state dict: equal to the JAX
  package's, and the same after a file round trip.
"""

import argparse
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import federated_main as jfm
from fairfedmed_tpu import config as jconfig
from fairfedmed_tpu.models import converter as jconv
from fairfedmed_tpu_torch import config as tconfig
from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.models import clip_model as tclip
from fairfedmed_tpu_torch.models import converter as tconv
from fairfedmed_tpu_torch.models import resnet_clip as tresnet
from fairfedmed_tpu_torch.train import clip_common as tcc
from fairfedmed_tpu_torch.train import engine as tengine
from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp
from fairfedmed_tpu_torch.train.trainers import promptfl as tpfl
from fairfedmed_tpu_torch.utils import yaml_lite
from tests.fixtures import make_fairfedmed_fixture, small_argv

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/**/*.yaml"))
# scripts/fairfedlora_fairfedmed.sh with its defaults (attribute language,
# seed 1), sequential rounds
SCRIPT_FLAGS = [
    "--root", "DATA/", "--model", "FedOTPLoRA", "--seed", "1", "--num_users", "3",
    "--frac", "0.8", "--lr", "0.001", "--OT", "None", "--top_percent", "0.8", "--eps", "0.1",
    "--thresh", "0.001", "--max_iter", "100", "--gamma", "0.1", "--trainer", "GLP_OT_SVLoRA",
    "--round", "50", "--stepsize", "200", "--attribute_type", "language",
    "--partition", "noniid-labeldir100", "--beta", "0.3", "--n_ctx", "4", "--num_prompt", "2",
    "--unfreeze_image_encoder", "True", "--lora_rank", "12", "--lora_alpha", "2",
    "--lora_type", "FairLoRA", "--modality_type", "slo_fundus",
    "--dataset-config-file", "configs/datasets/fairfedmed.yaml",
    "--config-file", "configs/trainers/GLP_OT/vit_b16_oph.yaml",
    "--output-dir", "output/FairLoRA_vit_b16_oph_ema/fairfedmed_language_rank12_alpha2/seed1",
    "--shared_half_s", "True", "--lambda_fairness", "0.0",
]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_cli")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture
def restore_stdout():
    """Both CLIs replace sys.stdout with their log tee."""
    saved = sys.stdout
    yield
    sys.stdout = saved


# --------------------------------------------------------------------------- #
# arguments and configs
# --------------------------------------------------------------------------- #

def test_parsers_have_the_same_flags_and_defaults():
    assert vars(tfm.build_arg_parser().parse_args([])) == \
        vars(jfm.build_arg_parser().parse_args([]))
    argv = SCRIPT_FLAGS + ["--idxs_users_train", "0,2", "OPTIM.LR", "0.01"]
    assert vars(tfm.build_arg_parser().parse_args(argv)) == \
        vars(jfm.build_arg_parser().parse_args(argv))
    with pytest.raises(argparse.ArgumentTypeError):
        tfm._str2bool("maybe")


def test_chip_smoke_reads_the_launcher_flags():
    """chip_smoke.py's cli_path takes its flags from the launcher script."""
    import chip_smoke

    assert chip_smoke.script_flags() == SCRIPT_FLAGS


def _setup_both(argv):
    return (tconfig._to_plain(tfm.setup_cfg(tfm.build_arg_parser().parse_args(argv))),
            jconfig._to_plain(jfm.setup_cfg(jfm.build_arg_parser().parse_args(argv))))


@pytest.mark.parametrize("which", ["script"] + CONFIGS)
def test_setup_cfg_matches(which):
    if which == "script":
        argv = SCRIPT_FLAGS + ["DATASET.NAME", "FairFedMed", "TEST.EVALUATOR",
                               "Classification_oph", "TRAINER.GLP_OT.PREC", "fp32"]
    else:  # each YAML merged alone
        argv = ["--config-file", which, "--dataset-config-file", ""]
    got, want = _setup_both(argv)
    assert got == want


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_safe_load(path):
    text = (ROOT / path).read_text()
    assert yaml_lite.loads(text, path) == yaml.safe_load(text)


def test_yaml_reader_scalars_and_refusals():
    for text in ("1e-5", "1.0e-5", "-.5", "017", "0x1F", "0b11", "1_000", "yes", "Off", "~",
                 "null", "", "True", "ViT-B/16", "(224, 224)", "'it''s'", '"a\\tb"',
                 "[1, 'a', b, [2.5, null]]", "[]", ".inf", "x  # comment"):
        assert yaml_lite.parse_value(text) == yaml.safe_load(text), text
    nested = "A:\n  B:\n    - 1\n    - x\n  C: [a, b]  # c\n\n# d\nD: 'q'\n"
    assert yaml_lite.loads(nested) == yaml.safe_load(nested)
    for bad, line in (("A: &x 1\n", 1), ("A:\n  B: *x\n", 2), ("A: !!str 1\n", 1),
                      ("A: |\n  t\n", 1), ("A: {b: 1}\n", 1), ("A: 1\n---\nB: 2\n", 2),
                      ("A: 1\nA: 2\n", 2), ("A: 1:30\n", 1), ("A:\n  - b: 1\n", 2)):
        with pytest.raises(yaml_lite.YamlError, match=f"cfg.yaml:{line}:"):
            yaml_lite.loads(bad, "cfg.yaml")
    cfg = tconfig.get_cfg_default()
    cfg.merge_from_list(["DATASET.NAME", "FairFedMed", "OPTIM.WARMUP_CONS_LR", "1e-5",
                         "INPUT.SIZE", "(32, 32)", "DATASET.ATTRIBUTES", "[race, gender]"])
    assert (cfg.DATASET.NAME, cfg.OPTIM.WARMUP_CONS_LR, cfg.INPUT.SIZE,
            cfg.DATASET.ATTRIBUTES) == ("FairFedMed", 1e-5, (32, 32), ["race", "gender"])
    dumped = cfg.dump()  # tuples come back as lists
    as_lists = yaml.safe_load(yaml.safe_dump(tconfig._to_plain(cfg)))
    assert yaml_lite.loads(dumped) == yaml.safe_load(dumped) == as_lists


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #

def test_cli_runs_without_yaml_cv2_pandas_jax_tensorboard(fixture_root, tmp_path):
    out_dir = tmp_path / "out"
    argv = small_argv(fixture_root, out_dir, rounds=1)
    code = textwrap.dedent(f"""
        import sys
        for name in ("yaml", "cv2", "pandas", "jax", "tensorboard"):
            sys.modules[name] = None  # importing any of them now fails
        from fairfedmed_tpu_torch import federated_main as fm
        out = fm.main(fm.build_arg_parser().parse_args({argv!r}), device="cpu")
        sys.stdout = sys.__stdout__
        assert len(out["acc"]) == len(out["auc"]) == 1, out
        print("ROUND", out["acc"][0], out["auc"][0])
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ROUND" in res.stdout
    assert "TensorBoard unavailable" in res.stdout
    for idx in (0, 1):
        with np.load(out_dir / f"global_client{idx}_final.npz") as z:
            assert all(np.isfinite(z[k]).all() for k in z.files)


def _capture(jtr):
    """What the port's trainer needs of a built JAX trainer: its frozen
    parameters (and a ResNet's BatchNorm trees and shapes) as numpy, its
    trainable state, and its parameter names and shapes."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = {"frozen": {k: v for k, v in to_np(jtr.frozen).items() if k != "visual_bn"},
           "state": jtr.state_dict(), "clip_cfg": dataclasses.asdict(jtr.bundle.clip_cfg),
           "named": {k: tuple(np.shape(v)) for k, v in jtr.named_parameters().items()}}
    if jtr.bundle.backbone_type == "resnet":
        out["resnet"] = dict(rn_cfg=dataclasses.asdict(jtr.bundle.rn_cfg),
                             visual_bn=to_np(jtr.bundle.visual_bn), visual_stats=to_np(jtr.stats))
    return out


def _port_bundle(captured):
    kw = {}
    if "resnet" in captured:
        r = captured["resnet"]
        kw = dict(backbone_type="resnet", rn_cfg=tresnet.ResNetConfig(**r["rn_cfg"]),
                  visual_bn=tconv.params_from_numpy(r["visual_bn"], "cpu"),
                  visual_stats=tconv.params_from_numpy(r["visual_stats"], "cpu"))
    return tcc.CLIPBundle(params=tconv.params_from_numpy(captured["frozen"], "cpu"),
                          clip_cfg=tclip.CLIPConfig(**captured["clip_cfg"]),
                          policy=tcc.policy_from_prec("fp32"), pretrained=False, **kw)


def _run_both_clis(monkeypatch, argv_for):
    """Both CLIs on ``argv_for(name)``, the port's trainer built from the JAX
    trainer's numbers.  Returns each CLI's per-round results."""
    captured = {}
    jbuild = jfm.build_trainer

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
        # the CLI's count_parameters tables read the same names and shapes
        assert {k: tuple(v.shape) for k, v in tr.named_parameters().items()} == captured["named"]
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


def _assert_runs_match(outs, out_dirs, rounds, with_auc, n_users):
    assert len(outs["port"]["acc"]) == len(outs["jax"]["acc"]) == rounds
    assert len(outs["port"]["auc"]) == len(outs["jax"]["auc"]) == (rounds if with_auc else 0)
    for key in ("acc", "auc"):
        np.testing.assert_allclose(outs["port"][key], outs["jax"][key], atol=1e-6, rtol=0)
    # the same clients trained in each round (an evaluation-only run writes
    # no checkpoint)
    ckpts = {name: sorted(os.listdir(d / "checkpoints")) if (d / "checkpoints").exists() else []
             for name, d in out_dirs.items()}
    assert ckpts["port"] == ckpts["jax"]
    for idx in range(n_users):
        fname = f"global_client{idx}_final.npz"
        with np.load(out_dirs["port"] / fname) as got, np.load(out_dirs["jax"] / fname) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    return ckpts["port"]


@pytest.mark.parametrize("model,rounds", [("FedOTPLoRA", 2), ("FedOTPLinearFT", 2),
                                          ("local", 1)])
def test_cli_matches_jax_cli(fixture_root, tmp_path, monkeypatch, restore_stdout, model, rounds):
    """The sequential branches through both CLIs from the same weights."""
    outs = _run_both_clis(monkeypatch, lambda name: small_argv(
        fixture_root, tmp_path / name, rounds, extra=["--model", model]))
    ckpts = _assert_runs_match(outs, {n: tmp_path / n for n in ("jax", "port")}, rounds,
                               with_auc=model != "local", n_users=2)
    assert len(ckpts) == {"local": 1}.get(model, 3), ckpts  # round 1 draws one of the two


@pytest.fixture(scope="module")
def launcher_root(tmp_path_factory):
    """Three sites, as the launchers' --num_users 3 reads."""
    root = tmp_path_factory.mktemp("ffm_launcher")
    make_fairfedmed_fixture(str(root), n_sites=3, n_train=6, n_test=4, size=32)
    return root


@pytest.mark.parametrize("script,backbone", [("fairfedlora_fairfedmed_oct.sh", "test-vit"),
                                             ("fairfedlora_fairfedmed_rn50.sh", "test-rn")])
def test_cli_matches_jax_cli_on_launcher_flags(launcher_root, tmp_path, monkeypatch,
                                               restore_stdout, script, backbone):
    """The OCT (ViT, 3D B-scans) and RN50 launchers' flags, read from the
    scripts, through both CLIs for 2 rounds on the small presets."""
    import chip_smoke

    flags = chip_smoke.script_flags(str(ROOT / "scripts" / script))

    def argv_for(name):
        argv = list(flags)
        for flag, value in (("--root", str(launcher_root)), ("--output-dir", str(tmp_path / name)),
                            ("--round", "2")):
            argv[argv.index(flag) + 1] = value
        return argv + ["--backbone", backbone, "INPUT.SIZE", "(32, 32)",
                       "TRAINER.GLP_OT.PREC", "fp32"]

    outs = _run_both_clis(monkeypatch, argv_for)
    ckpts = _assert_runs_match(outs, {n: tmp_path / n for n in ("jax", "port")}, 2,
                               with_auc=True, n_users=3)
    assert len(ckpts) == 3 + 2, ckpts  # round 0 trains all 3, round 1 int(0.8 * 3)
    with np.load(tmp_path / "port" / "global_client0_final.npz") as z:
        if backbone == "test-vit":
            assert z["proj_per_3d_slice.weight"].shape == (3, 16, 5, 5)
        else:
            assert any(k.endswith("running_var") for k in z.files)


def test_unported_branches_raise(fixture_root, tmp_path, restore_stdout):
    """An unknown aggregation model raises; ``--trainer Baseline`` and the
    client-parallel round checkpoints (``--resume``), once refused, now run
    (their parity: tests/test_torch_port_baseline.py,
    tests/test_torch_port_resume.py)."""
    args = tfm.build_arg_parser().parse_args(small_argv(fixture_root, tmp_path / "bn",
                                                        extra=["--model", "FedBN"]))
    with pytest.raises(NotImplementedError, match="Unknown aggregation model"):
        tfm.main(args, device="cpu")
    args = tfm.build_arg_parser().parse_args(small_argv(
        fixture_root, tmp_path / "baseline", 1,
        extra=["--model", "fedavg", "--trainer", "Baseline", "--backbone", "cnn3"]))
    out = tfm.main(args, device="cpu")
    sys.stdout = sys.__stdout__
    assert len(out["acc"]) == 1 and np.isfinite(out["acc"]).all()
    with np.load(tmp_path / "baseline" / "global_client0_final.npz") as z:
        assert z["classifier.weight"].shape == (2, 256)
    args = tfm.build_arg_parser().parse_args(small_argv(
        fixture_root, tmp_path / "resume", 1,
        extra=["--parallel_clients", "--resume", str(tmp_path / "ckpt")]))
    out = tfm.main(args, device="cpu")
    sys.stdout = sys.__stdout__
    assert len(out["acc"]) == 1 and os.listdir(tmp_path / "ckpt") == ["step_0"]


# --------------------------------------------------------------------------- #
# checkpoint conversion
# --------------------------------------------------------------------------- #

def _vit_state_dict(seed=0, width=64, layers=2, patch=8, grid=2, tw=64, tlayers=2,
                    embed=32, ctx=7, vocab=50):
    rng = np.random.default_rng(seed)
    sd = {}

    def put(k, *shape):
        sd[k] = torch.tensor(rng.standard_normal(shape).astype(np.float32)).half()

    put("visual.class_embedding", width)
    put("visual.positional_embedding", grid * grid + 1, width)
    put("visual.conv1.weight", width, 3, patch, patch)
    for n in ("ln_pre", "ln_post"):
        put(f"visual.{n}.weight", width)
        put(f"visual.{n}.bias", width)
    put("visual.proj", width, embed)
    for prefix, w, n_layers in (("visual.transformer", width, layers), ("transformer", tw,
                                                                          tlayers)):
        for i in range(n_layers):
            b = f"{prefix}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                put(f"{b}.{ln}.weight", w)
                put(f"{b}.{ln}.bias", w)
            put(f"{b}.attn.in_proj_weight", 3 * w, w)
            put(f"{b}.attn.in_proj_bias", 3 * w)
            put(f"{b}.attn.out_proj.weight", w, w)
            put(f"{b}.attn.out_proj.bias", w)
            put(f"{b}.mlp.c_fc.weight", 4 * w, w)
            put(f"{b}.mlp.c_fc.bias", 4 * w)
            put(f"{b}.mlp.c_proj.weight", w, 4 * w)
            put(f"{b}.mlp.c_proj.bias", w)
    put("token_embedding.weight", vocab, tw)
    put("positional_embedding", ctx, tw)
    put("ln_final.weight", tw)
    put("ln_final.bias", tw)
    put("text_projection", tw, embed)
    sd["logit_scale"] = torch.tensor(4.6052)
    return sd


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    else:
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_vit_converter_matches_and_loads_from_a_file(tmp_path):
    sd = _vit_state_dict()
    sd_np = {k: v.numpy() for k, v in sd.items()}
    assert tconv.infer_config(sd_np).__dict__ == jconv.infer_config(sd_np).__dict__
    got, got_cfg = tconv.convert_vit_clip(sd_np)
    want, want_cfg = jconv.convert_vit_clip(sd_np)
    assert got_cfg.__dict__ == want_cfg.__dict__
    _assert_trees_equal(got, want)

    # file round trips: a plain torch.save state dict, one wrapped in
    # {"state_dict": ...}, and a TorchScript archive
    plain, wrapped = tmp_path / "ViT-B-16.pt", tmp_path / "clip" / "wrapped.pt"
    wrapped.parent.mkdir()
    torch.save(sd, plain)
    torch.save({"state_dict": sd, "epoch": 3}, wrapped)
    for path in (plain, wrapped):
        _assert_trees_equal(tconv.load_torch_state_dict(str(path)), sd_np)
    scripted = tmp_path / "scripted.pt"
    lin = torch.nn.Linear(3, 2)
    torch.jit.save(torch.jit.script(lin), str(scripted))
    loaded = tconv.load_torch_state_dict(str(scripted))
    np.testing.assert_array_equal(loaded["weight"], lin.weight.detach().numpy())

    assert tconv.find_checkpoint("ViT-B/16", str(tmp_path)) == str(plain)
    assert tconv.find_checkpoint("ViT-B/32", str(tmp_path)) is None
    with pytest.raises(RuntimeError, match="no network"):
        tconv.download_checkpoint("ViT-B/16", str(tmp_path))

    cfg = tconfig.get_cfg_default()
    cfg.MODEL.BACKBONE.NAME = "ViT-B/16"
    cfg.DATASET.ROOT = str(tmp_path)
    bundle = tcc.load_clip_bundle(cfg, "fp32", device="cpu")
    assert bundle.pretrained and bundle.clip_cfg.__dict__ == want_cfg.__dict__
    _assert_trees_equal(bundle.params, want)
    cfg.MODEL.BACKBONE.NAME = "test-rn"  # a ResNet name loads a ResNet bundle
    bundle = tcc.load_clip_bundle(cfg, "fp32", device="cpu")
    assert (bundle.backbone_type, bundle.rn_cfg, bundle.pretrained) == (
        "resnet", tcc.resnet_clip.RN_PRESETS["test-rn"], False)


def test_glob_finds_every_config():
    assert len(CONFIGS) == len(glob.glob(str(ROOT / "configs" / "**" / "*.yaml"),
                                         recursive=True)) > 10
