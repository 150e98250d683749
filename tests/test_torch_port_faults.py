"""One test for each fault that ROADMAP §3 logged against the port; each
failed before its fix.

1. PromptFL's cosine head at PREC fp16 (bf16): the JAX trainer multiplies
   the l2-normalised features in bf16 and then casts to fp32.  (a) The
   port's logits against the JAX trainer's from the same bf16 weights, at
   ``test-vit``, within a bf16 tolerance: 2^-6 of the logit scale plus 2^-6
   of the value (two towers of bf16 rounding in another order).  (b) Given
   the same bf16 features and a logit scale of 1, the logits are the
   cosines themselves: bf16 numbers (the port multiplied in fp32 before the
   fix), equal to JAX's within one bf16 unit (2^-8 of the value).
2. Training scalars: both CLIs write ``train/<loss|acc|auc>/<client>`` and
   ``train/lr/<client>`` at every batch, at the reference's step
   (``epoch * batches + batch + round * MAX_EPOCH * batches``); the event
   files of 2 sequential FedOTPLoRA rounds hold the same tags and steps,
   and values within atol 1e-5.
3. ``TRAIN.PROFILE_DIR``: the first local epoch is traced into the
   directory (one Chrome trace file), and the CLI says so.
4. ``DATALOADER.TRAIN_X.SAMPLER RandomDomainSampler`` on the FairFedMed
   fixture: both CLIs warn once and shuffle at random, and their runs agree
   (acc/AUC to 1e-6, final weights to 1e-5).
"""

import glob
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.train.trainers import promptfl as jpfl
from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.train.trainers import promptfl as tpfl
from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_cli import _assert_runs_match, _run_both_clis, small_argv
from tests.test_torch_port_promptfl import _jax_trainer, _np, _plain

torch.set_num_threads(1)

BF16_UNIT = 2.0 ** -8


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_faults")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


@pytest.fixture
def restore_stdout():
    saved = sys.stdout
    yield
    sys.stdout = saved


def _port_promptfl_bf16(cfg, jtr):
    """The port's PromptFL at PREC fp16 over the JAX trainer's bf16 frozen
    tree and its context."""
    import dataclasses
    import types

    from fairfedmed_tpu_torch import config as tconfig
    from fairfedmed_tpu_torch.models import clip_model as tclip
    from fairfedmed_tpu_torch.models.converter import params_from_numpy
    from fairfedmed_tpu_torch.train import clip_common as tcc
    from fairfedmed_tpu_torch.train.engine import build_trainer

    bundle = tcc.CLIPBundle(
        params=params_from_numpy(_np(jtr.frozen), "cpu", torch.bfloat16),
        clip_cfg=tclip.CLIPConfig(**dataclasses.asdict(jtr.bundle.clip_cfg)),
        policy=tcc.policy_from_prec("fp16"), pretrained=False)
    dm = types.SimpleNamespace(
        fed_train_loader_x_dict={}, fed_test_loader_x_dict={}, num_classes=jtr.num_classes,
        lab2cname=jtr.lab2cname,
        dataset=types.SimpleNamespace(classnames=list(jtr.dm.dataset.classnames)))
    saved = tpfl.load_clip_bundle
    tpfl.load_clip_bundle = lambda cfg_, prec, device: bundle
    try:
        ttr = build_trainer(tconfig.CfgNode(_plain(cfg)), dm, device="cpu")
    finally:
        tpfl.load_clip_bundle = saved
    ttr.load_state_dict(jtr.state_dict(), strict=True)
    return ttr


def test_fault1_promptfl_cosine_product_in_compute_type(fixture_root, monkeypatch):
    cfg, jtr = _jax_trainer(fixture_root, "PromptFL", "test-vit",
                            opts=["TRAINER.PROMPTFL.PREC", "fp16"])
    ttr = _port_promptfl_bf16(cfg, jtr)
    assert ttr.policy.compute_dtype == torch.bfloat16
    img = np.asarray(next(iter(jtr.fed_train_loader_x_dict[0]))["img"])

    # (a) the whole trainer, within a bf16 tolerance
    got = ttr.model_inference(torch.tensor(img)).numpy()
    want = np.asarray(jtr.model_inference(jnp.asarray(img)), np.float32)
    scale = float(np.exp(np.asarray(jtr.frozen["logit_scale"], np.float32)))
    assert got.dtype == np.float32 and got.shape == want.shape == (img.shape[0], 2)
    np.testing.assert_allclose(got, want, atol=scale * 2.0 ** -6, rtol=2.0 ** -6)

    # (b) the head alone: the same bf16 features on both sides, scale 1
    rng = np.random.default_rng(0)
    pooled = rng.standard_normal((img.shape[0], 32)).astype(np.float32)
    text = pooled[:2] + 0.3 * rng.standard_normal((2, 32)).astype(np.float32)  # cosines near 0.9
    pooled_b, text_b = (torch.tensor(a).to(torch.bfloat16) for a in (pooled, text))
    monkeypatch.setattr(tpfl, "encode_image", lambda *a, **k: (pooled_b, None))
    monkeypatch.setattr(tpfl, "text_encode", lambda *a, **k: text_b)
    monkeypatch.setattr(jpfl, "vit_encode", lambda *a, **k: jnp.asarray(pooled_b.float().numpy(),
                                                                         jnp.bfloat16))
    monkeypatch.setattr(jpfl, "text_encode", lambda *a, **k: jnp.asarray(text_b.float().numpy(),
                                                                          jnp.bfloat16))
    ttr.frozen["logit_scale"] = torch.zeros(())
    jfrozen = dict(jtr.frozen, logit_scale=jnp.float32(0.0))
    with torch.no_grad():
        cos = ttr._forward(torch.tensor(img)).numpy()
    want = np.asarray(jtr._forward(jtr.trainable, jfrozen, jnp.asarray(img)), np.float32)
    assert cos.dtype == np.float32 and 0.5 < np.abs(cos).max() <= 1.0
    as_bf16 = torch.tensor(cos).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(cos, as_bf16)  # the product was rounded to bf16
    assert np.all(np.abs(cos - want) <= BF16_UNIT * np.abs(want)), (cos, want)


def _scalars(out_dir) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(out_dir / "tensorboard"))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_fault2_training_scalars_match_jax(fixture_root, tmp_path, monkeypatch, restore_stdout):
    _run_both_clis(monkeypatch, lambda name: small_argv(fixture_root, tmp_path / name, 2,
                                                       extra=["--frac", "1.0"]))
    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    train_tags = sorted(t for t in want if t.startswith("train/"))
    assert train_tags == [f"train/{m}/{c}" for m in ("acc", "auc", "loss", "lr") for c in (0, 1)]
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                   atol=1e-5, rtol=0, err_msg=tag)
    # 2 batches of 4 per client and round: steps 0, 1 in round 0, 2, 3 in round 1
    assert [s for s, _ in want["train/loss/0"]] == [0, 1, 2, 3]


def test_fault3_profile_dir_traces_the_first_epoch(fixture_root, tmp_path, restore_stdout):
    trace_dir = tmp_path / "trace"
    argv = small_argv(fixture_root, tmp_path / "out", 1, extra=["--frac", "1.0"]) + [
        "TRAIN.PROFILE_DIR", str(trace_dir)]
    tfm.main(tfm.build_arg_parser().parse_args(argv), device="cpu")
    sys.stdout = sys.__stdout__
    traces = glob.glob(str(trace_dir / "*.json"))
    assert len(traces) == 1, traces  # the first epoch only, of two clients' epochs
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("attention" in str(e.get("name", "")) or e.get("ph") == "X" for e in events)
    assert f"Wrote profiler trace to {trace_dir}" in (tmp_path / "out" / "log.txt").read_text()


def test_fault4_structured_sampler_falls_back_like_jax(fixture_root, tmp_path, monkeypatch,
                                                       restore_stdout):
    sampler = ["DATALOADER.TRAIN_X.SAMPLER", "RandomDomainSampler"]
    outs = _run_both_clis(monkeypatch, lambda name: small_argv(
        fixture_root, tmp_path / name, 2) + sampler)
    _assert_runs_match(outs, {n: tmp_path / n for n in ("jax", "port")}, 2, with_auc=True,
                       n_users=2)
    warnings = {}
    for name in ("jax", "port"):
        log = (tmp_path / name / "log.txt").read_text()
        warnings[name] = [line for line in log.splitlines() if "falling back" in line]
    assert warnings["port"] == warnings["jax"] and len(warnings["jax"]) == 1, warnings
    assert "RandomDomainSampler" in warnings["jax"][0]
