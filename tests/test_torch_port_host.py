"""The port's own copies of the JAX package's host modules against the
originals: aggregation, evaluator, metrics (the numpy macro-F1 against
sklearn), LR schedule, config defaults, precision policy and the loss terms.

Inputs are numpy with a fixed seed.  Host numpy code is copied unchanged, so
its results must be equal; the loss terms compare fp32 torch against fp32
JAX at atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score

from fairfedmed_tpu import config as jconfig
from fairfedmed_tpu.evaluation import evaluator as jeval
from fairfedmed_tpu.fed import aggregate as jagg
from fairfedmed_tpu.train import clip_common as jcc
from fairfedmed_tpu.train import optim as joptim
from fairfedmed_tpu_torch import config as tconfig
from fairfedmed_tpu_torch.core.precision import policy_from_prec
from fairfedmed_tpu_torch.evaluation import evaluator as teval
from fairfedmed_tpu_torch.evaluation import metrics as tmetrics
from fairfedmed_tpu_torch.fed import aggregate as tagg
from fairfedmed_tpu_torch.train import clip_common as tcc
from fairfedmed_tpu_torch.train import optim as toptim

torch.set_num_threads(1)


def _client_states(rng, n_clients=3, groups=3, rank=6):
    states = []
    for _ in range(n_clients):
        s = {"prompt_learner.ctx": rng.standard_normal((2, 4, 8)).astype(np.float32)}
        for i in range(2):
            key = f"image_encoder.transformer.resblocks.{i}.mlp.c_fc"
            s[f"{key}.lora_A.weight"] = rng.standard_normal((8, rank)).astype(np.float32)
            s[f"{key}.lora_S.weight"] = rng.uniform(0, 1, (groups, rank)).astype(np.float32)
        states.append(s)
    return states


@pytest.mark.parametrize("shared_half_s", [False, True])
@pytest.mark.parametrize("by_attr", [None, [[3, 0, 5], [1, 0, 2], [4, 0, 1]]])
def test_average_weights_ema_matches(shared_half_s, by_attr):
    rng = np.random.default_rng(0)
    w = _client_states(rng)
    w_g = _client_states(rng, n_clients=1)[0]
    args = (w_g, w, [0, 2], [10, 30, 20], by_attr, 3, 10)
    got = tagg.average_weights_ema(*args, shared_half_s=shared_half_s)
    want = jagg.average_weights_ema(*args, shared_half_s=shared_half_s)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        tagg.average_weights([s["prompt_learner.ctx"] for s in w], [0, 1], [1, 3], islist=True),
        jagg.average_weights([s["prompt_learner.ctx"] for s in w], [0, 1], [1, 3], islist=True))


@pytest.mark.parametrize("seed,n_cls", [(0, 2), (1, 2), (2, 4), (3, 5)])
def test_numpy_macro_f1_matches_sklearn(seed, n_cls):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, n_cls, 40)
    y_pred = np.where(rng.uniform(size=40) < 0.5, y_true, rng.integers(0, n_cls + 1, 40))
    want = f1_score(y_true, y_pred, average="macro", labels=np.unique(y_true), zero_division=0)
    assert tmetrics.macro_f1_score(y_true, y_pred) == pytest.approx(want, abs=1e-12)
    # a label never predicted at all scores 0 (sklearn's zero-division rule)
    assert tmetrics.macro_f1_score([0, 1, 1], [1, 1, 1]) == pytest.approx(
        f1_score([0, 1, 1], [1, 1, 1], average="macro", labels=[0, 1], zero_division=0))


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            for a, b in zip(g, w):
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                           rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float), rtol=1e-12,
                                       equal_nan=True)


def test_classification_oph_results_match():
    cfg = jconfig.get_cfg_default()
    cfg.TEST.EVALUATOR = "Classification_oph"
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal((16, 2)).astype(np.float32), rng.integers(0, 2, 16),
                rng.integers(0, 3, (5, 16))) for _ in range(3)]
    results = []
    for mod in (teval, jeval):
        ev = mod.build_evaluator(cfg, lab2cname={0: "NOT Glaucoma", 1: "Glaucoma"})
        for logits, label, attrs in batches:
            ev.process(logits, label, attrs)
        results.append(list(ev.evaluate().values()))
    _assert_results_equal(*results)


def test_lr_schedule_matches():
    cases = [dict(kind="single_step", stepsize=(200,), gamma=0.1, max_epoch=50),
             dict(kind="single_step", stepsize=(-1,), gamma=0.1, max_epoch=1),
             dict(kind="multi_step", stepsize=[3, 7], gamma=0.5, max_epoch=10),
             dict(kind="cosine", stepsize=(-1,), gamma=0.1, max_epoch=12, warmup_epoch=2,
                  warmup_type="linear"),
             dict(kind="cosine", stepsize=(-1,), gamma=0.1, max_epoch=12, warmup_epoch=3,
                  warmup_type="constant", warmup_recount=False)]
    for case in cases:
        t, j = toptim.LRSchedule(1e-3, **case), joptim.LRSchedule(1e-3, **case)
        assert [t.lr(e) for e in range(20)] == [j.lr(e) for e in range(20)]


def test_cfg_default_equal_and_merge():
    assert tconfig._to_plain(tconfig.get_cfg_default()) == jconfig._to_plain(jconfig.get_cfg_default())
    t, j = tconfig.get_cfg_default(), jconfig.get_cfg_default()
    opts = ["OPTIM.LR", "0.01", "INPUT.SIZE", "(224, 224)", "TRAINER.GLP_OT.N", "2"]
    t.merge_from_list(opts)
    j.merge_from_list(opts)
    assert tconfig._to_plain(t) == jconfig._to_plain(j)


def test_precision_policy_map():
    assert policy_from_prec("fp16").compute_dtype == torch.bfloat16
    assert policy_from_prec("fp16").param_dtype == torch.bfloat16
    assert (policy_from_prec("amp").param_dtype, policy_from_prec("amp").compute_dtype) == \
        (torch.float32, torch.bfloat16)
    assert policy_from_prec("fp32").compute_dtype == torch.float32
    assert policy_from_prec("fp16").norm_dtype == torch.float32
    with pytest.raises(ValueError):
        policy_from_prec("fp8")


@pytest.mark.parametrize("differentiable", [False, True])
def test_loss_terms_match(differentiable):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((12, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 12)
    attr = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0])  # group 2 absent
    tl = torch.tensor(logits, requires_grad=True)
    loss = tcc.fairness_confidence_loss(tl, torch.tensor(labels), torch.tensor(attr), 3,
                                        differentiable=differentiable)
    want = jcc.fairness_confidence_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(attr), 3, differentiable=differentiable)
    assert loss.item() == pytest.approx(float(want), abs=1e-6)
    assert loss.requires_grad == differentiable
    assert float(tcc.cross_entropy(tl.detach(), torch.tensor(labels))) == pytest.approx(
        float(jcc.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), abs=1e-6)
    assert float(tcc.accuracy_from_logits(tl.detach(), torch.tensor(labels))) == pytest.approx(
        float(jcc.accuracy_from_logits(jnp.asarray(logits), jnp.asarray(labels))))


def test_sgd_two_steps_match_optax_chain():
    """The port's SGD with coupled decay == the JAX package's optax chain,
    stepped twice on the same gradient as the FairLoRA trainer does."""
    import optax

    cfg = jconfig.get_cfg_default()
    cfg.OPTIM.NAME = "sgd"
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(10).astype(np.float32)
    grads = [rng.standard_normal(10).astype(np.float32) for _ in range(3)]

    tx = joptim.build_optimizer(cfg.OPTIM)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    opt = toptim.build_optimizer([tp], cfg.OPTIM, cfg.OPTIM.LR)
    for g in grads:
        for _ in range(2):
            upd, state = tx.update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            tp.grad = torch.tensor(g)
            opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-7, rtol=1e-6)
    cfg.OPTIM.NAME = "adagrad"  # not one of AVAI_OPTIMS, on either side
    with pytest.raises(ValueError):
        toptim.build_optimizer([tp], cfg.OPTIM, 1e-3)
    with pytest.raises(ValueError):
        joptim.build_optimizer(cfg.OPTIM)
