"""The port's PromptFL and CLIP trainers, its FedProx term and its six
optimizers against the JAX package's.

* Trainers: each case builds the JAX trainer the way the CLI builds it
  (``setup_cfg`` on the synthetic FairFedMed fixture at 32x32, PREC fp32)
  and the port's trainer from the same numbers: the JAX trainer's frozen
  tree (a ResNet's BatchNorm trees included) through ``params_from_numpy``,
  its ``prompt_learner.ctx`` through ``load_state_dict``.  Compared at atol
  1e-5 (fp32 on both sides, sums in another order): ``model_inference``
  logits, one ``forward_backward`` (loss, acc) and the state after it.
  Cases: PromptFL and CLIP at ``test-vit`` and ``test-rn`` on SLO fundus,
  one with ``NORMALIZE_MEDICAL_INPUT``.  (OCT B-scans reach these trainers
  as 32-channel images, which neither package's towers take.)
* FedProx: the proximal term ``(mu / 2) * ||ctx - ctx_global||^2`` in
  PromptFL and in the prompt-only GLP_OT.  Detached (the default), the
  weights after a step equal those of a step without FedProx and the
  reported loss is higher by the term; differentiable
  (``DIFFERENTIABLE_FEDPROX``), the weights move and equal the JAX
  package's.  Both at atol 1e-5 against the JAX trainer.
* Optimizers: each of ``AVAI_OPTIMS`` against the JAX package's optax
  transform over 8 steps on two parameters, the learning rate going from
  0.01 to 0.001 after step 4 (``set_learning_rate`` on both sides), weight
  decay 5e-4, momentum 0.9 (and 0 for rmsprop), at atol 1e-5.  For amsgrad
  and rmsprop with momentum ``torch.optim``'s own classes are shown to
  compute another function.
"""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]
ATOL = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from tests.fixtures import make_fairfedmed_fixture

    path = tmp_path_factory.mktemp("ffm_promptfl")
    make_fairfedmed_fixture(str(path), n_sites=1, n_train=8, n_test=4, size=32)
    return path


def _plain(node):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in node.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_trainer(root, trainer, backbone, lr=0.001, opts=(), **flags):
    sys.path.insert(0, ".")
    import federated_main
    from fairfedmed_tpu.train import build_trainer

    args = federated_main.build_arg_parser().parse_args([])
    for k, v in dict(
        model="fedavg", trainer=trainer, round=1, num_users=1, frac=1.0, root=str(root),
        output_dir=str(root / "jax_out"), train_batch_size=4, test_batch_size=4, n_ctx=4,
        num_prompt=2, avg_prompt=1, OT="COT", eps=0.1, thresh=1e-3, max_iter=100,
        top_percent=0.8, backbone=backbone, attribute_type="race", attributes=ATTRIBUTES,
        modality_type="slo_fundus", lr=lr, stepsize=200, config_file="",
        dataset_config_file="",
        opts=["DATASET.NAME", "FairFedMed", "INPUT.SIZE", "(32, 32)", "SEED", "1",
              "TEST.EVALUATOR", "Classification_oph", "OPTIM.NAME", "sgd",
              "TRAINER.PROMPTFL.PREC", "fp32", "TRAINER.GLP_OT.PREC", "fp32",
              "INPUT.PIXEL_MEAN", "[0.48145466, 0.4578275, 0.40821073]",
              "INPUT.PIXEL_STD", "[0.26862954, 0.26130258, 0.27577711]", *opts],
        **flags,
    ).items():
        setattr(args, k, v)
    cfg = federated_main.setup_cfg(args)
    return cfg, build_trainer(cfg)


def _port_trainer(cfg, jtr, train):
    """The port's trainer over the JAX trainer's frozen tree and state."""
    from fairfedmed_tpu_torch import config as tconfig
    from fairfedmed_tpu_torch.models import clip_model as tclip
    from fairfedmed_tpu_torch.models import resnet_clip as trn
    from fairfedmed_tpu_torch.models.converter import params_from_numpy
    from fairfedmed_tpu_torch.train import clip_common as tcc
    from fairfedmed_tpu_torch.train.engine import build_trainer
    from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp
    from fairfedmed_tpu_torch.train.trainers import promptfl as tpfl

    jb = jtr.bundle
    frozen = params_from_numpy(_np(jtr.frozen), "cpu")  # one call, BatchNorm trees included
    kw = {}
    if jb.backbone_type == "resnet":
        kw = dict(backbone_type="resnet", rn_cfg=trn.ResNetConfig(**dataclasses.asdict(jb.rn_cfg)),
                  visual_bn=frozen.pop("visual_bn"), visual_stats=frozen.pop("visual_stats"))
        assert all(t.dtype == torch.float32 for t in kw["visual_stats"]["stem"]["bn1"].values())
    bundle = tcc.CLIPBundle(params=frozen,
                            clip_cfg=tclip.CLIPConfig(**dataclasses.asdict(jb.clip_cfg)),
                            policy=tcc.policy_from_prec("fp32"), pretrained=False, **kw)
    tcfg = tconfig.CfgNode(_plain(cfg))
    tcfg.OUTPUT_DIR = str(cfg.OUTPUT_DIR) + "_port"
    dm = types.SimpleNamespace(
        fed_train_loader_x_dict={0: train}, fed_test_loader_x_dict={},
        num_classes=jtr.num_classes, lab2cname=jtr.lab2cname,
        dataset=types.SimpleNamespace(classnames=list(jtr.dm.dataset.classnames)))
    saved = tglp.load_clip_bundle, tpfl.load_clip_bundle
    tglp.load_clip_bundle = tpfl.load_clip_bundle = lambda cfg_, prec, device: bundle
    try:
        ttr = build_trainer(tcfg, dm, device="cpu")
    finally:
        tglp.load_clip_bundle, tpfl.load_clip_bundle = saved
    ttr.load_state_dict(jtr.state_dict(), strict=True)
    assert sorted(ttr.state_dict()) == sorted(jtr.state_dict())
    return ttr


def _pair(root, trainer, backbone, **kw):
    cfg, jtr = _jax_trainer(root, trainer, backbone, **kw)
    np.random.seed(0)
    train = list(jtr.fed_train_loader_x_dict[0])
    return jtr, _port_trainer(cfg, jtr, train), train


def _assert_states_close(got, want, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


# --------------------------------------------------------------------------- #
# the trainers
# --------------------------------------------------------------------------- #

CASES = [("PromptFL", "test-vit", False), ("PromptFL", "test-rn", True),
         ("CLIP", "test-vit", False), ("CLIP", "test-rn", False)]


@pytest.mark.parametrize("trainer,backbone,normalize", CASES,
                         ids=[f"{t}-{b}{'-normalize' if n else ''}" for t, b, n in CASES])
def test_trainer_matches_jax(root, trainer, backbone, normalize):
    opts = ["TRAINER.PROMPTFL.NORMALIZE_MEDICAL_INPUT", "True"] if normalize else []
    jtr, ttr, train = _pair(root, trainer, backbone, opts=opts)
    from fairfedmed_tpu_torch.core.pytree import flatten_paths

    # frozen towers, one prompt bank; only PromptFL's context takes gradients
    assert not any(t.requires_grad for t in flatten_paths(ttr.frozen).values())
    assert ttr.ctx.requires_grad == (trainer == "PromptFL") and ttr.ctx.shape[0] == 1
    assert {k: tuple(v.shape) for k, v in ttr.named_parameters().items()} == \
        {k: tuple(np.shape(v)) for k, v in jtr.named_parameters().items()}

    img = train[0]["img"]
    got = ttr.model_inference(torch.tensor(img)).numpy()
    want = np.asarray(jtr.model_inference(jnp.asarray(img)))
    assert got.shape == (img.shape[0], 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    before = ttr.state_dict()
    for tr in (jtr, ttr):
        tr.num_batches, tr.batch_idx = 3, 0  # not the last batch: no LR step
    got, want = ttr.forward_backward(train[0]), jtr.forward_backward(train[0])
    assert got.keys() == want.keys() == {"loss", "acc"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ATOL), k
    _assert_states_close(ttr.state_dict(), jtr.state_dict())
    moved = np.abs(ttr.state_dict()["prompt_learner.ctx"] - before["prompt_learner.ctx"]).max()
    assert (moved > 0) == (trainer == "PromptFL")

    # a reference checkpoint's [n_ctx, dim] context gets the prompt-bank axis
    ctx2d = np.full(before["prompt_learner.ctx"].shape[1:], 0.25, np.float32)
    ttr.load_state_dict({"prompt_learner.ctx": ctx2d})
    np.testing.assert_array_equal(ttr.state_dict()["prompt_learner.ctx"], ctx2d[None])


# --------------------------------------------------------------------------- #
# FedProx
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("trainer", ["PromptFL", "GLP_OT"])
@pytest.mark.parametrize("differentiable", [False, True], ids=["detached", "differentiable"])
def test_fedprox_term_matches_jax(root, trainer, differentiable):
    # a large step, so that the term's pull (mu * diff = 0.25) shows in the weights
    kw = dict(lr=0.5, differentiable_fedprox=differentiable)
    jtr, ttr, train = _pair(root, trainer, "test-vit", **kw)
    plain = _port_trainer(jtr.cfg, jtr, train)  # the same trainer without FedProx
    ctx0 = jtr.state_dict()["prompt_learner.ctx"]
    rng = np.random.default_rng(3)
    global_state = {"prompt_learner.ctx": ctx0 + 0.5 * rng.standard_normal(ctx0.shape).astype(
        np.float32)}
    term = 0.25 * float(np.sum((ctx0.astype(np.float64) - global_state["prompt_learner.ctx"]) ** 2))
    for tr in (jtr, ttr):
        tr.fedprox, tr.mu = True, 0.5
        tr.set_fedprox_global(global_state)
    out = {}
    for name, tr in (("jax", jtr), ("port", ttr), ("plain", plain)):
        tr.num_batches, tr.batch_idx = 3, 0
        out[name] = tr.forward_backward(train[0])
    assert out["port"]["loss"] == pytest.approx(out["jax"]["loss"], abs=ATOL)
    assert out["port"]["loss"] == pytest.approx(out["plain"]["loss"] + term, abs=ATOL)
    _assert_states_close(ttr.state_dict(), jtr.state_dict())
    shift = max(np.abs(ttr.state_dict()[k] - v).max() for k, v in plain.state_dict().items())
    if differentiable:
        assert shift > 1e-2
    else:
        assert shift == 0.0


# --------------------------------------------------------------------------- #
# the optimizers
# --------------------------------------------------------------------------- #

OPTIMS = [("sgd", 0.9), ("adam", 0.9), ("amsgrad", 0.9), ("rmsprop", 0.9), ("rmsprop", 0.0),
          ("radam", 0.9), ("adamw", 0.9)]


def _run_optimizer(make_step, p0, grads_of):
    """8 steps; the learning rate drops from 0.01 to 0.001 after step 4."""
    params = make_step(None)
    for i in range(8):
        params = make_step((grads_of(params, i), 0.01 if i < 4 else 0.001))
    return params


@pytest.mark.parametrize("name,momentum", OPTIMS, ids=[f"{n}-m{m}" for n, m in OPTIMS])
def test_optimizer_matches_optax(name, momentum):
    from fairfedmed_tpu import config as jconfig
    from fairfedmed_tpu.train import optim as joptim
    from fairfedmed_tpu_torch.train import optim as toptim

    cfg = jconfig.get_cfg_default()
    cfg.OPTIM.NAME, cfg.OPTIM.LR = name, 0.01
    cfg.OPTIM.WEIGHT_DECAY, cfg.OPTIM.MOMENTUM = 5e-4, momentum
    assert name in toptim.AVAI_OPTIMS
    rng = np.random.default_rng(11)
    p0 = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    noise = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(8)]

    def grads_of(params, i):  # a gradient that depends on where the parameters are
        return [np.asarray(p, np.float32) * 0.5 + n for p, n in zip(params, noise[i])]

    tx = joptim.build_optimizer(cfg.OPTIM)
    jstate = {}

    def jax_step(arg):
        if arg is None:
            jstate["p"] = [jnp.asarray(p) for p in p0]
            jstate["s"] = tx.init(jstate["p"])
            return [np.asarray(p) for p in jstate["p"]]
        g, lr = arg
        jstate["s"] = joptim.set_learning_rate(jstate["s"], lr)
        upd, jstate["s"] = tx.update([jnp.asarray(x) for x in g], jstate["s"], jstate["p"])
        jstate["p"] = optax.apply_updates(jstate["p"], upd)
        return [np.asarray(p) for p in jstate["p"]]

    def torch_step_with(factory):
        tp = [torch.tensor(p, requires_grad=True) for p in p0]
        opt = factory(tp)

        def step(arg):
            if arg is not None:
                g, lr = arg
                toptim.set_learning_rate(opt, lr)
                for t, x in zip(tp, g):
                    t.grad = torch.tensor(x)
                opt.step()
            return [t.detach().numpy().copy() for t in tp]
        return step

    want = _run_optimizer(jax_step, p0, grads_of)
    got = _run_optimizer(torch_step_with(lambda tp: toptim.build_optimizer(tp, cfg.OPTIM, 0.01)),
                         p0, grads_of)
    displacement = max(np.abs(w - p).max() for w, p in zip(want, p0))
    assert displacement > 1e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)

    builtin = {"amsgrad": lambda tp: torch.optim.Adam(tp, lr=0.01, amsgrad=True,
                                                      weight_decay=5e-4),
               "rmsprop": lambda tp: torch.optim.RMSprop(tp, lr=0.01, alpha=0.99,
                                                         momentum=momentum, weight_decay=5e-4)}
    if name in builtin and momentum > 0:  # why these two are written by hand
        other = _run_optimizer(torch_step_with(builtin[name]), p0, grads_of)
        assert max(np.abs(o - w).max() for o, w in zip(other, want)) > 1e-3
