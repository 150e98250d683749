"""The port's GLP-OT trainer family against the JAX package's, as a whole.

Each case builds the JAX trainer the way the CLI builds it (``setup_cfg`` on
the synthetic FairFedMed fixture at 32x32, PREC fp32) and the port's trainer
from the same numbers: the JAX frozen parameters (and ResNet BatchNorm
affine and statistics) through ``params_from_numpy``, the trainable state
through ``state_dict()`` / ``load_state_dict()``.  Both then take the
batches the JAX loaders yield.  Compared: ``model_inference`` logits (atol
1e-5), two ``forward_backward`` steps (loss / acc / auc, atol 1e-5) and the
state afterwards (atol 1e-6), the tolerances of test_torch_port_trainer.py;
the ResNet running statistics in the state, batch moments of activations,
to 1e-5 relative to their largest value.

Cases: GLP_OT_SVLoRA over backbone (``test-vit``, ``test-rn``) x modality
(``slo_fundus``, ``oct_bscans`` with 16 B-scans per slice, so 2 slices per
volume) x OT (None, Sinkhorn, COT), and the prompt-only GLP_OT with
``UNFREEZE_IMAGE_ENCODER`` on each backbone.  One more test makes the plan
invalid (EPS 1e-4: the kernel underflows to 0) after a valid step and holds
that parameters and momentum stay, on both sides, while the ResNet running
statistics move.
"""

import dataclasses
import sys
import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from tests.fixtures import make_fairfedmed_fixture

    path = tmp_path_factory.mktemp("ffm_glp")
    make_fairfedmed_fixture(str(path), n_sites=1, n_train=8, n_test=4, size=32)
    return path


def _jax_trainer(root, trainer, backbone, modality, ot, eps=0.1):
    sys.path.insert(0, ".")
    import federated_main
    from fairfedmed_tpu.train import build_trainer

    args = federated_main.build_arg_parser().parse_args([])
    for k, v in dict(
        model="FedOTPLoRA", trainer=trainer, round=1, num_users=1, frac=1.0,
        root=str(root), output_dir=str(root / "jax_out"), train_batch_size=4,
        test_batch_size=4, n_ctx=4, num_prompt=2, avg_prompt=1, OT=ot, eps=eps,
        thresh=1e-3, max_iter=100, top_percent=0.8, backbone=backbone, attribute_type="race",
        attributes=ATTRIBUTES, modality_type=modality, dim_per_3d_slice=16,
        unfreeze_image_encoder=True, lora_rank=6, lora_alpha=2.0, lora_type="FairLoRA",
        lambda_fairness=0.5, stepsize=200, config_file="", dataset_config_file="",
        opts=["DATASET.NAME", "FairFedMed", "INPUT.SIZE", "(32, 32)", "SEED", "1",
              "TEST.EVALUATOR", "Classification_oph", "OPTIM.NAME", "sgd",
              "TRAINER.GLP_OT.PREC", "fp32",
              "INPUT.PIXEL_MEAN", "[0.48145466, 0.4578275, 0.40821073]",
              "INPUT.PIXEL_STD", "[0.26862954, 0.26130258, 0.27577711]"],
    ).items():
        setattr(args, k, v)
    cfg = federated_main.setup_cfg(args)
    return cfg, build_trainer(cfg)


def _plain(node):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in node.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(root, trainer, backbone, modality, ot, eps=0.1):
    """(jax trainer, port trainer, client 0's train batches)."""
    from fairfedmed_tpu_torch import config as tconfig
    from fairfedmed_tpu_torch.models import clip_model as tclip
    from fairfedmed_tpu_torch.models import resnet_clip as trn
    from fairfedmed_tpu_torch.models.converter import params_from_numpy
    from fairfedmed_tpu_torch.train import clip_common as tcc
    from fairfedmed_tpu_torch.train.engine import build_trainer
    from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp

    cfg, jtr = _jax_trainer(root, trainer, backbone, modality, ot, eps)
    np.random.seed(0)
    train = list(jtr.fed_train_loader_x_dict[0])
    jb = jtr.bundle
    frozen = {k: v for k, v in _np(jtr.frozen).items() if k != "visual_bn"}
    kw = {}
    if jb.backbone_type == "resnet":
        kw = dict(backbone_type="resnet",
                  rn_cfg=trn.ResNetConfig(**dataclasses.asdict(jb.rn_cfg)),
                  visual_bn=params_from_numpy(_np(jb.visual_bn), "cpu"),
                  visual_stats=params_from_numpy(_np(jtr.stats), "cpu"))
    bundle = tcc.CLIPBundle(params=params_from_numpy(frozen, "cpu"),
                            clip_cfg=tclip.CLIPConfig(**dataclasses.asdict(jb.clip_cfg)),
                            policy=tcc.policy_from_prec("fp32"), pretrained=False, **kw)
    tcfg = tconfig.CfgNode(_plain(cfg))
    tcfg.OUTPUT_DIR = str(root / "port_out")
    dm = types.SimpleNamespace(
        fed_train_loader_x_dict={0: train}, fed_test_loader_x_dict={},
        num_classes=jtr.num_classes, lab2cname=jtr.lab2cname,
        dataset=types.SimpleNamespace(classnames=list(jtr.dm.dataset.classnames)))
    orig = tglp.load_clip_bundle
    tglp.load_clip_bundle = lambda cfg_, prec, device: bundle
    try:
        ttr = build_trainer(tcfg, dm, device="cpu")
    finally:
        tglp.load_clip_bundle = orig
    ttr.load_state_dict(jtr.state_dict(), strict=True)
    assert sorted(ttr.state_dict()) == sorted(jtr.state_dict())
    return jtr, ttr, train


def _assert_states_close(got, want, atol):
    """Parameters to ``atol``; ResNet running statistics, which are batch
    moments of the activations and not SGD-damped, to the activations'
    1e-5 relative to their largest value (running variances are ~1)."""
    assert got.keys() == want.keys()
    for k in want:
        tol = atol if "running_" not in k else max(atol, 1e-5 * max(1.0, np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)


CASES = [("GLP_OT_SVLoRA", backbone, modality, ot)
         for backbone in ("test-vit", "test-rn")
         for modality in ("slo_fundus", "oct_bscans")
         for ot in ("None", "Sinkhorn", "COT")]
CASES += [("GLP_OT", "test-vit", "slo_fundus", "COT"), ("GLP_OT", "test-rn", "oct_bscans", "Sinkhorn")]


@pytest.mark.parametrize("trainer,backbone,modality,ot", CASES,
                         ids=["-".join(c) for c in CASES])
def test_trainer_matches_jax(root, trainer, backbone, modality, ot):
    jtr, ttr, train = _pair(root, trainer, backbone, modality, ot)
    if trainer == "GLP_OT":
        assert ttr.disable_attr and ttr.num_groups == 1 and ttr.opt_steps_per_batch == 2
        assert ("visual_ln_pre" in ttr.trainable) == (backbone == "test-vit")
    if modality == "oct_bscans":
        assert "proj_per_3d_slice.weight" in ttr.state_dict()

    batch = train[0]
    attr = batch["attrs"][:, ATTRIBUTES.index("race")]
    t_attr, j_attr = (None, None) if ttr.disable_attr else (torch.tensor(attr),
                                                            jax.numpy.asarray(attr))
    got = ttr.model_inference(torch.tensor(batch["img"]), t_attr).numpy()
    want = np.asarray(jtr.model_inference(jax.numpy.asarray(batch["img"]), j_attr))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    for tr in (jtr, ttr):
        tr.num_batches = 3  # not the last batch: no LR step
    for b in range(2):
        jtr.batch_idx = ttr.batch_idx = b
        got, want = ttr.forward_backward(train[b]), jtr.forward_backward(train[b])
        assert got.keys() == want.keys() and np.isfinite(got["loss"])
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k
    _assert_states_close(ttr.state_dict(), jtr.state_dict(), atol=1e-6)


def test_invalid_plan_skips_the_step_on_both_sides(root):
    jtr, ttr, train = _pair(root, "GLP_OT_SVLoRA", "test-rn", "slo_fundus", "Sinkhorn")
    for tr in (jtr, ttr):
        tr.num_batches, tr.batch_idx = 3, 0
    for tr in (jtr, ttr):  # a valid step first, so there is momentum to keep
        assert np.isfinite(tr.forward_backward(train[0])["loss"])

    def params_and_momentum(tr):
        state = {k: v for k, v in tr.state_dict().items() if "running_" not in k}
        if tr is ttr:
            mom = [v.clone() for g in tr.optimizer.param_groups for p in g["params"]
                   for v in tr.optimizer.state[p].values()]
            return state, [m.numpy() for m in mom]
        return state, [np.array(x, copy=True) for x in jax.tree_util.tree_leaves(tr.opt_state)]

    def stats(tr):
        return {k: v for k, v in tr.state_dict().items() if "running_" in k}

    before = {tr: (params_and_momentum(tr), stats(tr)) for tr in (jtr, ttr)}
    for tr in (jtr, ttr):  # EPS 1e-4: exp(-(1 - sim) / EPS) underflows to 0
        tr.cfg.defrost()
        tr.cfg.TRAINER.GLP_OT.EPS = 1e-4
        tr.cfg.freeze()
    jtr._compile_steps()
    tr_out = {}
    for tr in (jtr, ttr):
        tr.batch_idx = 1
        tr_out[tr] = tr.forward_backward(train[1])
    assert np.isnan(tr_out[ttr]["loss"]) and np.isnan(tr_out[jtr]["loss"])
    assert tr_out[ttr].keys() == tr_out[jtr].keys() == {"loss", "acc"}
    for tr in (jtr, ttr):
        (state0, mom0), stats0 = before[tr]
        state1, mom1 = params_and_momentum(tr)
        _assert_states_close(state1, state0, atol=0)
        assert len(mom1) == len(mom0) > 0 and any(np.abs(m).max() > 0 for m in mom0)
        for m1, m0 in zip(mom1, mom0):
            np.testing.assert_array_equal(m1, m0)
        moved = stats(tr)
        assert moved.keys() == stats0.keys() and len(moved) > 0
        assert all(not np.array_equal(moved[k], stats0[k]) for k in moved)
    # the running statistics moved the same way on both sides
    _assert_states_close(stats(ttr), stats(jtr), atol=1e-6)
