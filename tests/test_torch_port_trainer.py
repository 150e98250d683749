"""The port's GLP_OT_SVLoRA trainer against the JAX package's, as a whole.

The JAX trainer is built the way the CLI builds it (``setup_cfg`` on the
synthetic FairFedMed fixture, ``test-vit`` at 32x32, FairLoRA rank 6, 2
prompts, OT None) at PREC fp32.  Its frozen parameters cross into the port
through ``params_from_numpy`` and its trainable state through
``state_dict()``; both stacks then take the batches the JAX loaders yield.
Compared: ``model_inference`` logits, ``forward_backward`` loss/acc/auc over
two batches and the state afterwards, and one FedOTPLoRA round body (two
clients, ``average_weights_ema``, then ``test()`` per client).

Tolerances: logits and losses atol 1e-5, trained state atol 1e-6 (SGD at lr
1e-3 moves the weights by ~1e-3 of the gradient difference), test() metrics
atol 1e-6 -- fp32 on both sides, sums in a different order.
"""

import copy
import sys
import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]


def _jax_trainer(root):
    sys.path.insert(0, ".")
    import federated_main
    from fairfedmed_tpu.train import build_trainer

    args = federated_main.build_arg_parser().parse_args([])
    for k, v in dict(
        model="FedOTPLoRA", trainer="GLP_OT_SVLoRA", round=2, num_users=2, frac=1.0,
        root=str(root), output_dir=str(root / "jax_out"), train_batch_size=4,
        test_batch_size=4, n_ctx=4, num_prompt=2, avg_prompt=1, OT="None",
        backbone="test-vit", attribute_type="race", attributes=ATTRIBUTES,
        modality_type="slo_fundus", unfreeze_image_encoder=True, lora_rank=6,
        lora_alpha=2.0, lora_type="FairLoRA", lambda_fairness=0.5, stepsize=200,
        config_file="", dataset_config_file="",
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


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(jax trainer, port trainer, per-client train batches, count info)."""
    from tests.fixtures import make_fairfedmed_fixture
    from fairfedmed_tpu_torch import config as tconfig
    from fairfedmed_tpu_torch.models.converter import params_from_numpy
    from fairfedmed_tpu_torch.train import clip_common as tcc
    from fairfedmed_tpu_torch.train.engine import build_trainer
    from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp

    root = tmp_path_factory.mktemp("ffm")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    cfg, jtr = _jax_trainer(root)

    np.random.seed(0)
    train = {i: list(jtr.fed_train_loader_x_dict[i]) for i in (0, 1)}
    test = {i: list(jtr.fed_test_loader_x_dict[i]) for i in (0, 1)}
    counts = ([len(jtr.fed_train_loader_x_dict[i].dataset) for i in (0, 1)],
              [jtr.fed_train_loader_x_dict[i].dataset.count_by_attribute("race") for i in (0, 1)])
    jtr.fed_train_loader_x_dict, jtr.fed_test_loader_x_dict = train, test

    frozen = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.frozen), "cpu")
    bundle = tcc.CLIPBundle(params=frozen, clip_cfg=tcc.TEST_PRESETS["test-vit"],
                            policy=tcc.policy_from_prec("fp32"), pretrained=False)
    tcfg = tconfig.CfgNode(_plain(cfg))
    tcfg.OUTPUT_DIR = str(root / "port_out")
    dm = types.SimpleNamespace(
        fed_train_loader_x_dict=train, fed_test_loader_x_dict=test,
        num_classes=jtr.num_classes, lab2cname=jtr.lab2cname,
        dataset=types.SimpleNamespace(classnames=list(jtr.dm.dataset.classnames)))
    orig = tglp.load_clip_bundle
    tglp.load_clip_bundle = lambda cfg_, prec, device: bundle
    try:
        ttr = build_trainer(tcfg, dm, device="cpu")
    finally:
        tglp.load_clip_bundle = orig
    ttr.load_state_dict(jtr.state_dict(), strict=True)
    return jtr, ttr, train, counts


def _assert_states_close(got, want, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def test_inference_logits_match(pair):
    jtr, ttr, train, _ = pair
    batch = train[0][0]
    img = batch["img"]
    attr = batch["attrs"][:, ATTRIBUTES.index("race")]
    got = ttr.model_inference(torch.tensor(img), torch.tensor(attr)).numpy()
    want = np.asarray(jtr.model_inference(jax.numpy.asarray(img), jax.numpy.asarray(attr)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_two_steps_then_round_body_match(pair):
    jtr, ttr, train, (n_by_client, n_by_attr) = pair
    from fairfedmed_tpu.fed.aggregate import average_weights_ema as jax_ema
    from fairfedmed_tpu_torch.fed.aggregate import average_weights_ema as port_ema

    # two forward_backward steps on client 0's batches
    start = jtr.state_dict()
    for tr in (jtr, ttr):
        tr.num_batches = len(train[0])
    for b, batch in enumerate(train[0]):
        jtr.batch_idx = ttr.batch_idx = b
        got, want = ttr.forward_backward(batch), jtr.forward_backward(batch)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k
    _assert_states_close(ttr.state_dict(), jtr.state_dict(), atol=1e-6)

    # one FedOTPLoRA round body (federated_main.py:483-520) on both stacks
    results = {}
    for name, tr, ema in (("jax", jtr, jax_ema), ("port", ttr, port_ema)):
        tr.load_state_dict(start)
        locals_ = {}
        for idx in (0, 1):
            tr.load_state_dict(start)
            tr.train(idx=idx, global_epoch=0, is_fed=True, is_last_client=idx == 1)
            locals_[idx] = tr.state_dict()
        glob = ema(start, locals_, [0, 1], n_by_client, n_by_attr, 0, 2, shared_half_s=True)
        out = []
        for idx in (0, 1):
            personal = copy.deepcopy(glob)
            personal["prompt_learner.ctx"][1:2] = locals_[idx]["prompt_learner.ctx"][1:2]
            tr.load_state_dict(personal)
            out.append(tr.test(idx=idx))
        results[name] = (glob, out)

    _assert_states_close(results["port"][0], results["jax"][0], atol=1e-6)
    for got, want in zip(results["port"][1], results["jax"][1]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            pairs = zip(g, w) if isinstance(w, list) else [(g, w)]
            for a, b in pairs:
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                           atol=1e-6, rtol=0, equal_nan=True)
