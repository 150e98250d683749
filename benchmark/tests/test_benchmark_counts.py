"""The operation and byte counts the per-layer metrics divide by: against
values worked out by hand, against PyTorch's own FLOP counter over the
plain reference's towers (forward, and the backward autograd runs when only
the trainable leaves take gradients), and the attention calls worked out
from shapes against those caught in the program's own call during tiny
runs of the harness."""

import contextlib
import json
import sys
import time
import types
from collections import Counter

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, inputs, spec
from benchmark.metrics import _attention, _flops
from benchmark.reference import model as ref
from benchmark.timeline import TraceView

DATA = spec.HERE / "tests" / "data"
NAMES = ["NOT Glaucoma", "Glaucoma"]
SLO = spec.load_json(spec.HERE / "traffic" / "slo_fundus.json")
OCT = spec.load_json(spec.HERE / "traffic" / "oct_bscans.json")


def _config(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def test_vit_b16_by_hand():
    t, d, r = 197, 768, 12
    # patch embedding 196 x 768 x (3 * 16 * 16); per layer q/k/v/out/MLP
    # 12 T D^2, scores and weighted sum 2 T^2 D, adapters 10 T D r; ln_post
    # projection T x D x 512
    assert 196 * 768 * 768 + 12 * (12 * t * d * d + 2 * t * t * d + 10 * t * d * r) \
        + t * d * 512 == 17_858_390_016
    vit = spec.load_arch("vit")
    arch = _config("clip_vit_b16_fairlora")["arch"]
    assert vit.image_macs(arch, r) == (17_858_390_016, 17_625_378_816)
    # images that take a gradient (a trainable front end): every layer's full
    # backward (12 T D^2 + 4 T^2 D + 20 T D r) and the patch embedding's
    assert vit.image_macs(arch, r, input_grad=True)[1] == 196 * 768 * 768 + 12 * (
        12 * t * d * d + 4 * t * t * d + 20 * t * d * r) + t * d * 512


def test_attention_bounds_by_hand():
    vision = {"n": 384, "length": 197, "dh": 64, "causal": False, "itemsize": 2}
    # 4 bf16 [384, 197, 64] tensors and the fp32 log-sum-exp over 3.35 TB/s
    assert _attention.bound_s(vision, "fwd") == pytest.approx((4 * 9_682_944 + 302_592) / 3.35e12)
    assert _attention.bound_s(vision, "bwd") == pytest.approx((8 * 9_682_944 + 302_592) / 3.35e12)
    text = {"n": 32, "length": 16, "dh": 64, "causal": True, "itemsize": 2}
    assert _attention.bound_s(text, "fwd") == pytest.approx((4 * 65_536 + 2_048 + 1_024) / 3.35e12)
    big = {"n": 64, "length": 4096, "dh": 64, "causal": True, "itemsize": 2}
    # a long causal call is bound by its needed operations: (L + 1) / 2L of 4 n L^2 dh
    assert _attention.bound_s(big, "fwd") == pytest.approx(
        4 * 64 * 4096 ** 2 * 64 * (4097 / 8192) / 989e12)


def _leaf(*shape, fill=None):
    t = torch.randn(shape) if fill is None else torch.full(shape, fill)
    return t.requires_grad_(True)


def _vit_state(arch, method):
    r, g = method["lora_rank"], method["groups"]
    state = {}
    n, d = arch["vision_layers"], arch["vision_width"]
    for part, (i, o) in (("c_fc", (d, 4 * d)), ("c_proj", (4 * d, d))):
        state[f"image_encoder_lora.{part}.lora_A"] = _leaf(n, i, r)
        state[f"image_encoder_lora.{part}.lora_S"] = _leaf(n, g, r)
        state[f"image_encoder_lora.{part}.lora_B"] = _leaf(n, r, o)
    return state


def _resnet_state(arch, method):
    r, g = method["lora_rank"], method["groups"]
    state = {}
    leaf = _leaf
    w = arch["vision_width"]

    def bn(path, dim):
        state[f"visual_bn.{path}.weight"] = leaf(dim, fill=1.0)
        state[f"visual_bn.{path}.bias"] = leaf(dim, fill=0.0)
        state[f"__bn_stats__.{path}.mean"] = torch.zeros(dim)
        state[f"__bn_stats__.{path}.var"] = torch.ones(dim)

    for i, dim in ((1, w // 2), (2, w // 2), (3, w)):
        bn(f"stem.bn{i}", dim)
    inplanes = w
    for li, blocks in enumerate(arch["vision_layers"]):
        planes = w * 2 ** li
        for bi in range(blocks):
            p = f"layer{li + 1}.{bi}"
            for conv, (cin, cout) in (("conv1", (inplanes, planes)), ("conv3", (planes, 4 * planes))):
                state[f"image_encoder_lora.{p}.{conv}.lora_A"] = leaf(cin, r)
                state[f"image_encoder_lora.{p}.{conv}.lora_S"] = leaf(g, r)
                state[f"image_encoder_lora.{p}.{conv}.lora_B"] = leaf(r, cout)
            for name, dim in (("bn1", planes), ("bn2", planes), ("bn3", 4 * planes)):
                bn(f"{p}.{name}", dim)
            if bi == 0:
                bn(f"{p}.downsample_bn", 4 * planes)
            inplanes = 4 * planes
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        state[f"attnpool_lora.{name}.lora_A"] = leaf(32 * w, r)
        state[f"attnpool_lora.{name}.lora_B"] = leaf(r, arch["embed_dim"] if name == "c_proj" else 32 * w)
    return state


@pytest.mark.parametrize("name,state_of,input_grad", [
    ("clip_vit_b16_fairlora", _vit_state, False), ("clip_vit_b16_fairlora", _vit_state, True),
    ("clip_rn50_fairlora", _resnet_state, False), ("clip_rn50_fairlora", _resnet_state, True)],
    ids=["vit", "vit_input_grad", "resnet", "resnet_input_grad"])
def test_image_tower_counts_match_torch(name, state_of, input_grad):
    config = _config(name)
    arch, method = config["arch"], config["method"]
    tower = spec.load_arch(arch["kind"])
    sd = {k: torch.randn(shape) * 0.02 if shape else torch.tensor(4.6)
          for k, shape, _ in inputs.checkpoint_leaves(arch)}
    model = ref.ReferenceCLIP(sd, config, SLO, "cpu")
    state = state_of(arch, method)
    x, mix = torch.randn(2, 3, 224, 224), ref.group_mix(torch.tensor([0, 1]), method["groups"])
    x.requires_grad_(input_grad)
    with FlopCounterMode(display=False) as fwd_count:
        tokens, _ = tower.tokens(model, x, state, mix, True)
    with FlopCounterMode(display=False) as bwd_count:
        tokens.sum().backward()
    want = tower.image_macs(arch, method["lora_rank"], input_grad)
    # two images at 2 FLOPs a multiply-add; the group mix's own tiny product is all that differs
    assert fwd_count.get_total_flops() / 4 == pytest.approx(want[0], rel=1e-5)
    assert bwd_count.get_total_flops() / 4 == pytest.approx(want[1], rel=1e-5)


def test_oct_front_counts_match_torch():
    """The slice projector a volume: its forward, and its weight gradient
    alone (the volumes are data), against PyTorch's count."""
    oct_ = spec.load_modality("oct_bscans")
    model = ref.ReferenceCLIP({"token_embedding.weight": torch.zeros(49408, 8),
                               "positional_embedding": torch.zeros(77, 8)},
                              _config("clip_vit_b16_fairlora"), OCT, "cpu")
    state = {"proj_per_3d_slice.weight": _leaf(3, 16, 5, 5), "proj_per_3d_slice.bias": _leaf(3)}
    img = torch.rand(2, 32, 224, 224) * 255
    with FlopCounterMode(display=False) as fwd_count:
        x = oct_.front(model, img, state)
    with FlopCounterMode(display=False) as bwd_count:
        x.sum().backward()
    assert x.shape == (4, 3, 224, 224)
    assert oct_.front_macs(OCT) == (2 * 224 * 224 * 3 * 16 * 25,) * 2
    assert fwd_count.get_total_flops() / 4 == oct_.front_macs(OCT)[0]
    assert bwd_count.get_total_flops() / 4 == oct_.front_macs(OCT)[1]


def test_round_flops_counts_steps_and_valid_rows():
    config = _config("clip_vit_b16_fairlora")
    names = ["NOT Glaucoma", "Glaucoma"]
    image = spec.load_arch("vit").image_macs(config["arch"], 12)
    text = _flops.text_macs(config["arch"], config["method"], names)
    rounds = [{"n_steps": [16, 16], "eval_rows": 600, "eval_batches": 6}]
    want = 2 * (32 * 32 * sum(image) + 32 * sum(text) + 600 * image[0] + 6 * text[0])
    assert _flops.round_flops(config, SLO, rounds, 32) == want
    assert _flops.text_length(tuple(names), 4) == 10  # SOT X X X X not glaucoma . EOT
    # OCT: two images a volume, each taking a gradient, and the slice projector
    image = spec.load_arch("vit").image_macs(config["arch"], 12, input_grad=True)
    front = 2 * 224 * 224 * 3 * 16 * 25
    rounds = [{"n_steps": [3, 3], "eval_rows": 96, "eval_batches": 3}]
    want = 2 * (6 * 32 * (2 * front + 2 * sum(image)) + 6 * sum(text)
                + 96 * (front + 2 * image[0]) + 3 * text[0])
    assert _flops.round_flops(config, OCT, rounds, 32) == want


class AttentionCalls:
    """Wraps the model's attention entry
    (``fairfedmed_tpu_torch.models.clip_model.flash_attention``) while
    installed, recording each call's shape, causality and whether a
    backward will follow: the count the harness once took in the program,
    kept here to hold the count from shapes to."""

    def __init__(self, calls: list):
        self.calls = calls

    def __enter__(self):
        from fairfedmed_tpu_torch.models import clip_model

        self.module, self.inner = clip_model, clip_model.flash_attention
        calls, inner = self.calls, self.inner

        def flash_attention(q, k, v, mask=None, scale=None):
            b, h, length, dh = q.shape
            calls.append({"n": b * h, "length": length, "dh": dh, "causal": mask is not None,
                          "itemsize": q.element_size(),
                          "backward": torch.is_grad_enabled() and any(
                              t.requires_grad for t in (q, k, v))})
            return inner(q, k, v, mask, scale)

        clip_model.flash_attention = flash_attention
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.inner


def _functions():
    """Every function and class bound in a loaded module of the program."""
    return {(name, attr): obj for name, mod in list(sys.modules.items())
            if name.split(".")[0] == "fairfedmed_tpu_torch" and mod is not None
            for attr, obj in vars(mod).items() if callable(obj)}


@pytest.mark.parametrize("kind,traffic,vision", [("vit", "slo", True), ("rn", "slo", False),
                                                  ("vit", "oct", True)],
                         ids=["vit_slo", "rn_slo", "vit_oct"])
def test_attention_calls_equal_the_intercepted(kind, traffic, vision, tmp_path, monkeypatch):
    """Two traced rounds with their evaluations at a tiny size: the calls
    worked out from the configuration equal, call for call, those caught
    in the program's attention entry over the same rounds; and the harness
    leaves the program's functions as it found them."""
    from fairfedmed_tpu_torch import federated_main  # noqa: F401  (the program's modules)
    from fairfedmed_tpu_torch.models import clip_model

    bench = {"configs": [{"name": f"tiny_{kind}",
                          "file": f"benchmark/tests/data/configs/tiny_{kind}.json"}],
             "workloads": [{"name": f"tiny_{kind}_{traffic}", "config": f"tiny_{kind}",
                            "traffic": f"tiny_{traffic}", "chips": 1}], "end_to_end": [],
             "per_layer": []}
    cell = spec.load_cell(f"tiny_{kind}_{traffic}", bench, root=DATA)
    cell.workload = {**cell.workload, "trace_rounds": 2}
    before, original = _functions(), clip_model.flash_attention
    calls, at_trace = [], []
    profile = torch.profiler.profile

    @contextlib.contextmanager
    def intercepted(*args, **kwargs):  # the traced rounds, caught as the harness once did
        at_trace.append(_functions())
        with AttentionCalls(calls), profile(*args, **kwargs) as prof:
            yield prof

    monkeypatch.setattr(torch.profiler, "profile", intercepted)
    run = harness.run_cell(cell, 2 ** 31 + 91, 0.3, True, "cpu", str(tmp_path / "work"),
                           time.perf_counter())
    assert clip_model.flash_attention is original
    after = _functions()
    assert len(at_trace) == 1
    for then in (before, at_trace[0]):  # modules the run imported are left out of `before`
        assert {k: v for k, v in after.items() if k in then} == then

    assert len(run.traced_rounds) == 2
    assert all(sum(r["n_steps"]) > 0 and r["eval_batches_run"] > 0 for r in run.traced_rounds)
    derived = _flops.attention_calls(cell.config, cell.traffic, run.traced_rounds,
                                     run.batch_size, run.eval_batch_size)

    def key(call):
        return tuple(sorted(call.items()))

    assert Counter(map(key, derived)) == Counter(map(key, calls))
    assert {c["backward"] for c in calls} == {True, False}
    assert {c["causal"] for c in calls} == ({True, False} if vision else {True})


def _vit_run(rounds, ops):
    return types.SimpleNamespace(
        config=_config("clip_vit_b16_fairlora"), traffic=SLO, batch_size=32,
        eval_batch_size=100, traced_rounds=rounds,
        trace=TraceView(window_s=1.0, busy_s=0.5, ops=ops, gaps=[], device_ops=[]))


def test_roofline_share_counts_the_rounds_calls():
    """The reader on a synthetic run: the calls a round of the ViT cell
    demands (32 steps, 6 evaluation batches of 100) over the time of the
    kernels that match, with no record of calls on the run."""
    ops = [("void ffm::attention_fwd_wgmma_kernel<64, 0>", 0.0, 0.002),
           ("void ffm::attention_fwd_packed_kernel<64>", 0.01, 0.001),
           ("void ffm::attention_bwd_wgmma_kernel<64, 0>", 0.02, 0.004),
           ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 0.03, 0.05)]
    run = _vit_run([{"n_steps": [16, 16], "eval_batches_run": 6}], ops)
    assert not hasattr(run, "attn_calls")
    assert _flops.text_run_length(tuple(NAMES), 4, 77) == 16  # 10 needed, rounded up to 8s
    train = {"n": 384, "length": 197, "dh": 64, "causal": False, "itemsize": 2}
    evaluated = {**train, "n": 1200}
    text = {"n": 32, "length": 16, "dh": 64, "causal": True, "itemsize": 2}
    b = _attention.bound_s
    fwd = 32 * 12 * (b(train, "fwd") + b(text, "fwd")) + 6 * 12 * (b(evaluated, "fwd")
                                                                 + b(text, "fwd"))
    bwd = 32 * (11 * b(train, "bwd") + 12 * b(text, "bwd"))  # layer 0's vision call: none
    assert _attention.roofline_share(run, "fwd") == pytest.approx(100 * fwd / 0.003)
    assert _attention.roofline_share(run, "bwd") == pytest.approx(100 * bwd / 0.004)
    assert _attention.counts(run) == {"fwd_calls": 38 * 24, "bwd_calls": 32 * 23,
                                      "fwd_kernels": 2, "bwd_kernels": 1}

    evaluation_only = _vit_run([{"n_steps": [0, 0], "eval_batches_run": 6}], ops)
    assert _attention.roofline_share(evaluation_only, "bwd") is None
    assert _attention.roofline_share(evaluation_only, "fwd") == pytest.approx(
        100 * 6 * 12 * (b(evaluated, "fwd") + b(text, "fwd")) / 0.003)

    no_kernel = _vit_run([{"n_steps": [16, 16], "eval_batches_run": 6}], ops[3:])
    for which in ("fwd", "bwd"):
        with pytest.raises(RuntimeError, match="no kernel"):
            _attention.roofline_share(no_kernel, which)
