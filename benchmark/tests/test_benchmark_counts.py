"""The operation and byte counts the per-layer metrics divide by: against
values worked out by hand, and against PyTorch's own FLOP counter over the
plain reference's towers (forward, and the backward autograd runs when only
the trainable leaves take gradients)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, spec
from benchmark.metrics import _attention, _flops
from benchmark.reference import model as ref


def _config(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def test_vit_b16_by_hand():
    t, d, r = 197, 768, 12
    # patch embedding 196 x 768 x (3 * 16 * 16); per layer q/k/v/out/MLP
    # 12 T D^2, scores and weighted sum 2 T^2 D, adapters 10 T D r; ln_post
    # projection T x D x 512
    assert 196 * 768 * 768 + 12 * (12 * t * d * d + 2 * t * t * d + 10 * t * d * r) \
        + t * d * 512 == 17_858_390_016
    assert _flops.vit_macs(_config("clip_vit_b16_fairlora")["arch"], r) == (17_858_390_016,
                                                                          17_625_378_816)


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


def _trainable(arch, method):
    r, g = method["lora_rank"], method["groups"]
    state = {}

    def leaf(*shape, fill=None):
        t = torch.randn(shape) if fill is None else torch.full(shape, fill)
        return t.requires_grad_(True)

    if arch["kind"] == "vit":
        n, d = arch["vision_layers"], arch["vision_width"]
        for part, (i, o) in (("c_fc", (d, 4 * d)), ("c_proj", (4 * d, d))):
            state[f"image_encoder_lora.{part}.lora_A"] = leaf(n, i, r)
            state[f"image_encoder_lora.{part}.lora_S"] = leaf(n, g, r)
            state[f"image_encoder_lora.{part}.lora_B"] = leaf(n, r, o)
        return state
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


@pytest.mark.parametrize("name", ["clip_vit_b16_fairlora", "clip_rn50_fairlora"])
def test_image_tower_counts_match_torch(name):
    config = _config(name)
    arch, method = config["arch"], config["method"]
    sd = {k: torch.randn(shape) * 0.02 if shape else torch.tensor(4.6)
          for k, shape, _ in inputs.checkpoint_leaves(arch)}
    model = ref.ReferenceCLIP(sd, ["NOT Glaucoma", "Glaucoma"], method, "cpu")
    state = _trainable(arch, method)
    x, mix = torch.randn(2, 3, 224, 224), ref.group_mix(torch.tensor([0, 1]), method["groups"])
    with FlopCounterMode(display=False) as fwd_count:
        if arch["kind"] == "vit":
            tokens = model.vit_tokens(x, state, mix)
        else:
            tokens, _ = model.resnet_tokens(x, state, mix, train=True)
    with FlopCounterMode(display=False) as bwd_count:
        tokens.sum().backward()
    want = (_flops.vit_macs if arch["kind"] == "vit" else _flops.resnet_macs)(arch, method["lora_rank"])
    # two images at 2 FLOPs a multiply-add; the group mix's own tiny product is all that differs
    assert fwd_count.get_total_flops() / 4 == pytest.approx(want[0], rel=1e-5)
    assert bwd_count.get_total_flops() / 4 == pytest.approx(want[1], rel=1e-5)


def test_round_flops_counts_steps_and_valid_rows():
    config = _config("clip_vit_b16_fairlora")
    names = ["NOT Glaucoma", "Glaucoma"]
    image = _flops.vit_macs(config["arch"], 12)
    text = _flops.text_macs(config["arch"], config["method"], names)
    rounds = [{"n_steps": [16, 16], "eval_rows": 600, "eval_batches": 6}]
    want = 2 * (32 * 32 * sum(image) + 32 * sum(text) + 600 * image[0] + 6 * text[0])
    assert _flops.round_flops(config, names, rounds, 32) == want
    assert _flops.text_length(tuple(names), 4) == 10  # SOT X X X X not glaucoma . EOT
