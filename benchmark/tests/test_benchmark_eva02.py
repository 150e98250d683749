"""The EVA02 tower's plug-in (``archs/eva02.py``) and the RoPE roofline's
reader (``metrics/_rope.py``): multiply-adds by hand at the published
configuration and against PyTorch's FLOP counter over the plain reference
at a small one, the rotary calls of a round, the bound by hand, and the
share over a synthetic traced run."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, spec
from benchmark.metrics import _rope, rope_roofline
from benchmark.reference import model as ref
from benchmark.timeline import TraceView

SLO = spec.load_json(spec.HERE / "traffic" / "slo_fundus_336.json")
CONFIG = spec.load_json(spec.HERE / "configs" / "clip_eva02_l14_336_fairlora.json")


def test_eva02_l14_336_by_hand():
    t, d, f, r, e = 577, 1024, 2730, 12, 768
    # patch embedding 576 x 1024 x (3 * 14 * 14); per layer q/k/v/proj 4 T D^2,
    # w1/w2/w3 3 T D F, scores and weighted sum 2 T^2 D, adapters 3 T (D + F) r;
    # the head T x D x 768
    block = 4 * t * d * d + 3 * t * d * f + 2 * t * t * d + 3 * t * (d + f) * r
    fwd = 576 * d * 588 + 24 * block + t * d * e
    tower = spec.load_arch("eva02")
    arch = CONFIG["arch"]
    got = tower.image_macs(arch, r)
    assert got[0] == fwd == 193_255_992_768  # 386.5 GFLOP an image
    # backward: 23 full blocks (4 T^2 D for attention, twice the adapters), layer
    # 0's w3 input gradient and adapters (w1's and w2's without an input gradient)
    bwd_block = 4 * t * d * d + 3 * t * d * f + 4 * t * t * d + 6 * t * (d + f) * r
    layer0 = t * (f * d + 2 * (f + d) * r + 2 * (2 * f + d) * r)
    assert got[1] == 23 * bwd_block + layer0 + t * d * e
    assert tower.attention(arch) == {"length": 577, "dh": 64, "heads": 16,
                                     "backward": [False] + [True] * 23}


SMALL = {**CONFIG["arch"], "image_resolution": 56, "vision_layers": 2, "vision_width": 128,
         "embed_dim": 32, "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 1}


def _state(arch, method):
    r, g = method["lora_rank"], method["groups"]
    n, d = arch["vision_layers"], arch["vision_width"]
    hidden = int(d * arch["mlp_ratio"])
    state = {}
    for part, (i, o) in (("w1", (d, hidden)), ("w2", (d, hidden)), ("w3", (hidden, d))):
        for leaf, shape in (("lora_A", (n, i, r)), ("lora_S", (n, g, r)), ("lora_B", (n, r, o))):
            state[f"image_encoder_lora.{part}.{leaf}"] = torch.randn(shape).requires_grad_(True)
    return state


@pytest.mark.parametrize("input_grad", [False, True])
def test_counts_match_torch(input_grad, monkeypatch):
    """PyTorch's count of the reference tower's forward and backward (no
    recomputation: the blocks' checkpointing is switched off here)."""
    tower = spec.load_arch("eva02")
    monkeypatch.setattr(tower, "checkpoint", lambda fn, *args, **kwargs: fn(*args))
    config = {**CONFIG, "arch": SMALL}
    method = config["method"]
    sd = {k: torch.randn(shape) * 0.02 if shape else torch.tensor(4.6)
          for k, shape, _ in inputs.checkpoint_leaves(SMALL)}
    model = ref.ReferenceCLIP(sd, config, SLO, "cpu")
    x = torch.randn(2, 3, 56, 56, requires_grad=input_grad)
    mix = ref.group_mix(torch.tensor([0, 1]), method["groups"])
    with FlopCounterMode(display=False) as fwd_count:
        tokens, _ = tower.tokens(model, x, _state(SMALL, method), mix, True)
    with FlopCounterMode(display=False) as bwd_count:
        tokens.sum().backward()
    want = tower.image_macs(SMALL, method["lora_rank"], input_grad)
    # two images at 2 FLOPs a multiply-add, and the group mix's product with
    # each adapter's lora_S ([2, G] x [G, r]; its gradient the same), which
    # the count leaves out
    mix_macs = 3 * SMALL["vision_layers"] * method["groups"] * method["lora_rank"]
    assert fwd_count.get_total_flops() / 4 == want[0] + mix_macs
    assert bwd_count.get_total_flops() / 4 == want[1] + mix_macs


def test_checkpointed_tokens_equal_plain(monkeypatch):
    """The reference's recomputed blocks give the tokens and gradients of
    the plain ones."""
    tower = spec.load_arch("eva02")
    config = {**CONFIG, "arch": SMALL}
    sd = {k: torch.randn(shape) * 0.02 if shape else torch.tensor(4.6)
          for k, shape, _ in inputs.checkpoint_leaves(SMALL)}
    model = ref.ReferenceCLIP(sd, config, SLO, "cpu")
    state = _state(SMALL, config["method"])
    x, mix = torch.randn(2, 3, 56, 56), ref.group_mix(torch.tensor([0, 2]), 3)
    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tower, "checkpoint", lambda fn, *args, **kwargs: fn(*args))
        tokens, _ = tower.tokens(model, x, state, mix, True)
        grads = torch.autograd.grad(tokens.square().sum(), list(state.values()))
        out.append((tokens.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(out[0][1], out[1][1]))


def _run(rounds, ops):
    return types.SimpleNamespace(config=CONFIG, traffic=SLO, traced_rounds=rounds, batch_size=32,
                                 eval_batch_size=100,
                                 trace=TraceView(1.0, 1.0, ops, [], []))


def test_rope_calls_and_share():
    rounds = [{"n_steps": [16, 16], "eval_batches_run": 6}]
    calls = _rope.rope_calls(CONFIG, SLO, rounds, 32, 100)
    train = [c for c in calls if c["images"] == 32]
    assert len(train) == 32 * 24 and sum(c["backward"] for c in train) == 32 * 23
    assert len(calls) - len(train) == 6 * 24 and not any(c["backward"] for c in calls[len(train):])
    # [32, 577, 3072] bf16 read and q, k, v written: 227 MB over 3.35 TB/s
    assert _rope.bound_s(train[0]) == pytest.approx(2 * 32 * 577 * 3072 * 2 / 3.35e12)
    bound = sum(_rope.bound_s(c) * (2 if c["backward"] else 1) for c in calls)
    ops = [("void ffm::rope_qkv_fwd<__nv_bfloat16>(...)", 0.0, bound / 4),
           ("void ffm::rope_qkv_bwd<__nv_bfloat16>(...)", 0.1, bound / 4),
           ("void ffm::attention_fwd_wgmma_kernel<64, 1>(...)", 0.2, 5.0)]
    assert rope_roofline.read(_run(rounds, ops)) == pytest.approx(200.0)
    # no such kernel traced (a program without it), or a tower without rotary calls: no reading
    assert rope_roofline.read(_run(rounds, ops[2:])) is None
    vit = spec.load_json(spec.HERE / "configs" / "clip_vit_b16_fairlora.json")
    assert _rope.rope_calls(vit, SLO, rounds, 32, 100) == []
