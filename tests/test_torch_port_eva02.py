"""EVA02-CLIP's vision tower in the port (``models/eva_clip.py``,
``ops/rope.py``, ``models/converter.py:convert_eva02_clip``, the FairLoRA
trainer on ``w1``/``w2``/``w3``) against the benchmark's plain float32
reference (``benchmark/archs/eva02.py`` through ``ReferenceCLIP``), on the
CPU in fp32 with seeded random weights at the tiny preset ``test-eva``: 2
heads of 64, a 4 x 4 grid (32 px, patch 8) whose rotary positions are
interpolated from a 2 x 2 pretraining grid, an MLP of odd width (341).

Tolerances, all relative to the largest reference value: 1e-4 for the
tower's tokens (fp32 on both sides; the patch embedding is a matmul here
and a convolution in the reference, and sums run in other orders over 24
products of 128-341 terms, ~1e-6 each); 1e-6 for the RoPE op against the
reference's rotation (the same fp32 products, one rounding); the harness's
tiny limits (``benchmark/tests/data/workloads/tiny_vit_slo.json``: loss
1e-4, gradients 1e-3 / 1e-4, evaluation logits 1e-6 of the logit scale) for
whole rounds.  A rotation of halves in place of interleaved pairs, or an MLP
without ``ffn_ln``, misses the token tolerance at least tenfold
(``test_a_wrong_tower_fails_the_tolerance``).
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import harness, inputs, spec  # noqa: E402
from benchmark.archs import eva02 as ref_eva  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from fairfedmed_tpu_torch.core.precision import policy_from_prec  # noqa: E402
from fairfedmed_tpu_torch.models import converter, eva_clip  # noqa: E402
from fairfedmed_tpu_torch.ops import rope as R  # noqa: E402

torch.set_num_threads(1)

CFG, TEXT_CFG = eva_clip.PRESETS["test-eva"]
TOKEN_TOL = 1e-4
ROPE_TOL = 1e-6
DATA = os.path.join(REPO, "benchmark", "tests", "data")
SEED = 2 ** 31 + 11


def _tiny_config() -> dict:
    """The benchmark's EVA02 configuration at the tiny preset's sizes."""
    with open(os.path.join(REPO, "benchmark", "configs", "clip_eva02_l14_336_fairlora.json")) as f:
        config = json.load(f)
    config["name"], config["backbone"] = "tiny_eva", "test-eva"
    config["arch"].update(embed_dim=CFG.embed_dim, image_resolution=CFG.image_resolution,
                          vision_layers=CFG.vision_layers, vision_width=CFG.vision_width,
                          vision_patch_size=CFG.vision_patch_size,
                          pt_hw_seq_len=CFG.pt_hw_seq_len,
                          transformer_width=TEXT_CFG.transformer_width,
                          transformer_heads=TEXT_CFG.transformer_heads,
                          transformer_layers=TEXT_CFG.transformer_layers)
    config["method"]["prec"] = "fp32"
    config["flags"]["--backbone"] = "test-eva"
    config["opts"] = ["INPUT.SIZE", "(32, 32)", "TRAINER.GLP_OT.PREC", "fp32", "USE_CUDA", "False"]
    return config


def _traffic() -> dict:
    with open(os.path.join(DATA, "traffic", "tiny_slo.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_rope(monkeypatch):
    """The reference's rotary positions interpolated from the tiny preset's
    2 x 2 pretraining grid."""
    monkeypatch.setattr(ref_eva, "PT_HW_SEQ_LEN", CFG.pt_hw_seq_len)


def _checkpoint(seed: int = 0) -> dict:
    """A tiny checkpoint in EVA-CLIP's layout with every leaf random: the
    biases (q and v only), LayerNorms and head moved off their init, so that
    each shows in the tokens, and q and k 8x EVA's init, so that attention,
    and with it the rotary positions, is far from uniform."""
    sd = inputs.make_checkpoint(_tiny_config()["arch"], seed, "cpu", {})
    gen = torch.Generator().manual_seed(seed + 1)
    for key, value in sd.items():
        if key.startswith("visual.") and ("bias" in key or "norm" in key or "_ln" in key):
            sd[key] = (value.float() + 0.1 * torch.randn(value.shape, generator=gen)).half()
        elif key.endswith(("q_proj.weight", "k_proj.weight")):
            sd[key] = value * 8
    return sd


def _program_visual(sd: dict) -> dict:
    tree, _ = converter.convert_eva02_clip({k: v.numpy() for k, v in sd.items()}, CFG)
    return converter.params_from_numpy(tree["visual"], "cpu")


def _lora(gen: torch.Generator, groups: int = 3, rank: int = 4) -> dict:
    """Nonzero adapters for the three MLP products, stacked per layer."""
    dims = {"w1": (CFG.vision_width, CFG.mlp_hidden), "w2": (CFG.vision_width, CFG.mlp_hidden),
            "w3": (CFG.mlp_hidden, CFG.vision_width)}
    n = CFG.vision_layers
    return {part: {"lora_A": 0.1 * torch.randn(n, din, rank, generator=gen),
                   "lora_S": torch.rand(n, groups, rank, generator=gen),
                   "lora_B": torch.randn(n, rank, dout, generator=gen)}
            for part, (din, dout) in dims.items()}


def _images(gen, b=3):
    return torch.randn(b, 3, CFG.image_resolution, CFG.image_resolution, generator=gen)


def _reference(sd: dict):
    return ref.ReferenceCLIP(sd, _tiny_config(), _traffic(), "cpu")


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _tokens_both(sd, x, lora=None, attr=None, scaling=0.5):
    """(program tokens, reference tokens) of images ``x``."""
    policy = policy_from_prec("fp32")
    model = _reference(sd)
    mix, state = None, None
    if lora is not None:
        mix = ref.group_mix(attr, 3)
        model.scaling = scaling
        state = {f"image_encoder_lora.{part}.{leaf}": t for part, leaves in lora.items()
                 for leaf, t in leaves.items()}
    got = eva_clip.eva_encode(_program_visual(sd), x, CFG, policy, return_tokens=True,
                              lora=lora, attr_mix=mix, lora_scaling=scaling)
    want, _ = ref_eva.tokens(model, x, state, mix, train=False)
    return got, want


def test_tokens_match_the_reference(tiny_rope):
    gen = torch.Generator().manual_seed(3)
    sd, x = _checkpoint(), _images(gen)
    got, want = _tokens_both(sd, x)
    assert got.shape == (3, CFG.grid_size ** 2 + 1, CFG.embed_dim)
    assert _gap(got, want) <= TOKEN_TOL
    pooled = eva_clip.eva_encode(_program_visual(sd), x, CFG, policy_from_prec("fp32"))
    assert _gap(pooled, want[:, 0]) <= TOKEN_TOL  # the class token through norm and head


def test_fairlora_tokens_match_the_reference(tiny_rope):
    gen = torch.Generator().manual_seed(4)
    sd, x = _checkpoint(), _images(gen)
    lora, attr = _lora(gen), torch.tensor([0, 2, 1])
    got, want = _tokens_both(sd, x, lora, attr)
    plain, _ = _tokens_both(sd, x)
    assert _gap(got, want) <= TOKEN_TOL
    assert _gap(plain, want) > 100 * TOKEN_TOL  # the adapters move the tokens


def _rotate_halves(u):
    a, b = u.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _swiglu_without_ffn_ln(p, g, lora=None, attr_mix=None, lora_scaling=0.0):
    from fairfedmed_tpu_torch.models.clip_model import dense
    hidden = torch.nn.functional.silu(dense(g, p["w1"]["weight"], p["w1"]["bias"])) \
        * dense(g, p["w2"]["weight"], p["w2"]["bias"])
    return dense(hidden, p["w3"]["weight"], p["w3"]["bias"])


@pytest.mark.parametrize("fault", ["rotate_halves", "no_ffn_ln"])
def test_a_wrong_tower_fails_the_tolerance(fault, tiny_rope, monkeypatch):
    if fault == "rotate_halves":
        monkeypatch.setattr(R, "_rotate", _rotate_halves)
    else:
        monkeypatch.setattr(eva_clip, "swiglu_block", _swiglu_without_ffn_ln)
    gen = torch.Generator().manual_seed(5)
    got, want = _tokens_both(_checkpoint(), _images(gen))
    assert _gap(got, want) > 10 * TOKEN_TOL


def _packed(gen, b=2, length=CFG.grid_size ** 2 + 1, dtype=torch.float32):
    return torch.randn(b, length, 3 * CFG.vision_width, generator=gen, dtype=dtype)


def test_rope_op_matches_the_reference_rotation(tiny_rope):
    gen = torch.Generator().manual_seed(6)
    qkv = _packed(gen)
    cos, sin = eva_clip.rope_tables(CFG)
    heads, dh = CFG.vision_heads, CFG.head_width
    q, k, v = R.rope_qkv(qkv, cos, sin, heads)
    ref_cos, ref_sin = ref_eva.rope_tables(CFG.grid_size, dh, "cpu")
    assert torch.equal(cos, ref_cos) or _gap(cos, ref_cos) <= ROPE_TOL
    b, length, _ = qkv.shape
    split = [t.reshape(b, length, heads, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    want = [ref_eva._rope(split[0], ref_cos, ref_sin) * dh ** -0.5,
            ref_eva._rope(split[1], ref_cos, ref_sin), split[2]]
    for got, w in zip((q, k, v), want):
        assert got.shape == (b * heads, length, dh)
        assert _gap(got, w.reshape(b * heads, length, dh)) <= ROPE_TOL


def test_rope_tables_interpolate_the_pretraining_grid(tiny_rope):
    cos, sin = eva_clip.rope_tables(CFG)
    assert cos.shape == sin.shape == (CFG.grid_size ** 2, CFG.head_width)
    # token (row 1, col 0): row position 1/4 * 2 on dims 0-31, column 0 on 32-63
    row1 = 1 * CFG.pt_hw_seq_len / CFG.grid_size
    freqs = 10000.0 ** (-torch.arange(0, 32, 2, dtype=torch.float64) / 32)
    want = torch.cat([torch.cos(row1 * freqs).repeat_interleave(2), torch.ones(32, dtype=torch.float64)])
    assert torch.allclose(cos[CFG.grid_size].double(), want, atol=1e-6)


def test_rope_op_gradient_is_its_backward():
    gen = torch.Generator().manual_seed(7)
    qkv = _packed(gen, b=2, length=5, dtype=torch.float64).requires_grad_(True)
    grid_cfg = eva_clip.EVAConfig(image_resolution=16, vision_patch_size=8, vision_width=128)
    cos, sin = (t.double() for t in eva_clip.rope_tables(grid_cfg))
    assert torch.autograd.gradcheck(lambda t: R.rope_qkv(t, cos, sin, 2), (qkv,))
    # the plain backward against autograd through the plain forward
    outs = R.reference_rope_qkv(qkv, cos, sin, 2)
    grads = [torch.randn(o.shape, generator=gen, dtype=torch.float64) for o in outs]
    (want,) = torch.autograd.grad(outs, qkv, grads)
    assert torch.allclose(R.reference_rope_qkv_bwd(*grads, cos, sin, 2), want, atol=1e-12)


def test_converter_reads_both_text_layouts_and_checks_rope_buffers(tiny_rope):
    sd = {k: v.numpy() for k, v in _checkpoint().items()}
    root_tree, root_cfg = converter.convert_eva02_clip(sd, CFG)
    text_keys = ("token_embedding.", "positional_embedding", "ln_final.", "text_projection",
                 "transformer.")
    released = {(f"text.{k}" if k.startswith(text_keys) else k): v for k, v in sd.items()}
    cos, sin = (t.numpy() for t in eva_clip.rope_tables(CFG))
    released["visual.rope.freqs_cos"], released["visual.rope.freqs_sin"] = cos, sin
    released["visual.blocks.0.attn.rope.freqs_cos"] = cos.astype(np.float16)
    tree, clip_cfg = converter.convert_eva02_clip(released, CFG)
    assert clip_cfg == root_cfg and clip_cfg.transformer_width == TEXT_CFG.transformer_width
    flat_a, flat_b = converter.params_from_numpy(root_tree, "cpu"), converter.params_from_numpy(
        tree, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(flat_a), _leaves(flat_b)))
    qkv = tree["visual"]["blocks"]["attn"]["qkv"]
    w = CFG.vision_width
    assert np.array_equal(qkv["bias"][:, w:2 * w], np.zeros((CFG.vision_layers, w)))
    assert np.array_equal(qkv["weight"][1, w:2 * w], sd["visual.blocks.1.attn.k_proj.weight"])
    # a table of another interpolation is refused
    other = eva_clip.rope_tables(eva_clip.EVAConfig(**{**CFG.__dict__, "pt_hw_seq_len": 3}))
    released["visual.rope.freqs_cos"] = other[0].numpy()
    with pytest.raises(ValueError, match="visual.rope.freqs_cos"):
        converter.convert_eva02_clip(released, CFG)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tiny_cell(tmp_path):
    """The benchmark's EVA02 cell at the tiny preset: its configuration, the
    tiny SLO traffic and the harness's tiny limits, as files under
    ``tmp_path``."""
    for sub in ("configs", "traffic", "workloads"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "tiny_eva.json").write_text(json.dumps(_tiny_config()))
    (tmp_path / "traffic" / "tiny_slo.json").write_text(json.dumps(_traffic()))
    with open(os.path.join(DATA, "workloads", "tiny_vit_slo.json")) as f:
        (tmp_path / "workloads" / "tiny_eva_slo.json").write_text(f.read())
    bench = {"configs": [{"name": "tiny_eva", "file": "benchmark/configs/tiny_eva.json"}],
             "workloads": [{"name": "tiny_eva_slo", "config": "tiny_eva", "traffic": "tiny_slo",
                            "chips": 1}], "end_to_end": [], "per_layer": []}
    return spec.load_cell("tiny_eva_slo", bench, root=tmp_path)


def test_fairlora_rounds_match_the_reference(tiny_rope, tmp_path, monkeypatch):
    """Client-parallel FedOTPLoRA rounds of the port on the tiny EVA02 cell
    against the reference: the first three steps' losses, the gradient of
    every adapter leaf of every layer (w1, w2, w3; A, S, B) as the optimizer
    got it, the state's change, the EMA aggregation and the evaluation
    logits, at the check round and at the round after the window.  (The
    harness refuses to run beside JAX, which this suite's conftest loads for
    the parity tests; the run here imports none of it itself.)"""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    cell = _tiny_cell(tmp_path)
    run = harness.run_cell(cell, SEED, 0.3, False, "cpu", str(tmp_path / "work"),
                           time.perf_counter())
    ok, rows = harness.verdict(run.readings, cell.workload["limits"])
    assert ok, rows
    assert run.readings["grad_gap"] <= 1e-6 and run.readings["grad_norm_gap"] <= 1e-4


def test_cli_round_on_the_tiny_preset(tmp_path):
    """One FedOTPLoRA round of the port's CLI with the EVA02 launcher's flags
    at the tiny preset, client-parallel; the saved state's keys are the
    release's ``blocks.{i}.mlp.{w1,w2,w3}`` with lora_S per group."""
    from fairfedmed_tpu_torch import federated_main as fm

    root, out_dir = str(tmp_path / "data"), tmp_path / "out"
    inputs.write_fixture(root, dict(_traffic(), train_per_site=8, test_per_site=4), SEED)
    argv = harness.build_argv(_tiny_cell(tmp_path), root, str(out_dir), 1)
    flags, opts = argv[:-6], argv[-6:]
    for flag, value in (("--round", "1"), ("--train_batch_size", "4"), ("--test_batch_size", "4")):
        flags = inputs.set_flag(flags, flag, value)
    saved = sys.stdout
    try:
        result = fm.main(fm.build_arg_parser().parse_args(flags + opts), device="cpu")
    finally:
        sys.stdout = saved
    assert len(result["acc"]) == 1 and np.isfinite(result["acc"]).all()
    log = (out_dir / "log.txt").read_text()
    assert "Client-parallel mesh rounds enabled" in log and "EVA02-CLIP" not in log
    with np.load(out_dir / "global_client0_final.npz") as z:
        keys = {k: z[k].shape for k in z.files}
    want = {f"image_encoder.blocks.{i}.mlp.{part}.{leaf}.weight"
            for i in range(CFG.vision_layers) for part in ("w1", "w2", "w3")
            for leaf in ("lora_A", "lora_S", "lora_B")}
    assert set(keys) == want | {"prompt_learner.ctx"}
    assert keys["image_encoder.blocks.1.mlp.w3.lora_S.weight"] == (3, 12)
    assert keys["image_encoder.blocks.0.mlp.w3.lora_A.weight"] == (CFG.mlp_hidden, 12)
    assert keys["image_encoder.blocks.0.mlp.w1.lora_B.weight"] == (12, CFG.mlp_hidden)
