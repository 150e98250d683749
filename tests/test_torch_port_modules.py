"""Port model modules against the JAX package: CLIP towers with FairLoRA and
their gradients, LoRA math, prompt assembly and the tokenizer.

Weights come from the JAX package's init (carried across with
``params_from_numpy``); every other input is numpy with a fixed seed.  Both
stacks run fp32 (the JAX tests run matmuls at "highest" precision).
Tolerances: activations atol 2e-5 (relative 1e-5), gradients atol 1e-4
(relative 1e-4) -- fp32 sums in a different order, through two transformer
layers and the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.adapters import lora as jlora
from fairfedmed_tpu.core.precision import policy_from_prec as jax_policy
from fairfedmed_tpu.models import clip_model as jcm
from fairfedmed_tpu.models import prompt_learner as jpl
from fairfedmed_tpu.models import tokenizer as jtok
from fairfedmed_tpu.train.clip_common import TEST_PRESETS as JAX_TEST_PRESETS
from fairfedmed_tpu_torch.adapters import lora as tlora
from fairfedmed_tpu_torch.core.precision import policy_from_prec
from fairfedmed_tpu_torch.models import clip_model as tcm
from fairfedmed_tpu_torch.models import prompt_learner as tpl
from fairfedmed_tpu_torch.models import tokenizer as ttok
from fairfedmed_tpu_torch.models.converter import params_from_numpy
from fairfedmed_tpu_torch.train.clip_common import TEST_PRESETS

torch.set_num_threads(1)

CLASSNAMES = ["NOT Glaucoma", "Glaucoma"]
ACT = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch_leaves(tree):
    if isinstance(tree, dict):
        return {k: _torch_leaves(v) for k, v in tree.items()}
    return torch.tensor(tree, requires_grad=True)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy()


def _assert_trees_close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), err_msg=str(path), **tol)


def _port_cfg(cfg):
    return tcm.CLIPConfig(**vars(cfg))


@pytest.fixture(scope="module", params=["test-vit", "test-vit-224"])
def towers(request):
    cfg = JAX_TEST_PRESETS[request.param]
    assert TEST_PRESETS[request.param] == _port_cfg(cfg)
    jparams = jcm.init_clip_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_numpy(_np_tree(jparams), "cpu")


def _stacked_lora(rng, layers, din, dout, rank, groups):
    return {"lora_A": 0.1 * rng.standard_normal((layers, din, rank)).astype(np.float32),
            "lora_B": rng.standard_normal((layers, rank, dout)).astype(np.float32),
            "lora_S": rng.uniform(0.1, 1.0, (layers, groups, rank)).astype(np.float32)}


def test_vit_encode_fairlora_tokens_and_lora_grads(towers):
    cfg, jparams, tparams = towers
    rng = np.random.default_rng(0)
    vw, layers = cfg.vision_width, cfg.vision_layers
    lora = {"c_fc": _stacked_lora(rng, layers, vw, 4 * vw, 4, 3),
            "c_proj": _stacked_lora(rng, layers, 4 * vw, vw, 4, 3)}
    image = rng.standard_normal((3, 3, cfg.image_resolution, cfg.image_resolution)).astype(np.float32)
    attr = np.array([0, 2, 1])
    n_tok = cfg.grid_size ** 2 + 1
    cot = rng.standard_normal((3, n_tok, cfg.embed_dim)).astype(np.float32)

    def f_jax(lp):
        mix = jlora.group_mix(jnp.asarray(attr), 3, 3, jnp.float32)
        return jcm.vit_encode(jparams["visual"], jnp.asarray(image), cfg, jax_policy("fp32"),
                              return_tokens=True, lora=lp, attr_mix=mix, lora_scaling=0.5)

    out_j, vjp = jax.vjp(f_jax, jax.tree_util.tree_map(jnp.asarray, lora))
    (grads_j,) = vjp(jnp.asarray(cot))

    tl = _torch_leaves(lora)
    mix = tlora.group_mix(torch.tensor(attr), 3, 3)
    out_t = tcm.vit_encode(tparams["visual"], torch.tensor(image), _port_cfg(cfg),
                           policy_from_prec("fp32"), return_tokens=True, lora=tl, attr_mix=mix,
                           lora_scaling=0.5)
    out_t.backward(torch.tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **ACT)
    _assert_trees_close(_grads(tl), grads_j, **GRAD)

    pooled_j = jcm.vit_encode(jparams["visual"], jnp.asarray(image), cfg, jax_policy("fp32"))
    pooled_t = tcm.vit_encode(tparams["visual"], torch.tensor(image), _port_cfg(cfg),
                              policy_from_prec("fp32"))
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j), **ACT)


def _prompt_states(cfg, jparams, tparams):
    emb = np.asarray(jparams["text"]["token_embedding"], np.float32)
    _, jstate = jpl.init_prompt_learner(jax.random.PRNGKey(1), CLASSNAMES, jnp.asarray(emb), cfg,
                                        n_ctx=4, n_prompts=2)
    _, tstate = tpl.init_prompt_learner(torch.Generator().manual_seed(1), CLASSNAMES,
                                        tparams["text"]["token_embedding"],
                                        _port_cfg(cfg), n_ctx=4, n_prompts=2)
    return jstate, tstate


def test_prompt_state_and_assembly_match(towers):
    cfg, jparams, tparams = towers
    jstate, tstate = _prompt_states(cfg, jparams, tparams)
    np.testing.assert_array_equal(tstate.tokenized_prompts, jstate.tokenized_prompts)
    np.testing.assert_array_equal(tstate.eot_indices, jstate.eot_indices)
    np.testing.assert_array_equal(tstate.token_prefix.numpy(), jstate.token_prefix)
    np.testing.assert_array_equal(tstate.token_suffix.numpy(), jstate.token_suffix)
    assert tstate.name_lens == jstate.name_lens
    ctx = np.random.default_rng(2).standard_normal((2, 4, cfg.transformer_width)).astype(np.float32)
    for position in ("end", "middle", "front"):
        jstate.class_token_position = tstate.class_token_position = position
        np.testing.assert_array_equal(
            tpl.assemble_prompts(torch.tensor(ctx), tstate).numpy(),
            np.asarray(jpl.assemble_prompts(jnp.asarray(ctx), jstate)))


def test_text_encode_features_and_ctx_grads(towers):
    cfg, jparams, tparams = towers
    jstate, tstate = _prompt_states(cfg, jparams, tparams)
    rng = np.random.default_rng(3)
    ctx = (0.02 * rng.standard_normal((2, 4, cfg.transformer_width))).astype(np.float32)
    cot = rng.standard_normal((4, cfg.embed_dim)).astype(np.float32)

    def f_jax(c):
        return jcm.text_encode(jparams, jpl.assemble_prompts(c, jstate), jstate.eot_indices, cfg,
                               jax_policy("fp32"))

    out_j, vjp = jax.vjp(f_jax, jnp.asarray(ctx))
    (g_j,) = vjp(jnp.asarray(cot))

    tctx = torch.tensor(ctx, requires_grad=True)
    out_t = tcm.text_encode(tparams, tpl.assemble_prompts(tctx, tstate), tstate.eot_indices,
                            _port_cfg(cfg), policy_from_prec("fp32"))
    out_t.backward(torch.tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **ACT)
    np.testing.assert_allclose(tctx.grad.numpy(), np.asarray(g_j), **GRAD)


@pytest.mark.parametrize("init_type,rank,groups", [("same+cycle", 12, 3), ("same+cycle", 4, 3),
                                                   ("same", 6, 2), ("cycle_shift", 6, 3)])
def test_s_init_matches(init_type, rank, groups):
    np.testing.assert_allclose(tlora._s_init(rank, groups, init_type).numpy(),
                               np.asarray(jlora._s_init(rank, groups, init_type, jnp.float32)),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("global_s", [False, True])
@pytest.mark.parametrize("attr", [None, np.array([0, 2, 1, 2])])
def test_group_mix_effective_s_and_lora_delta(attr, global_s):
    rng = np.random.default_rng(4)
    lora = {"lora_A": rng.standard_normal((16, 6)).astype(np.float32),
            "lora_B": rng.standard_normal((6, 8)).astype(np.float32),
            "lora_S": rng.uniform(0.1, 1, (3, 6)).astype(np.float32)}
    if global_s:
        lora["lora_S_global"] = rng.uniform(0.1, 1, (1, 6)).astype(np.float32)
    x = rng.standard_normal((4, 5, 16)).astype(np.float32)

    jmix = jlora.group_mix(None if attr is None else jnp.asarray(attr), 3, 4, jnp.float32)
    tmix = tlora.group_mix(None if attr is None else torch.tensor(attr), 3, 4)
    np.testing.assert_allclose(tmix.numpy(), np.asarray(jmix), atol=1e-7, rtol=0)

    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = {k: torch.tensor(v) for k, v in lora.items()}
    np.testing.assert_allclose(tlora.effective_s(tl, tmix, 8).numpy(),
                               np.asarray(jlora.effective_s(jl, jmix, 8)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tlora.lora_delta(tl, torch.tensor(x), tmix, 0.25).numpy(),
                               np.asarray(jlora.lora_delta(jl, jnp.asarray(x), jmix, 0.25)),
                               **ACT)


def test_init_lora_shapes_and_init_distribution():
    """The draws differ from JAX's; shapes, the zero A and the S init match."""
    t = tlora.init_lora(torch.Generator().manual_seed(0), 64, 256, 12, num_groups=3,
                        global_s=True)
    j = jlora.init_lora(jax.random.PRNGKey(0), 64, 256, 12, num_groups=3, global_s=True)
    assert {k: tuple(v.shape) for k, v in t.items()} == {k: v.shape for k, v in j.items()}
    assert float(t["lora_A"].abs().max()) == 0.0
    np.testing.assert_allclose(t["lora_S"].numpy(), np.asarray(j["lora_S"]), atol=1e-7)
    assert abs(float(t["lora_B"].std()) - 1.0) < 0.05


@pytest.mark.parametrize("text", [
    "X X X X NOT Glaucoma.", "Glaucoma", "a photo of a dog_breed's ear, 42 times!!",
    "café résumé naïve — “quoted” ½ ²", "ＴＥＳＴ ﬁne  tab\there", "I'll we've they're it's you'd",
    "<|startoftext|>hello<|endoftext|>", "emoji 😀 and 漢字 mixed123abc",
])
def test_tokenizer_ids_match(text):
    np.testing.assert_array_equal(ttok.tokenize(text), jtok.tokenize(text))


def test_causal_mask_matches():
    np.testing.assert_array_equal(tcm.causal_mask(9).numpy(), np.asarray(jcm.causal_mask(9)))
