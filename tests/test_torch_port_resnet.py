"""The port's ModifiedResNet (``fairfedmed_tpu_torch/models/resnet_clip.py``)
and its checkpoint path against the JAX package's, on the same seeded numpy
inputs and parameters, fp32 on both sides: atol 1e-5 relative to the largest
reference value (sums in another order; a single BatchNorm agrees to 1e-6
and is within 1e-6 of float64 on both sides, and train-mode BatchNorm over
14 layers carries that to ~2e-5 on tokens that reach 3), and exact for the
checkpoint conversion.

Covered: ``batch_norm`` in train and eval mode (output and new statistics),
``conv1x1_with_lora`` with FairLoRA and per-sample groups (and over a slice
batch), ``attention_pool`` with LoRA, ``resnet_encode`` at ``test-rn``
(tokens and statistics, with and without adapters), and ``infer_rn_config``
+ ``convert_resnet_visual`` + ``params_from_numpy`` on a small torch-keyed
ResNet state dict built here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.core.precision import policy_from_prec as jax_policy
from fairfedmed_tpu.models import converter as jconv
from fairfedmed_tpu.models import resnet_clip as jrn
from fairfedmed_tpu_torch.core.precision import policy_from_prec as port_policy
from fairfedmed_tpu_torch.models import converter as tconv
from fairfedmed_tpu_torch.models import resnet_clip as trn

torch.set_num_threads(1)

ATOL = 1e-5
CFG = jrn.RN_PRESETS["test-rn"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """numpy tree -> torch tree (lists stay lists)."""
    return tconv.params_from_numpy(tree, "cpu")


def _close(got, want, atol=ATOL, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, atol, f"{path}.{i}")
    else:
        g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
        np.testing.assert_allclose(g, want, atol=atol * scale, rtol=0, err_msg=path)


def _lora(rng, din, dout, rank, groups=None):
    """Adapter leaves with a non-zero A, so the delta is not zero."""
    out = {"lora_A": rng.standard_normal((din, rank)).astype(np.float32) * 0.1,
           "lora_B": rng.standard_normal((rank, dout)).astype(np.float32) * 0.1}
    if groups is not None:
        out["lora_S"] = rng.uniform(0.1, 1.0, (groups, rank)).astype(np.float32)
    return out


def _mix(rng, b, groups=3):
    attr = rng.integers(0, groups, b)
    onehot = np.eye(groups, dtype=np.float32)[attr]
    return (onehot * 0.7 + (1 - onehot) * 0.3 / (groups - 1)).astype(np.float32)


@pytest.fixture(scope="module")
def rn():
    params, bn, stats = _np(jrn.init_modified_resnet(jax.random.PRNGKey(0), CFG))
    rng = np.random.default_rng(1)
    # non-trivial BN affine and running statistics
    bn = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.2, a.shape)).astype(np.float32), bn)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0, 0.5, a.shape)).astype(np.float32), stats)
    return params, bn, stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches(train):
    rng = np.random.default_rng(2)
    x = rng.normal(1.5, 2.0, (4, 6, 5, 5)).astype(np.float32)
    bn = {"weight": rng.normal(1, 0.3, 6).astype(np.float32),
          "bias": rng.normal(0, 0.3, 6).astype(np.float32)}
    stat = {"mean": rng.normal(0, 1, 6).astype(np.float32),
            "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want_y, want_stat = jrn.batch_norm(bn, stat, jnp.asarray(x), train)
    got_y, got_stat = trn.batch_norm(_t(bn), _t(stat), torch.tensor(x), train)
    _close(got_y, want_y)
    _close(got_stat, _np(want_stat))
    assert all(not v.requires_grad for v in got_stat.values())


@pytest.mark.parametrize("slices", [1, 2], ids=["per_sample", "slice_batch"])
def test_conv1x1_with_fairlora_matches(slices):
    rng = np.random.default_rng(3)
    b = 4
    x = rng.standard_normal((b * slices, 8, 3, 3)).astype(np.float32)
    w = rng.standard_normal((16, 8, 1, 1)).astype(np.float32)
    lora = _lora(rng, 8, 16, 4, groups=3)
    mix = _mix(rng, b)  # per volume: the adapter repeats it over slices
    want = jrn.conv1x1_with_lora(jnp.asarray(x), jnp.asarray(w), lora, jnp.asarray(mix), 0.5,
                                 jax_policy("fp32"))
    got = trn.conv1x1_with_lora(torch.tensor(x), torch.tensor(w), _t(lora), torch.tensor(mix),
                                0.5, port_policy("fp32"))
    _close(got, want)


@pytest.mark.parametrize("return_tokens", [True, False], ids=["tokens", "pooled"])
def test_attention_pool_with_lora_matches(rn, return_tokens):
    params = rn[0]
    rng = np.random.default_rng(4)
    ed = CFG.embed_dim
    x = rng.standard_normal((3, ed, 2, 2)).astype(np.float32)
    p = dict(params["attnpool"])
    p["positional_embedding"] = rng.standard_normal((5, ed)).astype(np.float32) * 0.1
    lora = {n: _lora(rng, ed, CFG.output_dim if n == "c_proj" else ed, 4)
            for n in ("q_proj", "k_proj", "v_proj", "c_proj")}
    want = jrn.attention_pool(p, jnp.asarray(x), CFG.heads, jax_policy("fp32"), lora=lora,
                              lora_scaling=2.0, return_tokens=return_tokens)
    got = trn.attention_pool(_t(p), torch.tensor(x), CFG.heads, port_policy("fp32"),
                             lora=_t(lora), lora_scaling=2.0, return_tokens=return_tokens)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def _rn_lora(rng, groups=3, rank=4):
    lora, inplanes = {}, CFG.width
    for li, nblocks in enumerate(CFG.layers):
        planes = CFG.width * 2 ** li
        blocks = []
        for _ in range(nblocks):
            blocks.append({"conv1": _lora(rng, inplanes, planes, rank, groups),
                           "conv3": _lora(rng, planes, planes * 4, rank, groups)})
            inplanes = planes * 4
        lora[f"layer{li + 1}"] = blocks
    ed = CFG.embed_dim
    attnpool = {n: _lora(rng, ed, CFG.output_dim if n == "c_proj" else ed, rank)
                for n in ("q_proj", "k_proj", "v_proj", "c_proj")}
    return lora, attnpool


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("adapters", [False, True], ids=["plain", "fairlora"])
def test_resnet_encode_matches(rn, train, adapters):
    params, bn, stats = rn
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if adapters:
        lora, attnpool = _rn_lora(rng)
        mix = _mix(rng, 4)
        kw_j = dict(lora=lora, attnpool_lora=attnpool, attr_mix=jnp.asarray(mix),
                    lora_scaling=0.25)
        kw_t = dict(lora=_t(lora), attnpool_lora=_t(attnpool), attr_mix=torch.tensor(mix),
                    lora_scaling=0.25)
    want, want_stats = jrn.resnet_encode(params, bn, stats, jnp.asarray(x), CFG,
                                         jax_policy("fp32"), train=train, return_tokens=True,
                                         **kw_j)
    got, got_stats = trn.resnet_encode(_t(params), _t(bn), _t(stats), torch.tensor(x), CFG,
                                       port_policy("fp32"), train=train, return_tokens=True,
                                       **kw_t)
    assert tuple(got.shape) == tuple(want.shape) == (4, 2, CFG.output_dim)
    _close(got, want)
    _close(got_stats, _np(want_stats))


def _rn_state_dict(seed=0, width=16, layers=(1, 2, 1, 1), grid=2, embed=32, tw=64,
                   tlayers=2, ctx=7, vocab=50):
    """A torch-keyed ModifiedResNet CLIP state dict (fp16, as the OpenAI
    release stores it) with BatchNorm buffers."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(k, *shape):
        sd[k] = torch.tensor(rng.standard_normal(shape).astype(np.float32)).half()

    def bn(prefix, dim):
        put(f"{prefix}.weight", dim)
        put(f"{prefix}.bias", dim)
        sd[f"{prefix}.running_mean"] = torch.tensor(rng.normal(0, 1, dim).astype(np.float32))
        sd[f"{prefix}.running_var"] = torch.tensor(rng.uniform(0.5, 2, dim).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(3)

    put("visual.conv1.weight", width // 2, 3, 3, 3)
    put("visual.conv2.weight", width // 2, width // 2, 3, 3)
    put("visual.conv3.weight", width, width // 2, 3, 3)
    for i, dim in ((1, width // 2), (2, width // 2), (3, width)):
        bn(f"visual.bn{i}", dim)
    inplanes = width
    for li, nblocks in enumerate(layers):
        planes = width * 2 ** li
        for bi in range(nblocks):
            pre = f"visual.layer{li + 1}.{bi}"
            put(f"{pre}.conv1.weight", planes, inplanes, 1, 1)
            put(f"{pre}.conv2.weight", planes, planes, 3, 3)
            put(f"{pre}.conv3.weight", planes * 4, planes, 1, 1)
            for n, dim in (("bn1", planes), ("bn2", planes), ("bn3", planes * 4)):
                bn(f"{pre}.{n}", dim)
            if bi == 0:
                put(f"{pre}.downsample.0.weight", planes * 4, inplanes, 1, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            inplanes = planes * 4
    ed = width * 32
    put("visual.attnpool.positional_embedding", grid * grid + 1, ed)
    for n, dout in (("q_proj", ed), ("k_proj", ed), ("v_proj", ed), ("c_proj", embed)):
        put(f"visual.attnpool.{n}.weight", dout, ed)
        put(f"visual.attnpool.{n}.bias", dout)
    for i in range(tlayers):
        b = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            put(f"{b}.{ln}.weight", tw)
            put(f"{b}.{ln}.bias", tw)
        put(f"{b}.attn.in_proj_weight", 3 * tw, tw)
        put(f"{b}.attn.in_proj_bias", 3 * tw)
        put(f"{b}.attn.out_proj.weight", tw, tw)
        put(f"{b}.attn.out_proj.bias", tw)
        put(f"{b}.mlp.c_fc.weight", 4 * tw, tw)
        put(f"{b}.mlp.c_fc.bias", 4 * tw)
        put(f"{b}.mlp.c_proj.weight", tw, 4 * tw)
        put(f"{b}.mlp.c_proj.bias", tw)
    put("token_embedding.weight", vocab, tw)
    put("positional_embedding", ctx, tw)
    put("ln_final.weight", tw)
    put("ln_final.bias", tw)
    put("text_projection", tw, embed)
    sd["logit_scale"] = torch.tensor(4.6052)
    return sd


def test_rn_checkpoint_conversion_matches(tmp_path):
    from fairfedmed_tpu_torch.config import get_cfg_default
    from fairfedmed_tpu_torch.train import clip_common as tcc

    sd = _rn_state_dict()
    sd_np = {k: v.numpy() for k, v in sd.items()}
    (want_rn, want_clip), (got_rn, got_clip) = jconv.infer_rn_config(sd_np), \
        tconv.infer_rn_config(sd_np)
    assert got_rn.__dict__ == want_rn.__dict__ and got_clip.__dict__ == want_clip.__dict__
    assert got_rn.layers == (1, 2, 1, 1) and got_rn.heads == 8
    with pytest.raises(NotImplementedError, match="infer_rn_config"):
        tconv.infer_config(sd_np)

    want = _np(jrn.convert_resnet_visual(sd_np, want_rn))
    got = trn.convert_resnet_visual(sd_np, got_rn)
    for g, w in zip(got, want):
        _close(g, w, atol=0)

    # params_from_numpy walks the block lists and keeps BN fp32 under bf16
    tree = {"visual": got[0], "visual_bn": got[1], "logit_scale": np.float32(4.6)}
    t = tconv.params_from_numpy(tree, "cpu", torch.bfloat16)
    assert isinstance(t["visual"]["layer2"], list) and len(t["visual"]["layer2"]) == 2
    assert t["visual"]["layer2"][1]["conv1"].dtype == torch.bfloat16
    assert t["visual_bn"]["layer2"][0]["downsample_bn"]["weight"].dtype == torch.float32
    assert t["visual_bn"]["stem"]["bn1"]["bias"].dtype == torch.float32
    assert t["logit_scale"].dtype == torch.float32
    stats = tconv.params_from_numpy(got[2], "cpu", torch.bfloat16)
    assert stats["layer1"][0]["bn3"]["var"].dtype == torch.float32

    # the bundle from a checkpoint file: bf16 params, fp32 BN, the same values
    torch.save(sd, tmp_path / "RN50.pt")
    cfg = get_cfg_default()
    cfg.MODEL.BACKBONE.NAME = "RN50"
    cfg.DATASET.ROOT = str(tmp_path)
    bundle = tcc.load_clip_bundle(cfg, "fp16", device="cpu")
    assert bundle.pretrained and bundle.backbone_type == "resnet"
    assert bundle.rn_cfg == got_rn and bundle.clip_cfg == got_clip
    assert bundle.params["visual"]["stem"]["conv1"].dtype == torch.bfloat16
    assert bundle.params["logit_scale"].dtype == torch.float32
    _close(bundle.visual_bn, want[1], atol=0)
    _close(bundle.visual_stats, want[2], atol=0)
    _close(bundle.params["text"]["text_projection"].float(),
           torch.tensor(sd_np["text_projection"].astype(np.float32)).bfloat16().float().numpy(),
           atol=0)
