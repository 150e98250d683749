"""CLIP ModifiedResNet image encoder (RN50 family) as plain functions.

Port of ``fairfedmed_tpu/models/resnet_clip.py`` (reference clip/model.py:
11-301: Bottleneck with anti-aliased strides, 3-conv stem, QKV attention
pooling; the GLP_OT variant returns every attended token and threads the
demographic group mix into the 1x1 convs).

* convolutions are ``F.conv2d`` in the policy's compute type;
* BatchNorm is functional: affine parameters and running statistics are
  separate trees, and each function returns the new statistics instead of
  writing them, as the JAX functions do; the caller decides where they go;
* FairLoRA on a 1x1 conv is a channel-axis product with a per-sample
  singular-value vector (the reference permutes through a token-major layout,
  GLP_OT_SVLoRA.py:469-480; the math is the same);
* the attention pool is a plain batched attention with plain LoRA on its
  q/k/v/c projections.  It is not a TPU kernel in the JAX package, and at
  its sizes (50 tokens) it is a handful of small matmuls.

Parameter trees keep the JAX package's layout (``layer1..4`` are lists of
block dicts), so its parameters cross over leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..adapters.lora import effective_s, lora_delta
from ..core.precision import Policy

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    output_dim: int = 1024
    heads: int = 32
    input_resolution: int = 224
    width: int = 64

    @property
    def embed_dim(self) -> int:
        return self.width * 32


RN_PRESETS = {
    # random-init fallback only: a checkpoint gives its own architecture
    # (converter.infer_rn_config, clip/model.py:643-656)
    "RN50": ResNetConfig(),
    "RN101": ResNetConfig(layers=(3, 4, 23, 3), output_dim=512),
    "RN50x4": ResNetConfig(layers=(4, 6, 10, 6), output_dim=640, heads=40,
                           input_resolution=288, width=80),
    "RN50x16": ResNetConfig(layers=(6, 8, 18, 8), output_dim=768, heads=48,
                            input_resolution=384, width=96),
    "test-rn": ResNetConfig(layers=(1, 1, 1, 1), output_dim=64, heads=8,
                            input_resolution=32, width=16),
}


# --------------------------------------------------------------------------- #
# functional primitives
# --------------------------------------------------------------------------- #

def conv2d(x, w, stride=1, padding=0, policy: Optional[Policy] = None):
    """NCHW x OIHW convolution in the policy's compute type (x's type
    without a policy)."""
    dt = policy.compute_dtype if policy else x.dtype
    return F.conv2d(x.to(dt), w.to(dt), stride=stride, padding=padding)


def avg_pool(x, k: int):
    return x if k <= 1 else F.avg_pool2d(x, k)


def batch_norm(bn: dict, stat: dict, x, train: bool):
    """Functional BatchNorm2d with torch's semantics.  Returns (y, new_stat).

    Train mode normalises with the batch's biased variance and moves the
    running statistics by momentum 0.1 towards the batch mean and unbiased
    variance (carrying no gradient); eval mode uses the running statistics
    and returns ``stat`` itself.  Mean, variance, weight and bias fold into
    one per-channel fp32 scale and shift, applied in fp32 and rounded once to
    x's type: in bf16 the two large, nearly cancelling terms x*scale and
    shift would each be rounded, an error amplified by |mean|/std.
    """
    x32 = x.float()
    if train:
        mean = x32.mean(dim=(0, 2, 3))
        var = (x32 - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        n = x32.shape[0] * x32.shape[2] * x32.shape[3]
        unbiased = var.detach() * n / max(n - 1, 1)
        new_stat = {
            "mean": (1 - BN_MOMENTUM) * stat["mean"] + BN_MOMENTUM * mean.detach(),
            "var": (1 - BN_MOMENTUM) * stat["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = stat["mean"], stat["var"]
        new_stat = stat
    inv = torch.rsqrt(var + BN_EPS) * bn["weight"].float()
    shift = bn["bias"].float() - mean * inv
    y = x32 * inv[None, :, None, None] + shift[None, :, None, None]
    return y.to(x.dtype), new_stat


def conv1x1_with_lora(x, w, lora: Optional[dict], attr_mix, scaling: float,
                      policy: Optional[Policy]):
    """1x1 conv plus the FairLoRA channel-space delta (FairLoRALinear's 1x1
    conv path, GLP_OT_SVLoRA.py:469-480), the delta in the compute type."""
    y = conv2d(x, w, policy=policy)
    if lora is not None:
        dt = policy.compute_dtype if policy else x.dtype
        xc = x.to(dt)
        h = torch.einsum("bchw,cr->brhw", xc, lora["lora_A"].to(dt))
        s = effective_s(lora, attr_mix, x.shape[0])
        if s is not None:
            h = h * s.to(dt)[:, :, None, None]
        dy = torch.einsum("brhw,ro->bohw", h, lora["lora_B"].to(dt)).to(y.dtype)
        y = y + dy * scaling
    return y


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #

def bottleneck(p, bn, stat, x, stride, train, policy, lora=None, attr_mix=None,
               lora_scaling=0.0):
    """CLIP Bottleneck (clip/model.py:11-60).  Returns (y, new_stats)."""
    new_stats = {}
    out = conv1x1_with_lora(x, p["conv1"], None if lora is None else lora.get("conv1"),
                            attr_mix, lora_scaling, policy)
    out, new_stats["bn1"] = batch_norm(bn["bn1"], stat["bn1"], out, train)
    out = F.relu(out)
    out = conv2d(out, p["conv2"], padding=1, policy=policy)
    out, new_stats["bn2"] = batch_norm(bn["bn2"], stat["bn2"], out, train)
    out = F.relu(out)
    out = avg_pool(out, stride)
    out = conv1x1_with_lora(out, p["conv3"], None if lora is None else lora.get("conv3"),
                            attr_mix, lora_scaling, policy)
    out, new_stats["bn3"] = batch_norm(bn["bn3"], stat["bn3"], out, train)

    if "downsample" in p:
        identity = conv2d(avg_pool(x, stride), p["downsample"], policy=policy)
        identity, new_stats["downsample_bn"] = batch_norm(
            bn["downsample_bn"], stat["downsample_bn"], identity, train)
    else:
        identity = x
    return F.relu(out + identity), new_stats


def attention_pool(p, x, num_heads: int, policy, lora=None, lora_scaling=0.0,
                   return_tokens=False):
    """QKV attention pooling (AttentionPool2d, clip/model.py:63-118).

    x: [B, C, H, W].  Returns pooled [B, out] or every token [B, HW+1, out].
    ``lora`` (plain LoRA on the q/k/v/c projections, the reference's
    LoRALinear wrappers, GLP_OT_SVLoRA.py:558-561) adds its delta to each
    projection.  Products accumulate in fp32 and round to x's type, as the
    JAX einsums with ``preferred_element_type=float32`` do.
    """
    b, c, h, w = x.shape
    t = x.reshape(b, c, h * w).transpose(1, 2)  # [B, HW, C]
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)  # [B, HW+1, C]
    t = t + p["positional_embedding"].to(t.dtype)[None]

    def proj(name, inp):
        out = F.linear(inp, p[name]["weight"].to(inp.dtype)) + p[name]["bias"].to(inp.dtype)
        if lora is not None and name in lora:
            out = out + lora_delta(lora[name], inp, None, lora_scaling)
        return out

    length, dh = t.shape[1], c // num_heads

    def heads(z):
        return z.reshape(b, length, num_heads, dh).transpose(1, 2)

    q, k, v = heads(proj("q_proj", t)), heads(proj("k_proj", t)), heads(proj("v_proj", t))
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    attn = torch.softmax(scores, dim=-1).to(t.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.float(), v.float()).to(t.dtype)
    out = proj("c_proj", out.transpose(1, 2).reshape(b, length, c))
    return out if return_tokens else out[:, 0]


def resnet_encode(params, bn_params, stats, x, cfg: ResNetConfig, policy: Policy,
                  train: bool = False, return_tokens: bool = False, lora=None,
                  attnpool_lora=None, attr_mix=None, lora_scaling: float = 0.0):
    """ModifiedResNet forward.  Returns (features, new_stats): features
    [B, output_dim] pooled, or [B, HW+1, output_dim] tokens (the GLP_OT
    variant, clip/model.py:290-301)."""
    stem, bn_stem, st_stem = params["stem"], bn_params["stem"], stats["stem"]
    new_stats = {"stem": {}}
    h = x.to(policy.compute_dtype)
    for i, (conv, stride) in enumerate((("conv1", 2), ("conv2", 1), ("conv3", 1)), 1):
        h = conv2d(h, stem[conv], stride=stride, padding=1, policy=policy)
        h, new_stats["stem"][f"bn{i}"] = batch_norm(bn_stem[f"bn{i}"], st_stem[f"bn{i}"], h,
                                                    train)
        h = F.relu(h)
    h = avg_pool(h, 2)

    for li in range(4):
        lname = f"layer{li + 1}"
        new_stats[lname] = []
        for bi, block in enumerate(params[lname]):
            h, st = bottleneck(block, bn_params[lname][bi], stats[lname][bi], h,
                               2 if (li > 0 and bi == 0) else 1, train, policy,
                               lora=None if lora is None else lora[lname][bi],
                               attr_mix=attr_mix, lora_scaling=lora_scaling)
            new_stats[lname].append(st)

    feats = attention_pool(params["attnpool"], h, cfg.heads, policy, lora=attnpool_lora,
                           lora_scaling=lora_scaling, return_tokens=return_tokens)
    return feats, new_stats


# --------------------------------------------------------------------------- #
# initialisation and checkpoints
# --------------------------------------------------------------------------- #

def _bn_init(dim):
    return ({"weight": torch.ones(dim), "bias": torch.zeros(dim)},
            {"mean": torch.zeros(dim), "var": torch.ones(dim)})


def _conv_init(gen, cout, cin, k):
    return torch.randn((cout, cin, k, k), generator=gen) * (2.0 / (cin * k * k)) ** 0.5


def init_modified_resnet(gen: torch.Generator, cfg: ResNetConfig):
    """Random init drawn from the CPU generator ``gen`` (the same weights
    whatever the device they move to; not the JAX package's draws).  Returns
    (params, bn_params, stats), fp32 on the CPU."""
    w = cfg.width
    params = {"stem": {"conv1": _conv_init(gen, w // 2, 3, 3),
                       "conv2": _conv_init(gen, w // 2, w // 2, 3),
                       "conv3": _conv_init(gen, w, w // 2, 3)}}
    bn, stats = {"stem": {}}, {"stem": {}}
    for name, dim in (("bn1", w // 2), ("bn2", w // 2), ("bn3", w)):
        bn["stem"][name], stats["stem"][name] = _bn_init(dim)

    inplanes = w
    for li, nblocks in enumerate(cfg.layers):
        planes = w * (2 ** li)
        lname = f"layer{li + 1}"
        params[lname], bn[lname], stats[lname] = [], [], []
        for bi in range(nblocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            block = {"conv1": _conv_init(gen, planes, inplanes, 1),
                     "conv2": _conv_init(gen, planes, planes, 3),
                     "conv3": _conv_init(gen, planes * EXPANSION, planes, 1)}
            bblock, sblock = {}, {}
            for name, dim in (("bn1", planes), ("bn2", planes), ("bn3", planes * EXPANSION)):
                bblock[name], sblock[name] = _bn_init(dim)
            if stride > 1 or inplanes != planes * EXPANSION:
                block["downsample"] = _conv_init(gen, planes * EXPANSION, inplanes, 1)
                bblock["downsample_bn"], sblock["downsample_bn"] = _bn_init(planes * EXPANSION)
            params[lname].append(block)
            bn[lname].append(bblock)
            stats[lname].append(sblock)
            inplanes = planes * EXPANSION

    ed = cfg.embed_dim
    spacial = cfg.input_resolution // 32
    std = ed ** -0.5

    def linear(out_dim):
        return {"weight": torch.randn((out_dim, ed), generator=gen) * std,
                "bias": torch.zeros(out_dim)}

    params["attnpool"] = {
        "positional_embedding": torch.randn((spacial ** 2 + 1, ed), generator=gen) * std,
        "q_proj": linear(ed), "k_proj": linear(ed), "v_proj": linear(ed),
        "c_proj": linear(cfg.output_dim),
    }
    return params, bn, stats


def convert_resnet_visual(sd: dict, cfg: ResNetConfig, dtype=np.float32):
    """Checkpoint state dict (``visual.*`` keys, numpy values) -> numpy
    (params, bn_params, stats) trees in the layout above."""
    def a(k):
        return np.asarray(sd[f"visual.{k}"], dtype)

    def bn_of(prefix):
        return ({"weight": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")},
                {"mean": a(f"{prefix}.running_mean"), "var": a(f"{prefix}.running_var")})

    params = {"stem": {c: a(f"{c}.weight") for c in ("conv1", "conv2", "conv3")}}
    bn, stats = {"stem": {}}, {"stem": {}}
    for name in ("bn1", "bn2", "bn3"):
        bn["stem"][name], stats["stem"][name] = bn_of(name)

    for li, nblocks in enumerate(cfg.layers):
        lname = f"layer{li + 1}"
        params[lname], bn[lname], stats[lname] = [], [], []
        for bi in range(nblocks):
            pre = f"{lname}.{bi}"
            block = {c: a(f"{pre}.{c}.weight") for c in ("conv1", "conv2", "conv3")}
            bblock, sblock = {}, {}
            for name in ("bn1", "bn2", "bn3"):
                bblock[name], sblock[name] = bn_of(f"{pre}.{name}")
            if f"visual.{pre}.downsample.0.weight" in sd:
                block["downsample"] = a(f"{pre}.downsample.0.weight")
                bblock["downsample_bn"], sblock["downsample_bn"] = bn_of(f"{pre}.downsample.1")
            params[lname].append(block)
            bn[lname].append(bblock)
            stats[lname].append(sblock)

    params["attnpool"] = {"positional_embedding": a("attnpool.positional_embedding")}
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        params["attnpool"][name] = {"weight": a(f"attnpool.{name}.weight"),
                                    "bias": a(f"attnpool.{name}.bias")}
    return params, bn, stats
