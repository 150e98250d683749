"""OpenAI CLIP's ModifiedResNet (``clip/model.py``): a 3-convolution stem,
anti-aliased bottlenecks (FairLoRA on each one's 1x1 convolutions, every
BatchNorm trainable and federated) and an attention pool (plain LoRA on its
four projections) whose every token is a query, as the method's variant
returns all tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..inputs import ln_leaves

BN_MOMENTUM, BN_EPS = 0.1, 1e-5


def image_leaves(arch: dict, init: dict) -> list:
    """``(key, shape, init)`` of the tower's checkpoint leaves; ``init``'s
    ``bn3_weight`` is each bottleneck's last BatchNorm weight (CLIP starts
    it at 0, so that each residual block starts as the identity)."""
    leaves = []

    def bn(name, dim, weight=None):
        if weight is not None:
            leaves.extend([(f"{name}.weight", (dim,), ("const", weight)),
                           (f"{name}.bias", (dim,), ("zeros",))])
        else:
            leaves.extend(ln_leaves(name, dim))
        leaves.extend([(f"{name}.running_mean", (dim,), ("zeros",)),
                       (f"{name}.running_var", (dim,), ("ones",))])

    def conv(name, cout, cin, k):
        leaves.append((name, (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cin * k * k)))))

    embed, res, w = arch["embed_dim"], arch["image_resolution"], arch["vision_width"]
    conv("visual.conv1.weight", w // 2, 3, 3)
    conv("visual.conv2.weight", w // 2, w // 2, 3)
    conv("visual.conv3.weight", w, w // 2, 3)
    for i, dim in ((1, w // 2), (2, w // 2), (3, w)):
        bn(f"visual.bn{i}", dim)
    inplanes = w
    for li, nblocks in enumerate(arch["vision_layers"]):
        planes = w * 2 ** li
        for bi in range(nblocks):
            pre = f"visual.layer{li + 1}.{bi}"
            conv(f"{pre}.conv1.weight", planes, inplanes, 1)
            conv(f"{pre}.conv2.weight", planes, planes, 3)
            conv(f"{pre}.conv3.weight", planes * 4, planes, 1)
            for name, dim in (("bn1", planes), ("bn2", planes), ("bn3", planes * 4)):
                bn(f"{pre}.{name}", dim, init.get("bn3_weight", 0.0) if name == "bn3" else None)
            if bi == 0 and (li > 0 or inplanes != planes * 4):
                conv(f"{pre}.downsample.0.weight", planes * 4, inplanes, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            inplanes = planes * 4
    c = w * 32
    grid = res // 32
    leaves.append(("visual.attnpool.positional_embedding", (grid * grid + 1, c),
                   ("normal", c ** -0.5)))
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        out = embed if name == "c_proj" else c
        leaves.extend([(f"visual.attnpool.{name}.weight", (out, c), ("normal", c ** -0.5)),
                       (f"visual.attnpool.{name}.bias", (out,), ("zeros",))])
    return leaves


def image_macs(arch: dict, rank: int, input_grad: bool = False) -> tuple:
    """(forward, backward) multiply-adds of one image through the tower with
    FairLoRA on each bottleneck's 1x1 convolutions and plain LoRA on the
    pool's four projections.  Every BatchNorm is trainable, so every
    convolution but the stem's first has an input gradient, and that one
    too where the images take one (``input_grad``: a trainable front
    end)."""
    width, res = arch["vision_width"], arch["image_resolution"]
    fwd = bwd = 0
    h = res // 2
    stem = [(3, width // 2), (width // 2, width // 2), (width // 2, width)]
    for i, (cin, cout) in enumerate(stem):
        m = h * h * cout * cin * 9
        fwd += m
        bwd += m if i or input_grad else 0
    h //= 2
    inplanes = width
    for li, blocks in enumerate(arch["vision_layers"]):
        planes = width * 2 ** li
        for bi in range(blocks):
            stride = 2 if li > 0 and bi == 0 else 1
            out = h // stride
            dense = (h * h * planes * inplanes + h * h * planes * planes * 9
                     + out * out * 4 * planes * planes)
            if bi == 0:
                dense += out * out * 4 * planes * inplanes
            lora = h * h * rank * (inplanes + planes) + out * out * rank * (planes + 4 * planes)
            fwd += dense + lora
            bwd += dense + 2 * lora
            inplanes, h = 4 * planes, out
    tokens, c, embed = h * h + 1, width * 32, arch["embed_dim"]
    dense = 3 * tokens * c * c + tokens * c * embed
    attn = 2 * tokens * tokens * c
    lora = 3 * tokens * rank * 2 * c + tokens * rank * (c + embed)
    fwd += dense + attn + lora
    bwd += dense + 2 * attn + 2 * lora
    return fwd, bwd


def attention(arch: dict, input_grad: bool = False):
    """None: the attention pool is no call of the attention kernels."""
    return None


# --------------------------------------------------------------------------- reference


def batch_norm(x, path, state, stats, train):
    w, b = state[f"visual_bn.{path}.weight"], state[f"visual_bn.{path}.bias"]
    run_mean, run_var = state[f"__bn_stats__.{path}.mean"], state[f"__bn_stats__.{path}.var"]
    if train:
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        stats[f"__bn_stats__.{path}.mean"] = (1 - BN_MOMENTUM) * run_mean + BN_MOMENTUM * mean.detach()
        stats[f"__bn_stats__.{path}.var"] = ((1 - BN_MOMENTUM) * run_var
                                             + BN_MOMENTUM * var.detach() * n / (n - 1))
    else:
        mean, var = run_mean, run_var
    y = (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + BN_EPS)
    return y * w[None, :, None, None] + b[None, :, None, None]


def conv1x1_lora(model, x, weight, key, state, mix):
    y = model.num.conv(x, weight)
    a = state[f"image_encoder_lora.{key}.lora_A"]
    s = mix @ state[f"image_encoder_lora.{key}.lora_S"]
    h = model.num.mm(x.permute(0, 2, 3, 1), a) * s[:, None, None, :]
    return y + model.num.mm(h, state[f"image_encoder_lora.{key}.lora_B"]).permute(0, 3, 1, 2) \
        * model.scaling


def attention_pool(model, x, state):
    """CLIP's AttentionPool2d with every token as a query (the method's
    variant returns all tokens), plain LoRA on the four projections."""
    sd, pre = model.sd, "visual.attnpool"
    b, c = x.shape[:2]
    t = x.flatten(2).transpose(1, 2)
    t = torch.cat([t.mean(1, keepdim=True), t], dim=1) + sd[f"{pre}.positional_embedding"]
    heads = c // 64

    def proj(name, inp):
        out = model.num.linear(inp, sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"])
        return out + model.lora(inp, state[f"attnpool_lora.{name}.lora_A"], None,
                                state[f"attnpool_lora.{name}.lora_B"])

    length = t.shape[1]
    q, k, v = (proj(n, t).reshape(b, length, heads, c // heads).transpose(1, 2)
               for n in ("q_proj", "k_proj", "v_proj"))
    att = (model.num.mm(q, k.transpose(-1, -2)) / math.sqrt(c // heads)).softmax(-1)
    out = model.num.mm(att, v).transpose(1, 2).reshape(b, length, c)
    return proj("c_proj", out)


def tokens(model, x, state, mix, train):
    """(tokens [B, T, embed], new BatchNorm statistics when ``train``) of
    normalised images ``x`` [B, 3, H, W] under ``state`` and ``mix``."""
    sd, stats = model.sd, {}
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = model.num.conv(x, sd[f"visual.conv{i}.weight"], stride=stride, padding=1)
        x = F.relu(batch_norm(x, f"stem.bn{i}", state, stats, train))
    x = F.avg_pool2d(x, 2)
    for layer in range(1, 5):
        for blk in range(model._count(f"visual.layer{layer}")):
            pre, path = f"visual.layer{layer}.{blk}", f"layer{layer}.{blk}"
            stride = 2 if layer > 1 and blk == 0 else 1
            out = conv1x1_lora(model, x, sd[f"{pre}.conv1.weight"], f"{path}.conv1", state, mix)
            out = F.relu(batch_norm(out, f"{path}.bn1", state, stats, train))
            out = model.num.conv(out, sd[f"{pre}.conv2.weight"], padding=1)
            out = F.relu(batch_norm(out, f"{path}.bn2", state, stats, train))
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out = conv1x1_lora(model, out, sd[f"{pre}.conv3.weight"], f"{path}.conv3", state, mix)
            out = batch_norm(out, f"{path}.bn3", state, stats, train)
            if f"{pre}.downsample.0.weight" in sd:
                idn = F.avg_pool2d(x, stride) if stride > 1 else x
                idn = model.num.conv(idn, sd[f"{pre}.downsample.0.weight"])
                idn = batch_norm(idn, f"{path}.downsample_bn", state, stats, train)
            else:
                idn = x
            x = F.relu(out + idn)
    return attention_pool(model, x, state), stats
