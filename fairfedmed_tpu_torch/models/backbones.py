"""Backbone and head registries of the ``Baseline`` trainer (port of
``fairfedmed_tpu/models/backbones.py``; Dassl's SimpleNet,
``Dassl/dassl/engine/trainer.py:48-105``, ``modeling/backbone/resnet.py``,
``models_vit.py`` and ``head/mlp.py``).

A backbone is a pair of functions over explicit state, as in the JAX
package:

``init(generator, device) -> (params, stats)`` and
``apply(params, stats, x, train) -> (features, new_stats)``

with the BatchNorm running statistics passed in and returned (new tensors,
detached; nothing is updated in place).  ``x`` is NCHW fp32.  The trees
have the JAX package's layout (nested dicts, lists of ResNet blocks, the
ViT's blocks stacked on a leading depth axis), so the JAX package's
parameters convert leaf for leaf (:func:`backbone_from_numpy`).  Weights are
drawn from a ``torch.Generator`` (pretrained torchvision or MAE weights are
not available offline; the trainer says so).  The ViT computes its attention
with plain ``softmax(q k^T / sqrt(d)) v``, as the JAX backbone does: it
reaches no attention kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import converter

BN_MOMENTUM = 0.1
BN_EPS = 1e-5

BACKBONE_REGISTRY = {}


def register_backbone(name):
    def deco(fn):
        BACKBONE_REGISTRY[name] = fn
        return fn
    return deco


def build_backbone(name: str):
    """``(init, apply, out_features)`` of a registered backbone."""
    if name not in BACKBONE_REGISTRY:
        raise KeyError(f"backbone {name!r} not registered; available: "
                       f"{sorted(BACKBONE_REGISTRY)}")
    return BACKBONE_REGISTRY[name]()


def backbone_from_numpy(params, stats, device):
    """The JAX package's backbone or head ``(params, stats)``, fetched to the
    host as numpy, as the port's tensors on ``device`` (fp32)."""
    return converter.params_from_numpy(params, device), converter.params_from_numpy(stats, device)


# --------------------------------------------------------------------------- #
# functional primitives
# --------------------------------------------------------------------------- #

def _conv_init(gen, cout, cin, k, device):
    # kaiming_normal_(mode='fan_out') as the reference ResNet._init_params
    # (resnet.py:171-178): std = sqrt(2 / (cout * k * k))
    return (torch.randn((cout, cin, k, k), generator=gen) * (2.0 / (cout * k * k)) ** 0.5
            ).to(device)


def _bn_init(dim, device):
    return ({"weight": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)},
            {"mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device)})


def _conv(x, w, stride=1, padding=0):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn_update(stat, mean, var, n):
    """torch's running-statistics update: momentum 0.1, unbiased variance."""
    return {"mean": ((1 - BN_MOMENTUM) * stat["mean"] + BN_MOMENTUM * mean).detach(),
            "var": ((1 - BN_MOMENTUM) * stat["var"]
                    + BN_MOMENTUM * var * n / max(n - 1, 1)).detach()}


def _bn(bn, stat, x, train):
    """BatchNorm2d in fp32 with torch's momentum semantics; returns ``(y,
    new_stat)``."""
    x32 = x.float()
    if train:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), unbiased=False)
        new_stat = _bn_update(stat, mean, var, x32.shape[0] * x32.shape[2] * x32.shape[3])
    else:
        mean, var = stat["mean"], stat["var"]
        new_stat = stat
    y = (x32 - mean.reshape(1, -1, 1, 1)) * torch.rsqrt(var.reshape(1, -1, 1, 1) + BN_EPS)
    return (y * bn["weight"].reshape(1, -1, 1, 1)
            + bn["bias"].reshape(1, -1, 1, 1)).to(x.dtype), new_stat


def _max_pool(x, k, stride, padding):
    return F.max_pool2d(x, k, stride, padding)


# --------------------------------------------------------------------------- #
# torchvision-style ResNets (backbone/resnet.py)
# --------------------------------------------------------------------------- #

def _resnet(block_counts: Sequence[int], bottleneck: bool, mix: Optional[str] = None,
            mix_layers: Sequence[str] = ()):
    """torchvision-style ResNet; ``mix`` / ``mix_layers`` add MixStyle or
    EFDMix after the named stages (backbone/resnet.py:283-556).  Mixing runs
    only in train mode when the caller passes ``apply`` a generator: dormant
    by default, as Dassl's run_with_mixstyle context (mixstyle.py:37-50)."""
    expansion = 4 if bottleneck else 1
    out_features = 512 * expansion

    def init(gen, device=None):
        params = {"conv1": _conv_init(gen, 64, 3, 7, device)}
        bn, stats = {}, {}
        bn["bn1"], stats["bn1"] = _bn_init(64, device)
        inplanes = 64
        for li, nblocks in enumerate(block_counts):
            planes = 64 * (2 ** li)
            blocks_p, blocks_b, blocks_s = [], [], []
            for bi in range(nblocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                if bottleneck:
                    p = {"conv1": _conv_init(gen, planes, inplanes, 1, device),
                         "conv2": _conv_init(gen, planes, planes, 3, device),
                         "conv3": _conv_init(gen, planes * 4, planes, 1, device)}
                    dims = (planes, planes, planes * 4)
                else:
                    p = {"conv1": _conv_init(gen, planes, inplanes, 3, device),
                         "conv2": _conv_init(gen, planes, planes, 3, device)}
                    dims = (planes, planes)
                b, s = {}, {}
                for i, dim in enumerate(dims, start=1):
                    b[f"bn{i}"], s[f"bn{i}"] = _bn_init(dim, device)
                if stride != 1 or inplanes != planes * expansion:
                    p["downsample"] = _conv_init(gen, planes * expansion, inplanes, 1, device)
                    b["downsample_bn"], s["downsample_bn"] = _bn_init(planes * expansion, device)
                blocks_p.append(p)
                blocks_b.append(b)
                blocks_s.append(s)
                inplanes = planes * expansion
            params[f"layer{li + 1}"] = blocks_p
            bn[f"layer{li + 1}"] = blocks_b
            stats[f"layer{li + 1}"] = blocks_s
        return {"conv": params, "bn": bn}, stats

    def block_apply(p, b, s, x, stride, train):
        new_s = {}
        if bottleneck:
            y, new_s["bn1"] = _bn(b["bn1"], s["bn1"], _conv(x, p["conv1"]), train)
            y = F.relu(y)
            y, new_s["bn2"] = _bn(b["bn2"], s["bn2"], _conv(y, p["conv2"], stride, 1), train)
            y = F.relu(y)
            y, new_s["bn3"] = _bn(b["bn3"], s["bn3"], _conv(y, p["conv3"]), train)
        else:
            y, new_s["bn1"] = _bn(b["bn1"], s["bn1"], _conv(x, p["conv1"], stride, 1), train)
            y = F.relu(y)
            y, new_s["bn2"] = _bn(b["bn2"], s["bn2"], _conv(y, p["conv2"], 1, 1), train)
        if "downsample" in p:
            sc, new_s["downsample_bn"] = _bn(b["downsample_bn"], s["downsample_bn"],
                                             _conv(x, p["downsample"], stride), train)
        else:
            sc = x
        return F.relu(y + sc), new_s

    def apply(params, stats, x, train, generator: Optional[torch.Generator] = None):
        conv, bn = params["conv"], params["bn"]
        new_stats = {}
        y, new_stats["bn1"] = _bn(bn["bn1"], stats["bn1"], _conv(x, conv["conv1"], 2, 3), train)
        y = _max_pool(F.relu(y), 3, 2, 1)
        mixing = mix is not None and generator is not None and train
        for li, nblocks in enumerate(block_counts):
            lname = f"layer{li + 1}"
            new_stats[lname] = []
            for bi in range(nblocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                y, ns = block_apply(conv[lname][bi], bn[lname][bi], stats[lname][bi], y,
                                    stride, train)
                new_stats[lname].append(ns)
            if mixing and lname in mix_layers:
                from ..ops import dassl

                mix_fn = dassl.mixstyle if mix == "mixstyle" else dassl.efdmix
                y = mix_fn(y, generator, p=0.5, alpha=0.1)
        return y.mean((2, 3)), new_stats

    return init, apply, out_features


for _name, _counts, _bneck in (("resnet18", (2, 2, 2, 2), False),
                               ("resnet34", (3, 4, 6, 3), False),
                               ("resnet50", (3, 4, 6, 3), True),
                               ("resnet101", (3, 4, 23, 3), True),
                               ("resnet152", (3, 8, 36, 3), True)):
    BACKBONE_REGISTRY[_name] = functools.partial(_resnet, _counts, _bneck)

# MixStyle / EFDMix stage variants (backbone/resnet.py:283-556)
_MIX_STAGES = {"l123": ("layer1", "layer2", "layer3"), "l12": ("layer1", "layer2"),
               "l1": ("layer1",)}
for _base, _counts, _bneck in (("resnet18", (2, 2, 2, 2), False),
                               ("resnet50", (3, 4, 6, 3), True),
                               ("resnet101", (3, 4, 23, 3), True)):
    for _mix, _tag in (("mixstyle", "ms"), ("efdmix", "efdmix")):
        for _suffix, _stages in _MIX_STAGES.items():
            BACKBONE_REGISTRY[f"{_base}_{_tag}_{_suffix}"] = functools.partial(
                _resnet, _counts, _bneck, _mix, _stages)


# --------------------------------------------------------------------------- #
# timm-style ViT (backbone/models_vit.py)
# --------------------------------------------------------------------------- #

def _layer_norm(x, w, b, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


@register_backbone("vit_base_patch16")
def _vit_base_patch16(image_size: int = 224, depth: int = 12, width: int = 768,
                      heads: int = 12):
    """ViT-B/16 with global average pooling and fc_norm (models_vit.py:26-83,
    MAE-style).  The blocks' parameters are stacked on a leading depth axis,
    as the JAX package scans them; the MLP's GELU is the tanh form, as
    ``jax.nn.gelu``'s default."""
    patch = 16
    n_tok = (image_size // patch) ** 2 + 1
    head_dim = width // heads

    def init(gen, device=None):
        def tnorm(shape, std):
            return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std,
                                               2.0 * std, generator=gen)

        def leaf(shape, fan_in):
            return torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5

        def stacked(shape, fan_in):
            return torch.stack([leaf(shape, fan_in) for _ in range(depth)])

        blocks = {
            "ln1_w": torch.ones(depth, width), "ln1_b": torch.zeros(depth, width),
            "qkv_w": stacked((width, 3 * width), width), "qkv_b": torch.zeros(depth, 3 * width),
            "proj_w": stacked((width, width), width), "proj_b": torch.zeros(depth, width),
            "ln2_w": torch.ones(depth, width), "ln2_b": torch.zeros(depth, width),
            "fc1_w": stacked((width, 4 * width), width), "fc1_b": torch.zeros(depth, 4 * width),
            "fc2_w": stacked((4 * width, width), 4 * width), "fc2_b": torch.zeros(depth, width),
        }
        params = {"patch_w": leaf((width, 3, patch, patch), 3 * patch * patch),
                  "patch_b": torch.zeros(width), "cls": tnorm((1, 1, width), 0.02),
                  "pos": tnorm((1, n_tok, width), 0.02), "blocks": blocks,
                  "fc_norm_w": torch.ones(width), "fc_norm_b": torch.zeros(width)}
        to = functools.partial(_to_device, device=device)
        return to(params), {}

    def block(x, bp):
        h = _layer_norm(x, bp["ln1_w"], bp["ln1_b"])
        qkv = h @ bp["qkv_w"] + bp["qkv_b"]
        q, k, v = qkv.chunk(3, dim=-1)
        b_, t, _ = q.shape

        def split(a):
            return a.reshape(b_, t, heads, head_dim).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        att = torch.softmax((q @ k.transpose(-1, -2)) / head_dim ** 0.5, dim=-1)
        h = (att @ v).transpose(1, 2).reshape(b_, t, width)
        x = x + h @ bp["proj_w"] + bp["proj_b"]
        h = _layer_norm(x, bp["ln2_w"], bp["ln2_b"])
        h = F.gelu(h @ bp["fc1_w"] + bp["fc1_b"], approximate="tanh") @ bp["fc2_w"] + bp["fc2_b"]
        return x + h

    def apply(params, stats, x, train):
        y = F.conv2d(x, params["patch_w"].to(x.dtype), stride=patch)
        b_ = y.shape[0]
        y = y.reshape(b_, width, -1).transpose(1, 2) + params["patch_b"]
        cls = params["cls"].to(y.dtype).expand(b_, 1, width)
        y = torch.cat([cls, y], dim=1) + params["pos"].to(y.dtype)
        blocks = params["blocks"]
        for i in range(blocks["qkv_w"].shape[0]):
            y = block(y, {k: v[i] for k, v in blocks.items()})
        pooled = y[:, 1:, :].mean(dim=1)  # global pool without the class token
        return _layer_norm(pooled, params["fc_norm_w"], params["fc_norm_b"]), stats

    return init, apply, width


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@register_backbone("cnn3")
def _cnn3():
    """Compact 3-conv net (the CIFAR-scale default when no backbone is
    named)."""
    w = 64

    def init(gen, device=None):
        return {"conv1": _conv_init(gen, w, 3, 3, device),
                "conv2": _conv_init(gen, 2 * w, w, 3, device),
                "conv3": _conv_init(gen, 4 * w, 2 * w, 3, device)}, {}

    def apply(params, stats, x, train):
        for name in ("conv1", "conv2", "conv3"):
            x = F.relu(_conv(x, params[name], stride=2, padding=1))
        return x.mean((2, 3)), stats

    return init, apply, 4 * w


# --------------------------------------------------------------------------- #
# heads (head/mlp.py)
# --------------------------------------------------------------------------- #

_ACTIVATIONS = {"relu": F.relu, "leaky_relu": F.leaky_relu,
                "gelu": functools.partial(F.gelu, approximate="tanh")}


def build_head(name: str, in_features: int, hidden_layers: Sequence[int],
               activation: str = "relu", bn: bool = True, dropout: float = 0.0):
    """MLP head: Linear (+ BatchNorm1d) + activation per hidden layer;
    ``(init, apply, out_features)``.  Dropout is not applied (the Baseline
    default is 0), as in the JAX package."""
    if name != "mlp":
        raise KeyError(f"head {name!r} not registered; available: ['mlp']")
    hidden = [int(h) for h in hidden_layers]
    act = _ACTIVATIONS[activation]

    def init(gen, device=None):
        params, stats = [], []
        dims = [in_features] + hidden
        for din, dout in zip(dims[:-1], dims[1:]):
            layer = {"weight": (torch.randn((dout, din), generator=gen)
                                * (2.0 / din) ** 0.5).to(device),
                     "bias": torch.zeros(dout, device=device)}
            if bn:
                layer["bn"], s = _bn_init(dout, device)
                stats.append(s)
            else:
                stats.append({})
            params.append(layer)
        return params, stats

    def apply(params, stats, x, train):
        new_stats = []
        for layer, s in zip(params, stats):
            x = x @ layer["weight"].T + layer["bias"]
            if "bn" in layer:
                x32 = x.float()
                if train:
                    mean, var = x32.mean(0), x32.var(0, unbiased=False)
                    s = _bn_update(s, mean, var, x32.shape[0])
                else:
                    mean, var = s["mean"], s["var"]
                x = ((x32 - mean) * torch.rsqrt(var + BN_EPS) * layer["bn"]["weight"]
                     + layer["bn"]["bias"]).to(x.dtype)
            new_stats.append(s)
            x = act(x)
        return x, new_stats

    out_features = hidden[-1] if hidden else in_features
    return init, apply, out_features
