"""Shared CLIP model assembly and losses for the method trainers.

Port of ``fairfedmed_tpu/train/clip_common.py``.  ``load_clip_bundle`` plays
the role of load_clip_to_cpu + clip.build_model (trainers/GLP_OT_SVLoRA.py:
23-43, clip/model.py:633-670): an OpenAI ViT or ResNet checkpoint, or an
EVA02-CLIP one, found under ``DATASET.ROOT`` is converted and loaded;
without one the backbone is a seeded random init.  Tiny ``test-vit``,
``test-rn`` and ``test-eva`` presets keep the tests fast.  ``encode_image``
is the one dispatch on the bundle's tower that the trainers call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..fed.dist import all_reduce_sum
from ..core.precision import Policy, policy_from_prec
from ..models import converter, eva_clip, resnet_clip
from ..models.clip_model import (PRESETS, CLIPConfig, init_clip_params, init_text_params,
                                 tree_map, vit_encode)
from ..utils.profiling import span, stamp

TEST_PRESETS = {
    "test-vit": CLIPConfig(
        embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
        vision_patch_size=8, transformer_width=32, transformer_heads=4,
        transformer_layers=2,
    ),
    "test-vit-224": CLIPConfig(
        embed_dim=64, image_resolution=224, vision_layers=2, vision_width=64,
        vision_patch_size=32, transformer_width=64, transformer_heads=4,
        transformer_layers=2,
    ),
}

RN_TEXT_CONFIGS = {
    # the text towers paired with the ResNet image towers (clip/model.py:633-656)
    "RN50": CLIPConfig(embed_dim=1024, transformer_width=512, transformer_heads=8,
                       transformer_layers=12),
    "RN101": CLIPConfig(embed_dim=512, transformer_width=512, transformer_heads=8,
                        transformer_layers=12),
    "RN50x4": CLIPConfig(embed_dim=640, image_resolution=288, transformer_width=640,
                         transformer_heads=10, transformer_layers=12),
    "RN50x16": CLIPConfig(embed_dim=768, image_resolution=384, transformer_width=768,
                          transformer_heads=12, transformer_layers=12),
    "test-rn": CLIPConfig(embed_dim=64, image_resolution=32, transformer_width=64,
                          transformer_heads=4, transformer_layers=2),
}


@dataclasses.dataclass
class CLIPBundle:
    params: dict  # frozen backbone tree (policy.param_dtype; logit_scale fp32)
    clip_cfg: CLIPConfig
    policy: Policy
    pretrained: bool
    backbone_type: str = "vit"  # 'vit' | 'resnet' | 'eva'
    rn_cfg: resnet_clip.ResNetConfig = None  # the ResNet image tower's shape
    eva_cfg: eva_clip.EVAConfig = None  # the EVA02 image tower's shape
    visual_bn: dict = None  # its BatchNorm affine tree (fp32)
    visual_stats: dict = None  # its BatchNorm running statistics (fp32)


def _load_resnet_bundle(cfg, name: str, policy: Policy, device) -> CLIPBundle:
    ckpt = converter.find_checkpoint(name, cfg.DATASET.ROOT) \
        if cfg.MODEL.BACKBONE.PRETRAINED and not name.startswith("test") else None
    if ckpt is not None:
        print(f"Loading CLIP (backbone: {name}) from {ckpt}")
        sd = converter.load_torch_state_dict(ckpt)
        rn_cfg, clip_cfg = converter.infer_rn_config(sd)
        visual, bn, stats = resnet_clip.convert_resnet_visual(sd, rn_cfg)
        text = converter.convert_text_tower(sd)
        params = converter.params_from_numpy({"visual": visual, **text}, device,
                                             policy.param_dtype)
        bn, stats = (converter.params_from_numpy(t, device) for t in (bn, stats))
        return CLIPBundle(params=params, clip_cfg=clip_cfg, policy=policy, pretrained=True,
                          backbone_type="resnet", rn_cfg=rn_cfg, visual_bn=bn,
                          visual_stats=stats)
    rn_cfg, clip_cfg = resnet_clip.RN_PRESETS[name], RN_TEXT_CONFIGS[name]
    if not name.startswith("test"):
        print(f"WARNING: no checkpoint found for {name}; using random init "
              f"(place the OpenAI {converter.checkpoint_name(name)} under DATASET.ROOT "
              "to load pretrained weights)")
    # drawn on the CPU: the same seed gives the same weights on every device
    gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
    visual, bn, stats = resnet_clip.init_modified_resnet(gen, rn_cfg)
    params = init_text_params(gen, clip_cfg, dtype=policy.param_dtype, device=device)
    params["visual"] = tree_map(lambda a: a.to(device, policy.param_dtype), visual)
    params["logit_scale"] = params["logit_scale"].float()
    bn, stats = (tree_map(lambda a: a.to(device), t) for t in (bn, stats))
    stamp("clip_bundle:params_cast_done")
    return CLIPBundle(params=params, clip_cfg=clip_cfg, policy=policy, pretrained=False,
                      backbone_type="resnet", rn_cfg=rn_cfg, visual_bn=bn, visual_stats=stats)


def _load_eva_bundle(cfg, name: str, policy: Policy, device) -> CLIPBundle:
    eva_cfg, clip_cfg = eva_clip.PRESETS[name]
    # the tiny preset loads a checkpoint too, where one is found (the tests'
    # seeded weights in the release's layout)
    ckpt = converter.find_checkpoint(name, cfg.DATASET.ROOT) \
        if cfg.MODEL.BACKBONE.PRETRAINED else None
    if ckpt is not None:
        print(f"Loading CLIP (backbone: {name}) from {ckpt}")
        stamp("clip_bundle:load_start")
        with span("bundle.convert"):
            tree, clip_cfg = converter.convert_eva02_clip(converter.load_torch_state_dict(ckpt),
                                                          eva_cfg)
        stamp("clip_bundle:convert_done")
        with span("bundle.cast"):
            params = converter.params_from_numpy(tree, device, policy.param_dtype)
        stamp("clip_bundle:params_cast_done")
        return CLIPBundle(params=params, clip_cfg=clip_cfg, policy=policy, pretrained=True,
                          backbone_type="eva", eva_cfg=eva_cfg)
    if not name.startswith("test"):
        print(f"WARNING: no checkpoint found for {name}; using random init "
              f"(place {converter.checkpoint_name(name)} under DATASET.ROOT "
              "to load pretrained weights)")
    # drawn on the CPU: the same seed gives the same weights on every device
    gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
    visual = eva_clip.init_eva_visual(gen, eva_cfg)
    with span("bundle.cast"):
        params = init_text_params(gen, clip_cfg, dtype=policy.param_dtype, device=device)
        params["visual"] = tree_map(lambda a: a.to(device, policy.param_dtype), visual)
        params["logit_scale"] = params["logit_scale"].float()
    stamp("clip_bundle:params_cast_done")
    return CLIPBundle(params=params, clip_cfg=clip_cfg, policy=policy, pretrained=False,
                      backbone_type="eva", eva_cfg=eva_cfg)


def load_clip_bundle(cfg, prec: str, device=None) -> CLIPBundle:
    """The frozen CLIP backbone named by ``cfg.MODEL.BACKBONE.NAME`` on
    ``device`` (default ``cuda``): the OpenAI checkpoint when one is found
    under ``cfg.DATASET.ROOT`` (and ``MODEL.BACKBONE.PRETRAINED``), else
    randomly initialised from ``cfg.SEED`` (the same weights on every
    device).  ResNet bundles carry their BatchNorm affine parameters and
    running statistics apart from ``params``, in fp32."""
    device = resolve_device(device)
    name = cfg.MODEL.BACKBONE.NAME
    policy = policy_from_prec(prec)
    if name.startswith("RN") or name == "test-rn":
        return _load_resnet_bundle(cfg, name, policy, device)
    if name in eva_clip.PRESETS:
        return _load_eva_bundle(cfg, name, policy, device)
    if name in TEST_PRESETS:
        clip_cfg = TEST_PRESETS[name]
    else:
        ckpt = converter.find_checkpoint(name, cfg.DATASET.ROOT) \
            if cfg.MODEL.BACKBONE.PRETRAINED else None
        if ckpt is not None:
            print(f"Loading CLIP (backbone: {name}) from {ckpt}")
            tree, clip_cfg = converter.convert_vit_clip(converter.load_torch_state_dict(ckpt))
            params = converter.params_from_numpy(tree, device, policy.param_dtype)
            stamp("clip_bundle:params_cast_done")
            return CLIPBundle(params=params, clip_cfg=clip_cfg, policy=policy, pretrained=True)
        clip_cfg = PRESETS.get(name)
        if clip_cfg is None:
            raise ValueError(f"Unknown CLIP backbone: {name}")
        print(f"WARNING: no checkpoint found for {name}; using random init "
              f"(place the OpenAI {converter.checkpoint_name(name)} under DATASET.ROOT "
              "to load pretrained weights)")
    # drawn on the CPU: the same seed gives the same weights on every device
    gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
    params = init_clip_params(gen, clip_cfg, dtype=policy.param_dtype, device=device)
    params["logit_scale"] = params["logit_scale"].float()
    stamp("clip_bundle:params_cast_done")
    return CLIPBundle(params=params, clip_cfg=clip_cfg, policy=policy, pretrained=False)


def encode_image(bundle: CLIPBundle, visual: dict, x: torch.Tensor, return_tokens: bool,
                 lora: dict = None, attr_mix: torch.Tensor = None, lora_scaling: float = 0.0,
                 bn: dict = None, stats: dict = None, train: bool = False,
                 attnpool_lora: dict = None) -> tuple:
    """(features, BatchNorm statistics) of images ``x`` through the bundle's
    tower: pooled [B, embed_dim], or every token [B, 1+L, embed_dim] when
    ``return_tokens``.  The ResNet tower takes its BatchNorm tree ``bn`` and
    statistics ``stats`` and, in training, returns new statistics; the ViT
    and EVA02 towers have none and return ``stats`` as given.  Adapters:
    ``lora`` on the tower's blocks (ViT ``c_fc``/``c_proj``, EVA02
    ``w1``/``w2``/``w3``, ResNet 1x1 convolutions), ``attnpool_lora`` on the
    ResNet's pool."""
    kind, policy = bundle.backbone_type, bundle.policy
    if kind == "resnet":
        return resnet_clip.resnet_encode(visual, bn, stats, x, bundle.rn_cfg, policy, train=train,
                                         return_tokens=return_tokens, lora=lora,
                                         attnpool_lora=attnpool_lora, attr_mix=attr_mix,
                                         lora_scaling=lora_scaling)
    if kind == "eva":
        return eva_clip.eva_encode(visual, x, bundle.eva_cfg, policy, return_tokens=return_tokens,
                                   lora=lora, attr_mix=attr_mix, lora_scaling=lora_scaling), stats
    if kind == "vit":
        return vit_encode(visual, x, bundle.clip_cfg, policy, return_tokens=return_tokens,
                          lora=lora, attr_mix=attr_mix, lora_scaling=lora_scaling), stats
    raise ValueError(f"no image tower of backbone type {kind!r}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def fairness_confidence_loss(logits, labels, attr, num_groups: int,
                             differentiable: bool = False, group=None) -> torch.Tensor:
    """Confidence-gap fairness regulariser (GLP_OT_SVLoRA.py:908-948).

    Per group g: c_g = 1 - mean_{i in g} p_i[y_i]; loss = mean_g |c_g - mean(c)|
    over the groups present.  The reference builds the group vector with
    ``torch.tensor(list(...))``, which detaches it, so by default the term
    adds to the loss and not to the gradient; ``differentiable=True`` gives
    the intended gradient.

    ``group``: the process group a client's batch is split over.  The group
    means are not linear in the split, so the per-group counts and
    confidence sums are summed over the group before the gap is formed
    (JAX clip_common.py:186-188); every rank then holds the full batch's
    term.  Differentiable, the sum is ``torch.distributed.nn``'s
    ``all_reduce``, whose backward sums the ranks' cotangents: each rank's
    samples see the group's total, and the caller's mean of the gradients
    over the group is the full batch's gradient, as under JAX's ``psum``.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    correct = probs.gather(1, labels.long()[:, None])[:, 0]
    one_hot = F.one_hot(attr.long(), num_groups).float()  # [B, G]
    count = one_hot.sum(0)
    sum_conf = (one_hot * correct[:, None]).sum(0)
    if group is not None:
        both = torch.stack([count, sum_conf])
        if differentiable:
            from torch.distributed.nn.functional import all_reduce
            both = all_reduce(both, group=group)
        else:
            both = all_reduce_sum([both], group)[0]
        count, sum_conf = both[0], both[1]
    present = count > 0
    n_present = present.sum().clamp_min(1)
    conf = 1.0 - sum_conf / count.clamp_min(1.0)
    mean_conf = torch.where(present, conf, 0.0).sum() / n_present
    loss = torch.where(present, (conf - mean_conf).abs(), 0.0).sum() / n_present
    return loss if differentiable else loss.detach()


def fedprox_term(ctx, ctx_global, mu: float, differentiable: bool = False) -> torch.Tensor:
    """FedProx proximal term ``(mu / 2) * ||ctx - ctx_global||^2`` in fp32
    (promptfl.py:290-293).  The reference builds it from ``state_dict()``
    tensors, which torch detaches, so by default it adds to the reported
    loss and not to the gradient; ``differentiable=True`` gives the intended
    pull towards the global context."""
    diff = ctx.float() - ctx_global
    term = (mu / 2.0) * (diff * diff).sum()
    return term if differentiable else term.detach()


def accuracy_from_logits(logits, labels) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean() * 100.0
