"""Parameters into the port's layout: from the JAX package's tree, and from
an OpenAI CLIP checkpoint.

The port keeps the JAX package's parameter tree (nested dicts, lists of
ResNet blocks, torch-convention ``[out, in]`` weights, layer-stacked
transformer blocks), so its frozen CLIP parameters, fetched to host as numpy
arrays, convert leaf for leaf.  The trainable state crosses through the
reference-keyed ``state_dict()`` / ``load_state_dict()`` format that both
trainers share.

The checkpoint path is the port's own copy of the JAX package's
``models/converter.py``: it infers the ViT or ResNet architecture from the
state dict's keys and shapes (clip/model.py:633-670) and stacks the
transformer blocks (``models/resnet_clip.py`` converts the ResNet tower).
PyTorch reads the checkpoint itself (``torch.jit.load``, then
``torch.load``), as the reference does.  Nothing is downloaded: the machines
that run the port have no network.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from .clip_model import CLIPConfig
from .resnet_clip import ResNetConfig


def _keeps_fp32(path: str) -> bool:
    """``logit_scale`` and BatchNorm leaves (affine and running statistics,
    under a ``bn*`` / ``*_bn`` / ``*_stats`` node) stay fp32 whatever the
    storage type."""
    return path == "logit_scale" or any(
        part.startswith("bn") or part.endswith(("_bn", "_stats")) for part in path.split("."))


def params_from_numpy(tree, device, dtype=torch.float32):
    """Nested dicts and lists of numpy arrays -> the same tree of tensors on
    ``device`` in ``dtype``; ``logit_scale`` and BatchNorm leaves stay fp32
    (the loss math and the BatchNorm fp32 island read them).  A JAX
    PromptFL/CLIP trainer's frozen tree, which carries a ResNet's BatchNorm
    trees as ``visual_bn`` / ``visual_stats`` beside ``visual``, converts in
    one call."""
    def conv(path, node):
        if isinstance(node, Mapping):
            return {k: conv(f"{path}.{k}" if path else str(k), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(f"{path}.{i}" if path else str(i), v) for i, v in enumerate(node)]
        leaf_dtype = torch.float32 if _keeps_fp32(path) else dtype
        return torch.tensor(np.asarray(node, dtype=np.float32), device=device, dtype=leaf_dtype)

    return conv("", tree)


def checkpoint_name(backbone_name: str) -> str:
    """``ViT-B/16`` -> ``ViT-B-16.pt``, the OpenAI release's file name."""
    return backbone_name.replace("/", "-") + ".pt"


def download_checkpoint(backbone_name: str, root: Optional[str] = None) -> str:
    raise RuntimeError(f"no network: put {checkpoint_name(backbone_name)} under DATASET.ROOT "
                       f"({root or 'unset'}) or DATASET.ROOT/clip")


def find_checkpoint(backbone_name: str, root: Optional[str] = None) -> Optional[str]:
    """``<root>/<name>.pt`` or ``<root>/clip/<name>.pt``, whichever exists
    first; None when neither does (or there is no root)."""
    if not root:
        return None
    fname = checkpoint_name(backbone_name)
    for c in (os.path.join(root, fname), os.path.join(root, "clip", fname)):
        if os.path.exists(c):
            return c
    return None


def load_torch_state_dict(path: str) -> dict:
    """Checkpoint -> ``{dotted_name: np.ndarray}``: a TorchScript archive
    (the OpenAI release) through ``torch.jit.load``, else a ``torch.save``
    file, unwrapping a ``{"state_dict": ...}`` wrapper (the reference's
    two-stage loader, trainers/GLP_OT_SVLoRA.py:23-43)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def infer_rn_config(sd: dict):
    """ModifiedResNet architecture from checkpoint shapes (clip/model.py:
    643-656): layers, width, heads and resolution of any RN variant, and the
    paired text tower.  Returns ``(ResNetConfig, CLIPConfig)``."""
    counts = tuple(len(set(k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")))
                   for b in (1, 2, 3, 4))
    vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
    pos = sd["visual.attnpool.positional_embedding"].shape[0]
    grid = int(round((pos - 1) ** 0.5))
    if grid ** 2 + 1 != pos:
        raise ValueError(f"attnpool positional embedding of {pos} rows is not a square grid + 1")
    embed_dim = sd["text_projection"].shape[1]
    transformer_width = sd["ln_final.weight"].shape[0]
    rn_cfg = ResNetConfig(layers=counts, output_dim=embed_dim, heads=vision_width * 32 // 64,
                          input_resolution=grid * 32, width=vision_width)
    clip_cfg = CLIPConfig(
        embed_dim=embed_dim,
        image_resolution=grid * 32,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(set(
            k.split(".")[2] for k in sd if k.startswith("transformer.resblocks"))),
    )
    return rn_cfg, clip_cfg


def infer_config(sd: dict) -> CLIPConfig:
    """Architecture inference from checkpoint keys (clip/model.py:633-656),
    ViT checkpoints; ResNet ones go through :func:`infer_rn_config`."""
    if "visual.proj" not in sd:
        raise NotImplementedError("a ResNet CLIP checkpoint: use infer_rn_config")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len([k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=patch * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(set(
            k.split(".")[2] for k in sd if k.startswith("transformer.resblocks"))),
    )


def convert_text_tower(sd: dict, dtype=np.float32) -> dict:
    """The text transformer and ``logit_scale`` of a checkpoint."""
    def a(k):
        return np.asarray(sd[k], dtype)

    layers = len(set(k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")))
    return {
        "text": {
            "token_embedding": a("token_embedding.weight"),
            "positional_embedding": a("positional_embedding"),
            "blocks": _stack_blocks(sd, "transformer", layers, dtype),
            "ln_final": {"weight": a("ln_final.weight"), "bias": a("ln_final.bias")},
            "text_projection": a("text_projection"),
        },
        "logit_scale": np.asarray(sd["logit_scale"], np.float32),
    }


def _stack_blocks(sd: dict, prefix: str, layers: int, dtype=None) -> dict:
    # dtype=None keeps the checkpoint's storage dtype (fp16 for the OpenAI
    # weights): pass the caller's dtype or the tree comes back mixed
    def stack(suffix):
        return np.stack([np.asarray(sd[f"{prefix}.resblocks.{i}.{suffix}"], dtype)
                         for i in range(layers)])

    return {
        "ln_1": {"weight": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "ln_2": {"weight": stack("ln_2.weight"), "bias": stack("ln_2.bias")},
        "attn": {
            "in_proj_weight": stack("attn.in_proj_weight"),
            "in_proj_bias": stack("attn.in_proj_bias"),
            "out_proj": {"weight": stack("attn.out_proj.weight"),
                         "bias": stack("attn.out_proj.bias")},
        },
        "mlp": {
            "c_fc": {"weight": stack("mlp.c_fc.weight"), "bias": stack("mlp.c_fc.bias")},
            "c_proj": {"weight": stack("mlp.c_proj.weight"), "bias": stack("mlp.c_proj.bias")},
        },
    }


def convert_vit_clip(sd: dict, cfg: Optional[CLIPConfig] = None, dtype=np.float32):
    """torch state_dict -> (numpy parameter tree, CLIPConfig)."""
    cfg = cfg or infer_config(sd)

    def a(k):
        return np.asarray(sd[k], dtype)

    params = {
        "visual": {
            "class_embedding": a("visual.class_embedding"),
            "positional_embedding": a("visual.positional_embedding"),
            "conv1": {"weight": a("visual.conv1.weight")},
            "ln_pre": {"weight": a("visual.ln_pre.weight"), "bias": a("visual.ln_pre.bias")},
            "blocks": _stack_blocks(sd, "visual.transformer", cfg.vision_layers, dtype),
            "ln_post": {"weight": a("visual.ln_post.weight"), "bias": a("visual.ln_post.bias")},
            "proj": a("visual.proj"),
        },
        **convert_text_tower(sd, dtype),
    }
    return params, cfg
