"""OpenAI CLIP's VisionTransformer (``clip/model.py``): a strided patch
embedding, a class token, learned positions, pre-LN blocks with QuickGELU
MLPs (FairLoRA on ``c_fc`` and ``c_proj``), ``ln_post`` and a projection.
"""

from __future__ import annotations

import torch

from ..inputs import block_leaves, ln_leaves
from ..metrics._flops import block_macs


def _grid(arch: dict) -> int:
    return arch["image_resolution"] // arch["vision_patch_size"]


def image_leaves(arch: dict, init: dict) -> list:
    """``(key, shape, init)`` of the tower's checkpoint leaves."""
    w, p, embed = arch["vision_width"], arch["vision_patch_size"], arch["embed_dim"]
    grid = _grid(arch)
    leaves = [
        ("visual.class_embedding", (w,), ("normal", w ** -0.5)),
        ("visual.positional_embedding", (grid * grid + 1, w), ("normal", w ** -0.5)),
        ("visual.conv1.weight", (w, 3, p, p), ("normal", (3 * p * p) ** -0.5)),
        ("visual.proj", (w, embed), ("normal", w ** -0.5))]
    leaves += ln_leaves("visual.ln_pre", w) + ln_leaves("visual.ln_post", w)
    return leaves + block_leaves("visual.transformer", arch["vision_layers"], w)


def image_macs(arch: dict, rank: int, input_grad: bool = False) -> tuple:
    """(forward, backward) multiply-adds of one image through the tower
    with its adapters.  Where the images take no gradient (``input_grad``
    false) the patch embedding and layer 0's attention see no trainable
    input, so they have no backward; layer 0's MLP backward needs only the
    c_proj input gradient (4 T D^2) and its adapters' (c_fc's without an
    input gradient: 9 T D r; c_proj's: 10 T D r).  Where they do (a
    trainable front end), every layer and the patch embedding have one."""
    width, grid = arch["vision_width"], _grid(arch)
    tokens = grid * grid + 1
    patch = grid * grid * width * 3 * arch["vision_patch_size"] ** 2
    proj = tokens * width * arch["embed_dim"]
    fwd_block, bwd_block = block_macs(tokens, width, rank)
    layers = arch["vision_layers"]
    fwd = patch + layers * fwd_block + proj
    if input_grad:
        return fwd, patch + layers * bwd_block + proj
    bwd = (layers - 1) * bwd_block + 4 * tokens * width * width \
        + 19 * tokens * width * rank + proj
    return fwd, bwd


def attention(arch: dict, input_grad: bool = False) -> dict:
    """One image's attention calls: every token, heads of width 64, one call
    a layer; unless the images take a gradient, nothing trainable lies below
    layer 0's (the adapters sit on the MLPs), so it has no backward."""
    grid, layers = _grid(arch), arch["vision_layers"]
    return {"length": grid * grid + 1, "dh": 64, "heads": arch["vision_width"] // 64,
            "backward": [input_grad or layer > 0 for layer in range(layers)]}


def tokens(model, x, state, mix, train):
    """(tokens [B, T, embed], {}) of normalised images ``x`` [B, 3, H, W]
    under the trainable ``state`` and the group mix ``mix`` [B, G]."""
    sd = model.sd
    width, patch = sd["visual.conv1.weight"].shape[0], sd["visual.conv1.weight"].shape[-1]
    x = model.num.conv(x, sd["visual.conv1.weight"], stride=patch)  # [B, width, g, g]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["visual.class_embedding"].expand(x.shape[0], 1, width), x], dim=1)
    x = model.layer_norm(x + sd["visual.positional_embedding"], "visual.ln_pre")
    x = model.blocks(x, "visual.transformer", model._count("visual.transformer.resblocks"),
                     width // 64, lora=state, mix=mix)
    return model.num.mm(model.layer_norm(x, "visual.ln_post"), sd["visual.proj"]), {}
