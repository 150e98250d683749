"""EVA02-CLIP's vision tower (EVA-CLIP, arXiv:2303.15389; EVA-02,
arXiv:2303.11331; ``baaivision/EVA EVA-CLIP/rei/eva_clip/eva_vit_model.py``
as ``model_configs/EVA02-CLIP-L-14-336.json`` sets it up: ``rope``,
``naiveswiglu``, ``subln``, ``xattn``), in the release's key layout.

A strided patch convolution with a bias, a class token and learned
positions (no LayerNorm before the blocks); pre-norm blocks with separate
q/k/v products (biases on q and v only), 2D rotary positions on the patch
tokens of q and k, a sub-LayerNorm on the heads' concatenation before the
output product, and a SwiGLU MLP (w1, w2, a LayerNorm on the hidden width,
w3; FairLoRA on all three); a final LayerNorm and ``head``, applied to every
token.  Every LayerNorm of the tower takes eps 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..inputs import ln_leaves

LN_EPS = 1e-6
HEAD_WIDTH = 64
PT_HW_SEQ_LEN = 16  # the pretraining grid (224 / 14) the rotary positions are interpolated from
ROPE_THETA = 10000.0
LINEAR_STD = 0.02  # EVA's _init_weights (a truncated normal there)


def _grid(arch: dict) -> int:
    return arch["image_resolution"] // arch["vision_patch_size"]


def _hidden(arch: dict) -> int:
    return int(arch["vision_width"] * arch["mlp_ratio"])  # EVA's int(dim * mlp_ratio): 2730


def image_leaves(arch: dict, init: dict) -> list:
    """``(key, shape, init)`` of the tower's checkpoint leaves, drawn as EVA
    initialises them: linears, the class token and positions N(0, 0.02),
    biases 0, LayerNorms 1 / 0, block i's ``attn.proj`` and ``mlp.w3``
    divided by sqrt(2 (i + 1)) (``fix_init_weight``); the patch convolution,
    which EVA leaves at PyTorch's default, He-normal."""
    w, p, embed = arch["vision_width"], arch["vision_patch_size"], arch["embed_dim"]
    hidden, grid = _hidden(arch), _grid(arch)
    leaves = [
        ("visual.patch_embed.proj.weight", (w, 3, p, p), ("normal", (3 * p * p) ** -0.5)),
        ("visual.patch_embed.proj.bias", (w,), ("zeros",)),
        ("visual.cls_token", (1, 1, w), ("normal", LINEAR_STD)),
        ("visual.pos_embed", (1, grid * grid + 1, w), ("normal", LINEAR_STD))]
    for i in range(arch["vision_layers"]):
        pre, rescaled = f"visual.blocks.{i}", LINEAR_STD / math.sqrt(2.0 * (i + 1))
        leaves += ln_leaves(f"{pre}.norm1", w) + ln_leaves(f"{pre}.norm2", w)
        leaves += [(f"{pre}.attn.{n}_proj.weight", (w, w), ("normal", LINEAR_STD)) for n in "qkv"]
        leaves += [(f"{pre}.attn.q_bias", (w,), ("zeros",)), (f"{pre}.attn.v_bias", (w,), ("zeros",))]
        leaves += ln_leaves(f"{pre}.attn.inner_attn_ln", w)
        leaves += [(f"{pre}.attn.proj.weight", (w, w), ("normal", rescaled)),
                   (f"{pre}.attn.proj.bias", (w,), ("zeros",))]
        for name in ("w1", "w2"):
            leaves += [(f"{pre}.mlp.{name}.weight", (hidden, w), ("normal", LINEAR_STD)),
                       (f"{pre}.mlp.{name}.bias", (hidden,), ("zeros",))]
        leaves += ln_leaves(f"{pre}.mlp.ffn_ln", hidden)
        leaves += [(f"{pre}.mlp.w3.weight", (w, hidden), ("normal", rescaled)),
                   (f"{pre}.mlp.w3.bias", (w,), ("zeros",))]
    leaves += ln_leaves("visual.norm", w)
    return leaves + [("visual.head.weight", (embed, w), ("normal", LINEAR_STD)),
                     ("visual.head.bias", (embed,), ("zeros",))]


def image_macs(arch: dict, rank: int, input_grad: bool = False) -> tuple:
    """(forward, backward) multiply-adds of one image through the tower with
    FairLoRA of ``rank`` on w1, w2 (D -> F) and w3 (F -> D).  A block on T
    tokens: q, k, v and the output product 4 T D^2, the SwiGLU's three
    products 3 T D F, the scores and the weighted sum 2 T^2 D (backward 4
    T^2 D), the adapters T (D r + r F) twice and T (F r + r D), 3 T (D + F)
    r (backward twice that).  Where the images take no gradient (``input_grad``
    false) nothing trainable lies below layer 0's attention, so it and the
    patch embedding have no backward, and layer 0's MLP backward needs only
    w3's input gradient (T F D), w3's adapter (2 T (F + D) r) and the weight
    gradients of w1's and w2's adapters, with no input gradient (T (2 F + D)
    r each).  The head's input gradient counts in every case."""
    w, grid, hidden = arch["vision_width"], _grid(arch), _hidden(arch)
    tokens = grid * grid + 1
    patch = grid * grid * w * 3 * arch["vision_patch_size"] ** 2
    head = tokens * w * arch["embed_dim"]
    dense = tokens * (4 * w * w + 3 * w * hidden)
    attn = 2 * tokens * tokens * w
    lora = 3 * tokens * (w + hidden) * rank
    layers = arch["vision_layers"]
    fwd = patch + layers * (dense + attn + lora) + head
    bwd_block = dense + 2 * attn + 2 * lora
    if input_grad:
        return fwd, patch + layers * bwd_block + head
    layer0 = tokens * (hidden * w + 2 * (hidden + w) * rank + 2 * (2 * hidden + w) * rank)
    return fwd, (layers - 1) * bwd_block + layer0 + head


def attention(arch: dict, input_grad: bool = False) -> dict:
    """One image's attention calls: every token, heads of 64, one call a
    layer; layer 0's has no backward unless the images take a gradient."""
    grid, layers = _grid(arch), arch["vision_layers"]
    return {"length": grid * grid + 1, "dh": HEAD_WIDTH, "heads": arch["vision_width"] // HEAD_WIDTH,
            "backward": [input_grad or layer > 0 for layer in range(layers)]}


def rope(arch: dict, input_grad: bool = False) -> dict:
    """One image's rotary calls (``metrics/_rope.py``): one a layer over the
    packed [L, 3 D] q/k/v projection, backward as the layer's attention."""
    grid, layers = _grid(arch), arch["vision_layers"]
    return {"length": grid * grid + 1, "width": arch["vision_width"],
            "backward": [input_grad or layer > 0 for layer in range(layers)]}


# --------------------------------------------------------------------------- reference


def _layer_norm(model, x, name):
    return F.layer_norm(x, (x.shape[-1],), model.sd[f"{name}.weight"], model.sd[f"{name}.bias"],
                        LN_EPS)


def rope_tables(grid: int, dh: int, device) -> tuple:
    """(cos, sin) [grid^2, dh] of EVA's ``VisionRotaryEmbeddingFast``: per
    axis the frequencies theta^(-2j / (dh/2)), each repeated over an
    interleaved pair, at positions arange(grid) / grid * PT_HW_SEQ_LEN; the
    row's in the first half of the dims, the column's in the second."""
    half = dh // 2
    freqs = 1.0 / ROPE_THETA ** (torch.arange(0, half, 2, dtype=torch.float64)[:half // 2] / half)
    t = torch.arange(grid, dtype=torch.float64) / grid * PT_HW_SEQ_LEN
    freqs = torch.repeat_interleave(torch.einsum("i,f->if", t, freqs), 2, dim=-1)  # [grid, half]
    both = torch.cat([freqs[:, None, :].expand(grid, grid, half),
                      freqs[None, :, :].expand(grid, grid, half)], dim=-1)
    both = both.reshape(grid * grid, dh)
    return both.cos().float().to(device), both.sin().float().to(device)


def rotate_half(x):
    """Each interleaved pair (x0, x1) -> (-x1, x0)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)


def _rope(t, cos, sin):
    """``t`` [B, H, L, dh] with its tokens 1.. rotated; the class token as it is."""
    rest = t[:, :, 1:]
    return torch.cat([t[:, :, :1], rest * cos + rotate_half(rest) * sin], dim=2)


def block(model, x, i, cos, sin, lora, mix):
    """Block ``i`` of the tower on ``x`` [B, L, D]."""
    sd, num, pre = model.sd, model.num, f"visual.blocks.{i}"
    b, length, d = x.shape
    heads = d // HEAD_WIDTH
    h = _layer_norm(model, x, f"{pre}.norm1")
    q = num.linear(h, sd[f"{pre}.attn.q_proj.weight"], sd[f"{pre}.attn.q_bias"])
    k = num.linear(h, sd[f"{pre}.attn.k_proj.weight"])
    v = num.linear(h, sd[f"{pre}.attn.v_proj.weight"], sd[f"{pre}.attn.v_bias"])
    q, k, v = (t.reshape(b, length, heads, HEAD_WIDTH).transpose(1, 2) for t in (q, k, v))
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    scores = num.mm(q, k.transpose(-1, -2)) / math.sqrt(HEAD_WIDTH)
    a = num.mm(scores.softmax(-1), v).transpose(1, 2).reshape(b, length, d)
    a = _layer_norm(model, a, f"{pre}.attn.inner_attn_ln")
    x = x + num.linear(a, sd[f"{pre}.attn.proj.weight"], sd[f"{pre}.attn.proj.bias"])

    def product(name, inp):
        y = num.linear(inp, sd[f"{pre}.mlp.{name}.weight"], sd[f"{pre}.mlp.{name}.bias"])
        if lora is not None:
            y = y + model.lora(inp, *model._lora_layer(lora, name, i, mix))
        return y

    g = _layer_norm(model, x, f"{pre}.norm2")
    hidden = F.silu(product("w1", g)) * product("w2", g)
    return x + product("w3", _layer_norm(model, hidden, f"{pre}.mlp.ffn_ln"))


def tokens(model, x, state, mix, train):
    """(tokens [B, T, embed], {}) of normalised images ``x`` [B, 3, H, W]
    under the trainable ``state`` and the group mix ``mix`` [B, G].  With
    gradients on, each block's activations are recomputed in the backward
    (``torch.utils.checkpoint``: the same arithmetic, so that 32 images of
    24 blocks fit in float32)."""
    sd = model.sd
    w = sd["visual.patch_embed.proj.weight"]
    width, patch = w.shape[0], w.shape[-1]
    x = model.num.conv(x, w, stride=patch) + sd["visual.patch_embed.proj.bias"][None, :, None, None]
    grid = x.shape[-1]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["visual.cls_token"].expand(x.shape[0], 1, width), x], dim=1)
    x = x + sd["visual.pos_embed"]
    cos, sin = rope_tables(grid, HEAD_WIDTH, x.device)
    for i in range(model._count("visual.blocks")):
        if torch.is_grad_enabled():
            x = checkpoint(block, model, x, i, cos, sin, state, mix, use_reentrant=False)
        else:
            x = block(model, x, i, cos, sin, state, mix)
    x = _layer_norm(model, x, "visual.norm")
    return model.num.linear(x, sd["visual.head.weight"], sd["visual.head.bias"]), {}
