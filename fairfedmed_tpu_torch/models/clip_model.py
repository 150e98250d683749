"""Functional CLIP (ViT + text transformer) in PyTorch.

Port of ``fairfedmed_tpu/models/clip_model.py``: plain functions over the
same parameter tree (nested dicts of tensors, torch-convention ``[out, in]``
weights, transformer blocks stacked along a leading layer axis), so the JAX
package's parameters carry over leaf for leaf (``models/converter.py``).

* matmuls take the policy's compute type with fp32 accumulation (what cuBLAS
  does for bf16); LayerNorm runs in fp32;
* attention always goes through ``ops.attention.flash_attention``: the
  hand-written CUDA kernels on the GPU, their plain version on the CPU;
* the stacked blocks run as a Python loop over the layer axis;
* FairLoRA adapters on both MLP linears (``c_fc`` and ``c_proj``) thread
  through the same loop as a stacked tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..adapters.lora import lora_delta
from ..core.precision import Policy
from ..ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size


PRESETS = {
    "ViT-B/16": CLIPConfig(),
    "ViT-B/32": CLIPConfig(vision_patch_size=32),
    "ViT-L/14": CLIPConfig(embed_dim=768, vision_layers=24, vision_width=1024,
                           vision_patch_size=14, transformer_width=768,
                           transformer_heads=12, transformer_layers=12),
}


# --------------------------------------------------------------------------- #
# primitive layers
# --------------------------------------------------------------------------- #

def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W^T + b with torch-convention W [out, in], in x's type."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 whatever the input type."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def multi_head_attention(p: dict, x: torch.Tensor, num_heads: int,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention with packed in_proj (torch nn.MultiheadAttention math).
    x: [B, L, D]."""
    b, l, d = x.shape
    dh = d // num_heads
    qkv = dense(x, p["in_proj_weight"], p["in_proj_bias"])  # [B, L, 3D]
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, l, num_heads, dh).transpose(1, 2)  # [B, H, L, dh]

    out = flash_attention(heads(q), heads(k), heads(v), mask=mask).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, l, d)
    return dense(out, p["out_proj"]["weight"], p["out_proj"]["bias"])


def mlp_block(p: dict, x: torch.Tensor, lora: Optional[dict] = None,
              attr_mix: Optional[torch.Tensor] = None, lora_scaling: float = 0.0) -> torch.Tensor:
    """c_proj(QuickGELU(c_fc(x))) with optional LoRA deltas on both linears."""
    h = dense(x, p["c_fc"]["weight"], p["c_fc"]["bias"])
    if lora is not None and "c_fc" in lora:
        h = h + lora_delta(lora["c_fc"], x, attr_mix, lora_scaling)
    h = quick_gelu(h)
    y = dense(h, p["c_proj"]["weight"], p["c_proj"]["bias"])
    if lora is not None and "c_proj" in lora:
        y = y + lora_delta(lora["c_proj"], h, attr_mix, lora_scaling)
    return y


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, so gradients reach the
    stacked tensors)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def transformer(blocks: dict, x: torch.Tensor, num_heads: int,
                mask: Optional[torch.Tensor] = None, lora: Optional[dict] = None,
                attr_mix: Optional[torch.Tensor] = None, lora_scaling: float = 0.0) -> torch.Tensor:
    """Residual pre-LN blocks over the layer-stacked params (and adapters)."""
    for i in range(blocks["ln_1"]["weight"].shape[0]):
        bp = layer_slice(blocks, i)
        lp = None if lora is None else layer_slice(lora, i)
        x = x + multi_head_attention(bp["attn"], layer_norm(bp["ln_1"], x), num_heads, mask)
        x = x + mlp_block(bp["mlp"], layer_norm(bp["ln_2"], x), lp, attr_mix, lora_scaling)
    return x


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #

def vit_encode(visual: dict, image: torch.Tensor, cfg: CLIPConfig, policy: Policy,
               return_tokens: bool = False, lora: Optional[dict] = None,
               attr_mix: Optional[torch.Tensor] = None, lora_scaling: float = 0.0) -> torch.Tensor:
    """ViT image encoder.  image: [B, 3, H, W].  Returns [B, embed_dim], or
    [B, 1+L, embed_dim] with CLS first when ``return_tokens``."""
    dt = policy.compute_dtype
    x = image.to(dt)
    p = cfg.vision_patch_size
    # patch embedding: a conv with stride = kernel = p is unfold + matmul
    b, _, h, wdt = x.shape
    gh, gw = h // p, wdt // p
    x = x.reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, 3 * p * p)
    w = visual["conv1"]["weight"].to(dt).reshape(cfg.vision_width, 3 * p * p)
    x = F.linear(x, w)  # [B, L, D]

    cls = visual["class_embedding"].to(dt).expand(b, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + visual["positional_embedding"].to(dt)
    x = layer_norm(visual["ln_pre"], x)

    x = transformer(visual["blocks"], x, cfg.vision_heads,
                    lora=lora, attr_mix=attr_mix, lora_scaling=lora_scaling)

    proj = visual["proj"].to(dt)
    if return_tokens:
        return layer_norm(visual["ln_post"], x) @ proj
    return layer_norm(visual["ln_post"], x[:, 0, :]) @ proj


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: -inf above the diagonal."""
    return torch.triu(torch.full((length, length), float("-inf"), device=device), diagonal=1)


def text_encode(params: dict, prompt_embeds: torch.Tensor, eot_indices: np.ndarray,
                cfg: CLIPConfig, policy: Policy, pool: Optional[tuple] = None) -> torch.Tensor:
    """Text transformer over pre-built prompt embeddings.

    prompt_embeds: [N, 77, width]; eot_indices: host [N] positions of the EOT
    token, used for pooling, whose device copy ``pool`` (``pool_index``) a
    caller that runs the same prompts again makes once.  Under causal
    attention no position up to the last EOT sees a later one, so the
    sequence is cut after the last EOT (rounded up to a multiple of 8) --
    the same values, ~5x less work.
    """
    text = params["text"]
    x = prompt_embeds.to(policy.compute_dtype)
    eot = np.asarray(eot_indices)
    l_eff = int(eot.max()) + 1
    l_eff = min(x.shape[1], max(8, -(-l_eff // 8) * 8))
    x = x[:, :l_eff]
    x = x + text["positional_embedding"][:l_eff].to(x.dtype)
    x = transformer(text["blocks"], x, cfg.transformer_heads,
                    mask=causal_mask(l_eff, device=x.device))
    x = layer_norm(text["ln_final"], x)
    rows, cols = pool_index(eot, x.device) if pool is None else pool
    pooled = x[rows, cols]
    return pooled @ text["text_projection"].to(pooled.dtype)


def pool_index(eot_indices: np.ndarray, device) -> tuple:
    """(row, EOT column) index tensors on ``device`` for ``text_encode``'s
    pooling.  Made from the host, so on a card the copy waits for the
    device: a trainer makes them once."""
    eot = np.asarray(eot_indices)
    return (torch.arange(len(eot), device=device), torch.as_tensor(eot).long().to(device))


def embed_tokens(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup [N, 77] -> [N, 77, width]."""
    return params["text"]["token_embedding"][token_ids]


# --------------------------------------------------------------------------- #
# initialisation
# --------------------------------------------------------------------------- #

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _ln_init(shape, device):
    return {"weight": torch.ones(shape, device=device), "bias": torch.zeros(shape, device=device)}


def _init_blocks(gen, layers, width, attn_std, fc_std, proj_std):
    """Stacked residual-block params, init per CLIP.initialize_parameters."""
    dev = gen.device
    zeros = lambda *s: torch.zeros((layers, *s), device=dev)
    return {
        "ln_1": _ln_init((layers, width), dev),
        "ln_2": _ln_init((layers, width), dev),
        "attn": {
            "in_proj_weight": _normal(gen, (layers, 3 * width, width), attn_std),
            "in_proj_bias": zeros(3 * width),
            "out_proj": {"weight": _normal(gen, (layers, width, width), proj_std),
                         "bias": zeros(width)},
        },
        "mlp": {
            "c_fc": {"weight": _normal(gen, (layers, 4 * width, width), fc_std),
                     "bias": zeros(4 * width)},
            "c_proj": {"weight": _normal(gen, (layers, width, 4 * width), proj_std),
                       "bias": zeros(width)},
        },
    }


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _init_text(gen: torch.Generator, cfg: CLIPConfig) -> dict:
    tw = cfg.transformer_width
    return {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02),
        "positional_embedding": _normal(gen, (cfg.context_length, tw), 0.01),
        "blocks": _init_blocks(gen, cfg.transformer_layers, tw, attn_std=tw ** -0.5,
                               fc_std=(2 * tw) ** -0.5,
                               proj_std=(tw ** -0.5) * ((2 * cfg.transformer_layers) ** -0.5)),
        "ln_final": _ln_init((tw,), gen.device),
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5),
    }


def _logit_scale(device) -> torch.Tensor:
    return torch.tensor(float(np.log(1 / 0.07)), device=device)


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig, dtype=torch.float32,
                     device=None) -> dict:
    """Random CLIP init (no OpenAI checkpoint), drawn from ``gen`` and moved to
    ``device``.  With a CPU generator the weights are the same whatever the
    device; they differ from the JAX package's draws for the same seed."""
    vw = cfg.vision_width
    n_tokens = cfg.grid_size ** 2 + 1
    dev = gen.device
    visual = {
        "class_embedding": _normal(gen, (vw,), vw ** -0.5),
        "positional_embedding": _normal(gen, (n_tokens, vw), vw ** -0.5),
        "conv1": {"weight": _normal(gen, (vw, 3, cfg.vision_patch_size, cfg.vision_patch_size),
                                    vw ** -0.5)},
        "ln_pre": _ln_init((vw,), dev),
        "blocks": _init_blocks(gen, cfg.vision_layers, vw, attn_std=vw ** -0.5,
                               fc_std=(2 * vw) ** -0.5,
                               proj_std=(vw ** -0.5) * ((2 * cfg.vision_layers) ** -0.5)),
        "ln_post": _ln_init((vw,), dev),
        "proj": _normal(gen, (vw, cfg.embed_dim), vw ** -0.5),
    }
    params = {"visual": visual, "text": _init_text(gen, cfg), "logit_scale": _logit_scale(dev)}
    return tree_map(lambda a: a.to(device=device, dtype=dtype), params)


def init_text_params(gen: torch.Generator, cfg: CLIPConfig, dtype=torch.float32,
                     device=None) -> dict:
    """The text tower and ``logit_scale`` alone, as :func:`init_clip_params`
    draws them (the ResNet backbones bring their own image tower)."""
    params = {"text": _init_text(gen, cfg), "logit_scale": _logit_scale(gen.device)}
    return tree_map(lambda a: a.to(device=device, dtype=dtype), params)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.sqrt((x32 * x32).sum(dim=dim, keepdim=True))
    return (x32 / n.clamp_min(eps)).to(x.dtype)
