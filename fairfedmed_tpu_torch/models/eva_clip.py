"""EVA02-CLIP's vision tower (EVA-CLIP, arXiv:2303.15389; EVA-02,
arXiv:2303.11331), functional and layer-stacked like ``clip_model.py``.

The layers of ``baaivision/EVA EVA-CLIP/rei/eva_clip/eva_vit_model.py`` as
EVA02-CLIP-L-14-336 configures them (``rope``, ``naiveswiglu``, ``subln``,
``xattn``; LayerNorm eps 1e-6 everywhere in the tower).  One pre-norm block:

* ``h = norm1(x)``; ``q = h Wq^T + q_bias``, ``k = h Wk^T`` (no bias),
  ``v = h Wv^T + v_bias``, in heads of 64;
* 2D rotary positions on the patch tokens of q and k (the class token is
  left as it is): per axis the frequencies ``10000^(-2j/32)``, j < 16, each
  repeated over an interleaved pair, at positions interpolated from the
  pretraining grid (``t = arange(grid) / grid * pt_hw_seq_len``), the row
  driving dims 0-31 and the column dims 32-63; ``u cos + rotate_half(u) sin``
  with ``rotate_half`` taking each pair (u0, u1) to (-u1, u0);
* ``x = x + proj(inner_attn_ln(softmax(q k^T / 8) v))`` (the sub-LN over the
  concatenated heads);
* ``x = x + w3(ffn_ln(SiLU(w1 g) * w2 g))``, ``g = norm2(x)``.

Below the blocks a strided patch convolution with a bias, the class token
and learned positions (no ``ln_pre``); above them ``norm`` and ``head``, a
linear with a bias, applied to every token when ``return_tokens`` (GLP-OT
reads the patch tokens).

As in ``clip_model.py`` the products run in the policy's compute type and
LayerNorm in fp32.  q, k and v are one product on weights concatenated at
load (bias ``[q_bias, 0, v_bias]``); the RoPE op (``ops/rope.py``) rotates
and splits its output into heads in one pass, q scaled by 1/8, and the
attention kernels take the heads as they come.  FairLoRA adapters sit on
``w1``, ``w2`` and ``w3``, stacked per layer like the ViT's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..adapters.lora import lora_delta
from ..core.precision import Policy
from ..ops.attention import flash_attention
from ..ops.rope import rope_qkv
from .clip_model import CLIPConfig, dense, layer_slice, tree_map

LN_EPS = 1e-6
ROPE_THETA = 10000.0  # VisionRotaryEmbeddingFast's base
LORA_PARTS = ("w1", "w2", "w3")  # the adapted MLP products


@dataclasses.dataclass(frozen=True)
class EVAConfig:
    """The vision tower's shape (``vision_cfg`` of EVA-CLIP's model config)."""
    embed_dim: int = 768
    image_resolution: int = 336
    vision_layers: int = 24
    vision_width: int = 1024
    vision_patch_size: int = 14
    head_width: int = 64
    mlp_ratio: float = 2.6667
    pt_hw_seq_len: int = 16

    @property
    def vision_heads(self) -> int:
        return self.vision_width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.vision_width * self.mlp_ratio)  # EVA's int(dim * mlp_ratio): 2730


# name -> (vision tower, the CLIPConfig of its text tower and image size)
PRESETS = {
    "EVA02-CLIP-L-14-336": (
        EVAConfig(),
        CLIPConfig(embed_dim=768, image_resolution=336, vision_layers=24, vision_width=1024,
                   vision_patch_size=14, context_length=77, vocab_size=49408,
                   transformer_width=768, transformer_heads=12, transformer_layers=12)),
    # tiny: 2 heads of 64, a 4 x 4 grid interpolated from 2 x 2, an odd MLP width (341)
    "test-eva": (
        EVAConfig(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=128,
                  vision_patch_size=8, pt_hw_seq_len=2),
        CLIPConfig(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=128,
                   vision_patch_size=8, transformer_width=64, transformer_heads=1,
                   transformer_layers=2)),
}


def rope_tables(cfg: EVAConfig, device=None) -> tuple:
    """(cos, sin), fp32 [grid^2, head_width], of the patch tokens in row-major
    order (EVA's ``VisionRotaryEmbeddingFast``)."""
    half = cfg.head_width // 2
    freqs = ROPE_THETA ** (-torch.arange(0, half, 2, dtype=torch.float64) / half)
    grid = cfg.grid_size
    t = torch.arange(grid, dtype=torch.float64) / grid * cfg.pt_hw_seq_len
    f = torch.outer(t, freqs).repeat_interleave(2, dim=-1)  # [grid, half], pairs interleaved
    rows = f[:, None, :].expand(grid, grid, half)
    cols = f[None, :, :].expand(grid, grid, half)
    angles = torch.cat([rows, cols], dim=-1).reshape(grid * grid, cfg.head_width)
    return (angles.cos().float().to(device), angles.sin().float().to(device))


@functools.lru_cache(maxsize=None)
def _tables(cfg: EVAConfig, device: torch.device) -> tuple:
    """``rope_tables`` made once per configuration (resolution) and device."""
    return rope_tables(cfg, device)


def layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm at eps 1e-6, computed in fp32 whatever the input type."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), LN_EPS)
    return y.to(x.dtype)


def attention_block(p: dict, x: torch.Tensor, cfg: EVAConfig, tables: tuple) -> torch.Tensor:
    """proj(inner_attn_ln(attention)) of ``x`` [B, L, D] (already norm1'd)."""
    b, length, d = x.shape
    qkv = dense(x, p["qkv"]["weight"], p["qkv"]["bias"])  # [B, L, 3D]
    q, k, v = rope_qkv(qkv, *tables, cfg.vision_heads)  # [B*H, L, dh] each, q scaled
    h, dh = cfg.vision_heads, cfg.head_width
    out = flash_attention(*(t.view(b, h, length, dh) for t in (q, k, v)), scale=1.0)
    out = out.to(x.dtype).transpose(1, 2).reshape(b, length, d)
    return dense(layer_norm(p["inner_attn_ln"], out), p["proj"]["weight"], p["proj"]["bias"])


def swiglu_block(p: dict, g: torch.Tensor, lora: Optional[dict] = None,
                 attr_mix: Optional[torch.Tensor] = None, lora_scaling: float = 0.0) -> torch.Tensor:
    """w3(ffn_ln(SiLU(w1 g) * w2 g)) with optional FairLoRA deltas on the
    three products."""
    def product(name, inp):
        y = dense(inp, p[name]["weight"], p[name]["bias"])
        if lora is not None and name in lora:
            y = y + lora_delta(lora[name], inp, attr_mix, lora_scaling)
        return y

    hidden = F.silu(product("w1", g)) * product("w2", g)
    return product("w3", layer_norm(p["ffn_ln"], hidden))


def eva_encode(visual: dict, image: torch.Tensor, cfg: EVAConfig, policy: Policy,
               return_tokens: bool = False, lora: Optional[dict] = None,
               attr_mix: Optional[torch.Tensor] = None, lora_scaling: float = 0.0) -> torch.Tensor:
    """EVA02 image encoder.  image: [B, 3, H, W].  Returns [B, embed_dim], or
    [B, 1+L, embed_dim] with the class token first when ``return_tokens``."""
    dt = policy.compute_dtype
    x = image.to(dt)
    p = cfg.vision_patch_size
    b, _, h, w = x.shape
    gh, gw = h // p, w // p
    if (gh, gw) != (cfg.grid_size, cfg.grid_size):
        raise ValueError(f"EVA02 tower of {cfg.image_resolution} px got a {h}x{w} image")
    # patch embedding: a conv with stride = kernel = p is unfold + matmul
    x = x.reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, 3 * p * p)
    x = dense(x, visual["patch_embed"]["weight"].reshape(cfg.vision_width, 3 * p * p),
              visual["patch_embed"]["bias"])
    cls = visual["cls_token"].to(dt).expand(b, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + visual["pos_embed"].to(dt)

    tables = _tables(cfg, x.device)
    blocks = visual["blocks"]
    for i in range(blocks["norm1"]["weight"].shape[0]):
        bp = layer_slice(blocks, i)
        lp = None if lora is None else layer_slice(lora, i)
        x = x + attention_block(bp["attn"], layer_norm(bp["norm1"], x), cfg, tables)
        x = x + swiglu_block(bp["mlp"], layer_norm(bp["norm2"], x), lp, attr_mix, lora_scaling)

    x = layer_norm(visual["norm"], x if return_tokens else x[:, 0, :])
    return dense(x, visual["head"]["weight"], visual["head"]["bias"])


# --------------------------------------------------------------------------- #
# initialisation
# --------------------------------------------------------------------------- #

def _ln(shape, device):
    return {"weight": torch.ones(shape, device=device), "bias": torch.zeros(shape, device=device)}


def init_eva_visual(gen: torch.Generator, cfg: EVAConfig, dtype=torch.float32,
                    device=None) -> dict:
    """Random tower drawn from ``gen`` as EVA initialises it: linears and the
    class token and positions N(0, 0.02) (EVA truncates at 2 std), biases 0,
    LayerNorms 1 / 0, each block's ``proj`` and ``w3`` divided by sqrt(2
    (layer + 1)) (``fix_init_weight``), the patch convolution N(0, 1 /
    fan_in)."""
    n, d, f, p = cfg.vision_layers, cfg.vision_width, cfg.mlp_hidden, cfg.vision_patch_size
    dev = gen.device

    def normal(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=dev) * std

    rescale = (2.0 * torch.arange(1, n + 1, dtype=torch.float32, device=dev)) ** -0.5
    zeros = lambda *s: torch.zeros(s, device=dev)
    visual = {
        "patch_embed": {"weight": normal(d, 3, p, p, std=(3 * p * p) ** -0.5), "bias": zeros(d)},
        "cls_token": normal(d),
        "pos_embed": normal(cfg.grid_size ** 2 + 1, d),
        "blocks": {
            "norm1": _ln((n, d), dev), "norm2": _ln((n, d), dev),
            "attn": {"qkv": {"weight": normal(n, 3 * d, d), "bias": zeros(n, 3 * d)},
                     "inner_attn_ln": _ln((n, d), dev),
                     "proj": {"weight": normal(n, d, d) * rescale[:, None, None],
                              "bias": zeros(n, d)}},
            "mlp": {"w1": {"weight": normal(n, f, d), "bias": zeros(n, f)},
                    "w2": {"weight": normal(n, f, d), "bias": zeros(n, f)},
                    "ffn_ln": _ln((n, f), dev),
                    "w3": {"weight": normal(n, d, f) * rescale[:, None, None],
                           "bias": zeros(n, d)}},
        },
        "norm": _ln((d,), dev),
        "head": {"weight": normal(cfg.embed_dim, d), "bias": zeros(cfg.embed_dim)},
    }
    return tree_map(lambda a: a.to(device=device, dtype=dtype), visual)
