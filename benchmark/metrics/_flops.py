"""Model FLOPs of the measured configurations, from their shapes, at 2 FLOPs
per multiply-add.  A training image counts its forward and its backward, an
evaluated image its forward; padded evaluation rows and recomputation are
not counted.  The frozen CLIP weights take no weight gradient, so the
backward of a frozen product is its input gradient alone, and only where
something trainable lies below it; an adapter's backward (input and weight
gradients) counts twice its forward.  Elementwise work (norms,
activations, softmax) and the patch-prompt scores (under 0.1% of a
forward) are not counted.

ViT-B/16 at 224 px, FairLoRA rank 12 (T = 197 tokens, D = 768, 12 layers,
embed 512): forward 17.86e9 multiply-adds (35.7 GFLOPs) a image, backward
17.64e9; RN50 at 224 px, rank 32: see ``resnet_macs``.
"""

from __future__ import annotations

import functools

from ..reference.tokenizer import tokenize


def _block_macs(tokens: int, width: int, rank: int = 0) -> tuple:
    """(forward, input-gradient) multiply-adds of one pre-LN transformer block
    on ``tokens`` tokens with FairLoRA of ``rank`` on both MLP products: the
    q/k/v, output and two MLP products (12 T D^2), the scores and the
    weighted sum (2 T^2 D; their backward 4 T^2 D), and the adapters
    (T (D r + r 4D) + T (4D r + r D) = 10 T D r; backward twice that)."""
    dense = 12 * tokens * width * width
    attn = 2 * tokens * tokens * width
    lora = 10 * tokens * width * rank
    return dense + attn + lora, dense + 2 * attn + 2 * lora


def vit_macs(arch: dict, rank: int) -> tuple:
    """(forward, backward) multiply-adds of one image through the ViT tower
    with its adapters.  The patch embedding and layer 0's attention see no
    trainable input, so they have no backward; layer 0's MLP backward needs
    only the c_proj input gradient (4 T D^2) and its adapters' (c_fc's
    without an input gradient: 9 T D r; c_proj's: 10 T D r)."""
    width, grid = arch["vision_width"], arch["image_resolution"] // arch["vision_patch_size"]
    tokens = grid * grid + 1
    patch = grid * grid * width * 3 * arch["vision_patch_size"] ** 2
    proj = tokens * width * arch["embed_dim"]
    fwd_block, bwd_block = _block_macs(tokens, width, rank)
    layers = arch["vision_layers"]
    fwd = patch + layers * fwd_block + proj
    bwd = (layers - 1) * bwd_block + 4 * tokens * width * width \
        + 19 * tokens * width * rank + proj
    return fwd, bwd


def resnet_macs(arch: dict, rank: int) -> tuple:
    """(forward, backward) multiply-adds of one image through CLIP's
    ModifiedResNet (3-conv stem, anti-aliased bottlenecks, attention pool
    over every token) with FairLoRA on each bottleneck's 1x1 convolutions and
    plain LoRA on the pool's four projections.  Every BatchNorm is trainable,
    so every convolution but the stem's first has an input gradient."""
    width, res = arch["vision_width"], arch["image_resolution"]
    fwd = bwd = 0
    h = res // 2
    stem = [(3, width // 2), (width // 2, width // 2), (width // 2, width)]
    for i, (cin, cout) in enumerate(stem):
        m = h * h * cout * cin * 9
        fwd += m
        bwd += m if i else 0
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


@functools.lru_cache()
def text_length(classnames: tuple, n_ctx: int) -> int:
    """Positions the text tower needs: up to the last prompt's EOT token."""
    ids = tokenize([f"{' '.join(['X'] * n_ctx)} {c}." for c in classnames])
    return int(ids.argmax(-1).max()) + 1


def text_macs(arch: dict, method: dict, classnames) -> tuple:
    """(forward, backward) multiply-adds of one pass of the text tower over
    every prompt (prompts x classes sequences of the needed length); the
    learned context sits at position 1, so every block has a backward."""
    seqs = method["num_prompt"] * len(classnames)
    length = text_length(tuple(classnames), method["n_ctx"])
    width = arch["transformer_width"]
    fwd_block, bwd_block = _block_macs(length, width)
    proj = width * arch["embed_dim"]
    layers = arch["transformer_layers"]
    return seqs * (layers * fwd_block + proj), seqs * (layers * bwd_block + proj)


def round_flops(config: dict, classnames, rounds: list, batch_size: int) -> float:
    """Model FLOPs of ``rounds`` (each with its clients' step counts and its
    evaluation's batches and valid rows)."""
    arch, method = config["arch"], config["method"]
    image = (vit_macs if arch["kind"] == "vit" else resnet_macs)(arch, method["lora_rank"])
    text = text_macs(arch, method, classnames)
    macs = 0
    for r in rounds:
        steps = sum(r["n_steps"])
        macs += steps * batch_size * sum(image) + steps * sum(text)
        macs += r["eval_rows"] * image[0] + r["eval_batches"] * text[0]
    return 2.0 * macs
