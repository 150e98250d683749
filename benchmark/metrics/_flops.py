"""Model FLOPs of the measured configurations, from their shapes, at 2 FLOPs
per multiply-add.  A training image counts its forward and its backward, an
evaluated image its forward; padded evaluation rows and recomputation are
not counted.  The frozen CLIP weights take no weight gradient, so the
backward of a frozen product is its input gradient alone, and only where
something trainable lies below it; an adapter's backward (input and weight
gradients) counts twice its forward.  Elementwise work (norms,
activations, softmax) and the patch-prompt scores (under 0.1% of a
forward) are not counted.

An image tower's multiply-adds and attention calls per image come from its
module (``archs/<kind>.py``: ViT-B/16 at 224 px, FairLoRA rank 12, forward
17.86e9 multiply-adds, 35.7 GFLOPs, a image, backward 17.63e9), a sample's
images and its front end's multiply-adds from the traffic's modality
(``modalities/<modality>.py``); the text tower's are here.  The attention
rooflines' calls (``attention_calls``) come from the same shapes.
"""

from __future__ import annotations

import functools

from .. import spec
from ..reference.tokenizer import tokenize


def block_macs(tokens: int, width: int, rank: int = 0) -> tuple:
    """(forward, input-gradient) multiply-adds of one pre-LN transformer block
    on ``tokens`` tokens with FairLoRA of ``rank`` on both MLP products: the
    q/k/v, output and two MLP products (12 T D^2), the scores and the
    weighted sum (2 T^2 D; their backward 4 T^2 D), and the adapters
    (T (D r + r 4D) + T (4D r + r D) = 10 T D r; backward twice that)."""
    dense = 12 * tokens * width * width
    attn = 2 * tokens * tokens * width
    lora = 10 * tokens * width * rank
    return dense + attn + lora, dense + 2 * attn + 2 * lora


@functools.lru_cache()
def text_length(classnames: tuple, n_ctx: int) -> int:
    """Positions the text tower needs: up to the last prompt's EOT token."""
    ids = tokenize([f"{' '.join(['X'] * n_ctx)} {c}." for c in classnames])
    return int(ids.argmax(-1).max()) + 1


def text_run_length(classnames: tuple, n_ctx: int, context_length: int) -> int:
    """Positions the program runs the text tower at: the needed ones rounded
    up to a multiple of 8, at least 8 and at most the context length
    (``models/clip_model.py:text_encode``): 10 needed run as 16."""
    return min(context_length, max(8, -(-text_length(classnames, n_ctx) // 8) * 8))


def text_macs(arch: dict, method: dict, classnames) -> tuple:
    """(forward, backward) multiply-adds of one pass of the text tower over
    every prompt (prompts x classes sequences of the needed length); the
    learned context sits at position 1, so every block has a backward."""
    seqs = method["num_prompt"] * len(classnames)
    length = text_length(tuple(classnames), method["n_ctx"])
    width = arch["transformer_width"]
    fwd_block, bwd_block = block_macs(length, width)
    proj = width * arch["embed_dim"]
    layers = arch["transformer_layers"]
    return seqs * (layers * fwd_block + proj), seqs * (layers * bwd_block + proj)


def sample_macs(config: dict, traffic: dict) -> tuple:
    """(forward, backward) multiply-adds of one sample through the front end
    and the image tower: the modality's images a sample, each through the
    tower, with an input gradient where the front end is trainable."""
    arch = config["arch"]
    modality = spec.load_modality(traffic["modality"])
    image = spec.load_arch(arch["kind"]).image_macs(arch, config["method"]["lora_rank"],
                                                    modality.TRAINABLE_FRONT)
    front = modality.front_macs(traffic)
    per = modality.images_per_sample(traffic)
    return front[0] + per * image[0], front[1] + per * image[1]


def round_flops(config: dict, traffic: dict, rounds: list, batch_size: int) -> float:
    """Model FLOPs of ``rounds`` (each with its clients' step counts and its
    evaluation's batches and valid rows) of samples of ``traffic``."""
    sample = sample_macs(config, traffic)
    text = text_macs(config["arch"], config["method"], traffic["classnames"])
    macs = 0
    for r in rounds:
        steps = sum(r["n_steps"])
        macs += steps * batch_size * sum(sample) + steps * sum(text)
        macs += r["eval_rows"] * sample[0] + r["eval_batches"] * text[0]
    return 2.0 * macs


ITEMSIZE = {"fp16": 2, "amp": 2, "fp32": 4}  # PREC's matmul input: bf16 on the card, or fp32


def attention_calls(config: dict, traffic: dict, rounds: list, batch_size: int,
                    eval_batch_size: int) -> list:
    """The attention calls of ``rounds`` (each with its clients' step counts
    and the batches its evaluation ran) as the configuration demands them,
    one dict a call: ``n`` (batch x heads), ``length``, ``dh``, ``causal``,
    ``itemsize`` and ``backward`` (whether its backward runs).

    A training step runs the image tower's calls (its module's
    ``attention``: one a layer, over ``batch_size`` samples times the
    modality's images a sample, each layer's backward as the module says)
    and the text tower's ``transformer_layers`` causal calls over every
    prompt (``num_prompt`` x classes sequences at :func:`text_run_length`);
    an evaluation batch runs both forward only, over ``eval_batch_size``
    samples, padding included.  The learned context enters the text tower at
    its first position, so every text call has a backward.  A tower whose
    attention is no call of the attention kernels (its module gives None)
    adds none."""
    arch, method = config["arch"], config["method"]
    itemsize = ITEMSIZE[method["prec"]]
    heads = arch["transformer_heads"]
    classnames = traffic["classnames"]
    text = {"n": method["num_prompt"] * len(classnames) * heads,
            "length": text_run_length(tuple(classnames), method["n_ctx"], arch["context_length"]),
            "dh": arch["transformer_width"] // heads, "causal": True, "itemsize": itemsize}
    modality = spec.load_modality(traffic["modality"])
    tower = spec.load_arch(arch["kind"]).attention(arch, modality.TRAINABLE_FRONT)
    per = modality.images_per_sample(traffic)
    vision = None
    if tower is not None:
        vision = {"length": tower["length"], "dh": tower["dh"], "causal": False,
                  "itemsize": itemsize}

    def forward(batch: int, backward: bool) -> list:
        calls = []
        if vision is not None:
            calls += [{**vision, "n": batch * per * tower["heads"], "backward": backward and b}
                      for b in tower["backward"]]
        return calls + [{**text, "backward": backward}] * arch["transformer_layers"]

    step, evaluation = forward(batch_size, True), forward(eval_batch_size, False)
    return [dict(c) for r in rounds
            for c in step * sum(r["n_steps"]) + evaluation * r["eval_batches_run"]]
