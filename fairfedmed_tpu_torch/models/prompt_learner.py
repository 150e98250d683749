"""Multi-prompt CoOp-style prompt learner.

Port of ``fairfedmed_tpu/models/prompt_learner.py`` (reference PromptLearner,
trainers/GLP_OT_SVLoRA.py:68-200): a learnable context bank ``ctx`` of shape
[N_prompts, n_ctx, ctx_dim] (init N(0, 0.02^2)), spliced between the frozen
SOS prefix and the class-name + EOS suffix embeddings into N*n_cls prompts.
Class-token position end/middle/front and class-specific contexts (CSC).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..utils.profiling import stamp
from . import tokenizer as tk
from .clip_model import CLIPConfig


@dataclasses.dataclass
class PromptState:
    token_prefix: torch.Tensor      # [N*n_cls, 1, dim] SOS embedding
    token_suffix: torch.Tensor      # [N*n_cls, 77-1-n_ctx, dim] class, EOS, pad
    tokenized_prompts: np.ndarray   # [N*n_cls, 77] int32 (host)
    eot_indices: np.ndarray         # [N*n_cls] EOT positions (host)
    name_lens: List[int]
    n_cls: int
    n_ctx: int
    n_prompts: int
    class_token_position: str
    csc: bool = False  # class-specific contexts (ctx is [n_cls, n_ctx, dim])


def init_prompt_learner(gen: torch.Generator, classnames: Sequence[str],
                        token_embedding: torch.Tensor, cfg_clip: CLIPConfig, n_ctx: int = 4,
                        n_prompts: int = 2, ctx_init=False, csc: bool = False,
                        class_token_position: str = "end", dtype=torch.float32):
    """Returns (params {'ctx': ...}, PromptState), on ``token_embedding``'s
    device; the context draws come from ``gen`` (on any device)."""
    classnames = [name.replace("_", " ") for name in classnames]
    n_cls = len(classnames)
    ctx_dim = token_embedding.shape[1]
    dev = token_embedding.device
    tok = tk.get_tokenizer()
    stamp("prompt_learner:tokenizer_ready")

    def rows(ids: np.ndarray) -> torch.Tensor:
        out = token_embedding[torch.as_tensor(ids, device=dev).long()]
        stamp("prompt_learner:gather_dispatched")
        out = out.float()
        stamp("prompt_learner:rows_fetched")
        return out

    if ctx_init:
        words = str(ctx_init).replace("_", " ")
        emb = rows(tk.tokenize(words)[0])
        n_ctx = len(tok.encode(words))
        ctx_vectors = emb[1 : 1 + n_ctx].to(dtype)[None].repeat(n_prompts, 1, 1)
        prompt_prefix = words
    else:
        shape = (n_cls, n_ctx, ctx_dim) if csc else (n_prompts, n_ctx, ctx_dim)
        ctx_vectors = (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)
        prompt_prefix = " ".join(["X"] * n_ctx)

    name_lens = [len(tok.encode(name)) for name in classnames]
    prompts = [f"{prompt_prefix} {name}." for name in classnames]
    tokenized = tk.tokenize(prompts)  # [n_cls, 77]

    embedding = rows(tokenized).repeat(n_prompts, 1, 1)  # [N*n_cls, 77, dim]
    tokenized = np.tile(tokenized, (n_prompts, 1))
    state = PromptState(
        token_prefix=embedding[:, :1].to(dtype),
        token_suffix=embedding[:, 1 + n_ctx :].to(dtype),
        tokenized_prompts=tokenized,
        eot_indices=tokenized.argmax(-1),
        name_lens=name_lens,
        csc=bool(csc) and not ctx_init,
        n_cls=n_cls,
        n_ctx=n_ctx,
        n_prompts=n_prompts,
        class_token_position=class_token_position,
    )
    return {"ctx": ctx_vectors.to(dev)}, state


def assemble_prompts(ctx: torch.Tensor, state: PromptState) -> torch.Tensor:
    """ctx [N, n_ctx, dim] (or [n_cls, n_ctx, dim] with CSC) -> [N*n_cls, 77, dim]."""
    n_cls, n_ctx, n = state.n_cls, state.n_ctx, state.n_prompts
    if not state.csc:
        # [N, n_ctx, d] -> [N, n_cls, n_ctx, d] -> [N*n_cls, n_ctx, d]
        ctx = ctx[:, None].expand(n, n_cls, n_ctx, ctx.shape[-1]).reshape(n * n_cls, n_ctx, -1)
    else:  # CSC: [n_cls, n_ctx, d] tiled across the prompt bank
        ctx = ctx.repeat(n, 1, 1)

    prefix = state.token_prefix.to(ctx.dtype)
    suffix = state.token_suffix.to(ctx.dtype)
    if state.class_token_position == "end":
        return torch.cat([prefix, ctx, suffix], dim=1)

    rows = []
    half = n_ctx // 2
    for row in range(n * n_cls):
        name_len = state.name_lens[row % n_cls]
        pre = prefix[row : row + 1]
        cls_toks = suffix[row : row + 1, :name_len]
        rest = suffix[row : row + 1, name_len:]
        c = ctx[row : row + 1]
        if state.class_token_position == "middle":
            parts = [pre, c[:, :half], cls_toks, c[:, half:], rest]
        elif state.class_token_position == "front":
            parts = [pre, cls_toks, c, rest]
        else:
            raise ValueError(state.class_token_position)
        rows.append(torch.cat(parts, dim=1))
    return torch.cat(rows, dim=0)
