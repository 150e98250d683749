"""Mixed-precision policy (port of ``fairfedmed_tpu/core/precision.py``).

The reference stores CLIP weights in fp16 with fp32 LayerNorm islands and
exposes PREC in {fp16, fp32, amp}.  The port maps fp16 to bfloat16, as the
JAX package does: matmuls take bf16 inputs with fp32 accumulation; LayerNorm,
softmax and the loss stay fp32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype  # storage type of the frozen backbone weights
    compute_dtype: torch.dtype  # matmul input type
    norm_dtype: torch.dtype = torch.float32  # LayerNorm / softmax / loss type


def policy_from_prec(prec: str) -> Policy:
    """fp16 -> bf16 storage and compute; amp -> fp32 storage, bf16 compute;
    fp32 -> fp32."""
    if prec == "fp16":
        return Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    if prec == "amp":
        return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    if prec == "fp32":
        return Policy(param_dtype=torch.float32, compute_dtype=torch.float32)
    raise ValueError(f"Unknown precision {prec!r} (expected fp16/fp32/amp)")
