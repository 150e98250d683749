"""Pairwise distance matrices (Dassl metrics API; port of
``fairfedmed_tpu/evaluation/distance.py``, reference
``Dassl/dassl/metrics/distance.py:1-77``)."""

from __future__ import annotations

import torch


def compute_distance_matrix(input1: torch.Tensor, input2: torch.Tensor,
                            metric: str = "euclidean") -> torch.Tensor:
    """``[m, n]`` distances between the rows of ``[m, d]`` ``input1`` and
    ``[n, d]`` ``input2``; ``metric`` is ``"euclidean"`` (squared) or
    ``"cosine"``."""
    input1, input2 = torch.as_tensor(input1), torch.as_tensor(input2)
    if input1.dim() != 2:
        raise ValueError(f"Expected 2-D tensor, but got {input1.dim()}-D")
    if input2.dim() != 2:
        raise ValueError(f"Expected 2-D tensor, but got {input2.dim()}-D")
    if input1.shape[1] != input2.shape[1]:
        raise ValueError(f"feature dims differ: {input1.shape[1]} vs {input2.shape[1]}")
    if metric == "euclidean":
        return euclidean_squared_distance(input1, input2)
    if metric == "cosine":
        return cosine_distance(input1, input2)
    raise ValueError(f"Unknown distance metric: {metric}. "
                     'Please choose either "euclidean" or "cosine"')


def euclidean_squared_distance(input1: torch.Tensor, input2: torch.Tensor) -> torch.Tensor:
    """``||x_i - y_j||^2`` as ``||x||^2 + ||y||^2 - 2 x.y^T``."""
    sq1 = (input1 ** 2).sum(1, keepdim=True)
    sq2 = (input2 ** 2).sum(1, keepdim=True).T
    return sq1 + sq2 - 2.0 * input1 @ input2.T


def cosine_distance(input1: torch.Tensor, input2: torch.Tensor) -> torch.Tensor:
    """``1 - cos(x_i, y_j)``, the norms clamped at 1e-12 as ``F.normalize``
    clamps them."""
    n1 = input1 / input1.norm(dim=1, keepdim=True).clamp_min(1e-12)
    n2 = input2 / input2.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return 1.0 - n1 @ n2.T
