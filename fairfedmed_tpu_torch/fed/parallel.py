"""Aggregation over stacked clients for the client-parallel rounds.

Port of the tree helpers of ``fairfedmed_tpu/fed/parallel.py`` that the
round runner (``fed/parallel_driver.py``) needs.  A client state here is a
flat ``{dotted path: tensor}`` dict (``core.pytree.flatten_paths``), and a
stacked state holds each leaf with a leading client axis.  The JAX package
runs these as one SPMD program over a device mesh; on one card they are
plain PyTorch over the stacked tensors.  Sums run in fp32; the results
that replace parameters are cast back to the parameter's type.

The ``lora_S`` predicates are the reference's (utils/fed_utils.py:18-40,
90-96): a leaf whose path names ``lora_S`` and whose second-to-last axis
is the number of demographic groups averages per group and shares the first
half of its singular values across groups.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _is_group_s(path: str, x: torch.Tensor, num_groups: int, min_dim: int) -> bool:
    return "lora_S" in path and x.dim() >= min_dim and x.shape[-2] == num_groups


def stack_clients(states: Sequence[dict]) -> dict:
    """Per-client flat states -> one state with a leading client axis."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def client_weighted_mean(stacked: dict, weights: torch.Tensor,
                         group_weights: Optional[torch.Tensor], num_groups: int) -> dict:
    """The FedAvg of stacked clients in fp32 (JAX parallel.py:36-52 and the
    runner's ``wmean``): ``sum_j weights[j] * x_j``, and for a group ``lora_S``
    leaf [m, ..., G, r] ``sum_j group_weights[j, g] * x_j[..., g, :]`` when
    ``group_weights`` [m, G] is given."""
    out = {}
    for path, x in stacked.items():
        x32 = x.float()
        if group_weights is not None and _is_group_s(path, x, num_groups, 3):
            w = group_weights.reshape((x.shape[0],) + (1,) * (x.dim() - 3) + (num_groups, 1))
        else:
            w = weights.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        out[path] = (x32 * w).sum(0)
    return out


def apply_shared_half_s(state: dict, num_groups: int) -> dict:
    """The first half of every group's singular values <- their mean over
    the groups (fed_utils.py:90-96), for leaves [..., G, rank]."""
    out = {}
    for path, x in state.items():
        if _is_group_s(path, x, num_groups, 2):
            half = x.shape[-1] // 2
            head = x[..., :half].mean(dim=-2, keepdim=True).expand_as(x[..., :half])
            x = torch.cat([head, x[..., half:]], dim=-1)
        out[path] = x
    return out


def ema_blend(avg: dict, global_state: dict, beta_decay: float) -> dict:
    """``(1 - beta) * avg + beta * global`` in fp32, cast to the global
    leaf's type (fed_utils.py:88)."""
    return {k: ((1.0 - beta_decay) * a.float() + beta_decay * global_state[k].float())
            .to(global_state[k].dtype) for k, a in avg.items()}


def personalize(new_global: dict, local: dict, avg_prompt: int, local_s: bool) -> dict:
    """Stacked clients' states after aggregation (federated_main.py:645-652):
    the global prompt rows ``[:avg_prompt]``, each client's own rows after
    them, and its own ``lora_S`` when ``local_s``; everything else global.
    ``new_global`` is one state, given to every client, or a stacked one;
    the result takes ``local``'s types."""
    out = {}
    for path, loc in local.items():
        g = new_global[path].to(loc.dtype).expand_as(loc)
        if path.endswith("prompt_learner.ctx"):
            out[path] = torch.cat([g[:, :avg_prompt], loc[:, avg_prompt:]], dim=1)
        elif local_s and "lora_S" in path:
            out[path] = loc
        else:
            out[path] = g
    return out
