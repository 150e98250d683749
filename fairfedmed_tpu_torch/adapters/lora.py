"""LoRA / SVLoRA / FairLoRA adapters as functional layer transforms.

Port of ``fairfedmed_tpu/adapters/lora.py``; semantics match the reference
classes (trainers/GLP_OT_SVLoRA.py:203-500):

* ``LoRA``     -- delta = ((x A) B) * alpha/rank; A zeros-init, B ~ N(0,1).
* ``SVLoRA``   -- adds a rank-length singular-value vector S (linspace 1->0.1):
                  delta = ((x A) diag(S) B) * scaling.
* ``FairLoRA`` -- S is per demographic group ``[num_groups, rank]``; each
                  sample takes a soft blend of the group rows (0.7 on its own
                  group, the rest uniform; uniform when attr is unknown).

The per-sample diag(S) is a broadcast multiply over the rank axis.  Leaf
names keep ``lora_A/lora_S/lora_B`` so the aggregation predicates
(``'lora_S' in key``) carry over.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LORA_TYPES = ("LoRA", "SVLoRA", "FairLoRA")
LAMBDA_GROUP = 0.7  # soft one-hot weight on the sample's own group


def _s_init(rank: int, num_groups: int, init_type: str, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """Per-group singular-value init (GLP_OT_SVLoRA.py:394-417).

    ``same``        -- every group gets linspace(1, 0.1, rank).
    ``cycle_shift`` -- group g gets the linspace rolled by g*(rank//G).
    ``same+cycle``  -- [shared linspace(0.5,0.1,rank/2) | rolled copy * 0.2].
    """
    if init_type in ("same", "cycle_shift"):
        base = torch.linspace(1.0, 0.1, rank, device=device)
        if init_type == "same":
            s = base[None].repeat(num_groups, 1)
        else:
            if rank < num_groups:
                raise ValueError(f"cycle_shift needs rank >= groups ({rank} < {num_groups})")
            step = rank // num_groups
            s = torch.stack([torch.roll(base, -g * step) for g in range(num_groups)])
    else:  # 'same+cycle' (the reference default)
        if rank % 2 or rank < num_groups:
            raise ValueError(f"same+cycle needs an even rank >= groups, got {rank}/{num_groups}")
        half = rank // 2
        base = torch.linspace(0.5, 0.1, half, device=device)
        step = half // num_groups
        if step == 0:
            # the reference has the same silent degeneracy: warn, don't raise
            print(f"WARNING: FairLoRA 'same+cycle' S-init is degenerate at "
                  f"rank {rank} with {num_groups} groups (rank/2 < groups): "
                  "all groups start with identical singular values")
        cycled = torch.stack([torch.roll(base, -g * step) for g in range(num_groups)])
        s = torch.cat([base[None].repeat(num_groups, 1), cycled * 0.2], dim=1)
    return s.to(dtype)


def init_lora(gen: torch.Generator, in_features: int, out_features: int, rank: int,
              lora_type: str = "FairLoRA", num_groups: int = 1, global_s: bool = False,
              s_init: str = "same+cycle", dtype=torch.float32, device=None) -> dict:
    """One adapter's parameters on ``device``: A zeros (the delta starts at 0),
    B ~ N(0, 1) drawn from ``gen`` (nn.Embedding's default init in the
    reference)."""
    if lora_type not in LORA_TYPES:
        raise ValueError(f"lora_type must be one of {LORA_TYPES}, got {lora_type!r}")
    dev = device
    params = {
        "lora_A": torch.zeros((in_features, rank), device=dev, dtype=dtype),
        "lora_B": torch.randn((rank, out_features), generator=gen,
                              device=gen.device).to(device=dev, dtype=dtype),
    }
    if lora_type == "SVLoRA":
        params["lora_S"] = torch.linspace(1.0, 0.1, rank, device=dev).to(dtype)
    elif lora_type == "FairLoRA":
        params["lora_S"] = _s_init(rank, num_groups, s_init, dtype, dev)
    if global_s and lora_type in ("SVLoRA", "FairLoRA"):
        # [1, rank] like the reference's nn.Embedding(1, rank): a bare [rank]
        # vector would pass the group-FedAvg predicate whenever rank == groups
        params["lora_S_global"] = torch.linspace(1.0, 0.1, rank, device=dev).to(dtype)[None]
    return params


def group_mix(attr: Optional[torch.Tensor], num_groups: int, batch: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Soft one-hot over demographic groups, [batch, num_groups]: 0.7 on the
    true group, 0.3/(G-1) elsewhere; uniform 1/G when attr is None.  Carries
    no gradient (the reference builds it under no_grad)."""
    if attr is None or num_groups == 1:
        dev = device if attr is None else attr.device
        return torch.full((batch, num_groups), 1.0 / num_groups, dtype=dtype, device=dev)
    one_hot = F.one_hot(attr.long(), num_groups).to(dtype)
    mix = one_hot * LAMBDA_GROUP + (1.0 - one_hot) * (1.0 - LAMBDA_GROUP) / (num_groups - 1)
    return mix.detach()


def effective_s(lora: dict, attr_mix: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
    """Per-sample singular values [batch, rank], or None for plain LoRA.  When
    the model batch is ``num_slices`` times the attribute batch (3D volumes),
    each sample's S repeats over its slices."""
    if "lora_S" not in lora:
        return None
    s = lora["lora_S"]
    if s.dim() == 1:  # SVLoRA: one shared vector
        s = s[None].expand(batch, -1)
    else:  # FairLoRA: [G, r] blended by the per-sample soft one-hot
        if attr_mix is None:
            raise ValueError("FairLoRA requires a group mix")
        s = attr_mix.to(s.dtype) @ s  # [B_attr, r]
        if s.shape[0] != batch:
            s = s.repeat_interleave(batch // s.shape[0], dim=0)
    if "lora_S_global" in lora:
        # the global singular values add to the per-sample ones (the intended
        # semantics of the reference's degenerate diag of a [1, r] matrix)
        s = s + lora["lora_S_global"].reshape(1, -1).to(s.dtype)
    return s


def lora_delta(lora: dict, x: torch.Tensor, attr_mix: Optional[torch.Tensor],
               scaling: float) -> torch.Tensor:
    """Adapter output delta for ``x`` of shape [batch, ..., in_features]."""
    a = lora["lora_A"].to(x.dtype)
    b = lora["lora_B"].to(x.dtype)
    h = x @ a  # [batch, ..., r]
    s = effective_s(lora, attr_mix, x.shape[0])
    if s is not None:
        h = h * s.to(x.dtype).reshape(s.shape[0], *([1] * (x.dim() - 2)), s.shape[-1])
    return (h @ b) * scaling
