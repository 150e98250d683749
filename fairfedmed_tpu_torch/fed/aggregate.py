"""Federated aggregation operators (the port's own copy of
``fairfedmed_tpu/fed/aggregate.py``; host numpy only).

Numerically matches utils/fed_utils.py:

* :func:`average_weights` — FedAvg weighted by client example counts, with
  per-demographic-group weighting for any leaf whose path contains ``lora_S``
  and whose leading dim equals the number of groups (fed_utils.py:6-40).
* :func:`average_weights_ema` — same average, then EMA towards the previous
  global weights with round-GROWING decay β·epoch/max_epoch (fed_utils.py:88 —
  a reference quirk we reproduce), plus optional ``shared_half_s``: the first
  half of each group's singular-value vector is replaced by the cross-group
  mean (fed_utils.py:90-96).

Weights are dotted-path → array dicts (the trainers' ``state_dict()``), so
the same predicates the reference applies to torch ``state_dict`` keys apply
here.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np


def _freqs(idxs_users, datanumber_client, datanumber_client_by_attr):
    total = sum(datanumber_client[r] for r in idxs_users)
    freqs = {r: datanumber_client[r] / total for r in idxs_users}
    freqs_by_attr = None
    if datanumber_client_by_attr is not None:
        by_attr = np.asarray(datanumber_client_by_attr, dtype=np.float64)
        sel = list(idxs_users)
        total_by_attr = by_attr[sel].sum(0)
        # a demographic group with ZERO members among the selected clients
        # would divide 0/0 — the reference NaNs here (fed_utils.py:29-38,
        # latent because full FairFedMed sites cover every group, but any
        # frac-sampled round can trigger it and shared_half_s then spreads
        # the NaN across all groups' S).  Substitute uniform client weights
        # for such groups: a plain average of the clients' current rows.
        safe_total = np.where(total_by_attr > 0, total_by_attr, 1.0)
        uniform = 1.0 / len(sel)
        freqs_by_attr = {
            r: np.where(total_by_attr > 0, by_attr[r] / safe_total, uniform)
            for r in idxs_users}
    return freqs, freqs_by_attr


def _is_group_s(key: str, arr, freqs_by_attr) -> bool:
    return (
        freqs_by_attr is not None
        and "lora_S" in key
        and arr.shape[0] == len(next(iter(freqs_by_attr.values())))
    )


def average_weights(
    w: Sequence,
    idxs_users: Sequence[int],
    datanumber_client: Sequence[int],
    datanumber_client_by_attr: Optional[Sequence[Sequence[int]]] = None,
    islist: bool = False,
    _freqs_pair=None,
) -> dict:
    """FedAvg over the selected clients' flat weight dicts.

    ``islist=True`` averages bare arrays instead of dicts (the FedOTP global
    prompt slice path, fed_utils.py:21-26).  ``_freqs_pair`` lets
    average_weights_ema share its already-computed (freqs, freqs_by_attr) so
    the two passes can never classify lora_S leaves differently."""
    freqs, freqs_by_attr = (_freqs_pair if _freqs_pair is not None else
                            _freqs(idxs_users, datanumber_client,
                                   datanumber_client_by_attr))
    if islist:
        acc = np.zeros_like(np.asarray(w[idxs_users[0]], dtype=np.float32))
        for r in idxs_users:
            acc = acc + np.asarray(w[r], dtype=np.float32) * np.float32(freqs[r])
        return acc.astype(np.asarray(w[idxs_users[0]]).dtype)
    first = idxs_users[0]
    out = {}
    for key, arr0 in w[first].items():
        if _is_group_s(key, arr0, freqs_by_attr):
            acc = np.zeros_like(np.asarray(arr0, dtype=np.float32))
            for r in idxs_users:
                wk = np.asarray(w[r][key], dtype=np.float32)
                acc = acc + wk * freqs_by_attr[r][:, None].astype(np.float32)
        else:
            acc = np.zeros_like(np.asarray(arr0, dtype=np.float32))
            for r in idxs_users:
                acc = acc + np.asarray(w[r][key], dtype=np.float32) * np.float32(freqs[r])
        out[key] = acc.astype(np.asarray(arr0).dtype)
    return out


def shared_half_s_transform(s: np.ndarray) -> np.ndarray:
    """Replace the first half of every group's S row by the cross-group mean."""
    n_groups, n_dim = s.shape
    head = s[:, : n_dim // 2].mean(0, keepdims=True)
    return np.concatenate([np.tile(head, (n_groups, 1)), s[:, n_dim // 2 :]], axis=1)


def average_weights_ema(
    w_g: Mapping[str, np.ndarray],
    w: Sequence[Mapping[str, np.ndarray]],
    idxs_users: Sequence[int],
    datanumber_client: Sequence[int],
    datanumber_client_by_attr: Optional[Sequence[Sequence[int]]],
    epoch: int,
    max_epoch: int,
    beta: float = 0.999,
    shared_half_s: bool = False,
) -> dict:
    """Weighted average + EMA toward previous global weights.

    β_d = β·epoch/max(max_epoch, 1): decay grows with the round index, so early
    rounds take the fresh average and late rounds trust the global EMA.
    """
    pair = _freqs(idxs_users, datanumber_client, datanumber_client_by_attr)
    avg = average_weights(w, idxs_users, datanumber_client,
                          datanumber_client_by_attr, _freqs_pair=pair)
    freqs_by_attr = pair[1]
    beta_decay = beta * (epoch / max(max_epoch, 1))
    out = {}
    for key, a in avg.items():
        a32 = np.asarray(a, dtype=np.float32)
        if shared_half_s and _is_group_s(key, a32, freqs_by_attr):
            a32 = shared_half_s_transform(a32)
        g = np.asarray(w_g[key], dtype=np.float32)
        out[key] = ((1.0 - beta_decay) * a32 + beta_decay * g).astype(np.asarray(a).dtype)
    return out


def fedprox_penalty(params_flat: Mapping, global_flat: Mapping, mu: float):
    """FedProx proximal term (μ/2)·‖w − w_global‖² (trainers/promptfl.py:290-293).

    Host-side helper, as in the JAX package.
    """
    sq = 0.0
    for k, v in params_flat.items():
        d = np.asarray(v, np.float32) - np.asarray(global_flat[k], np.float32)
        sq += float((d * d).sum())
    return 0.5 * mu * sq
