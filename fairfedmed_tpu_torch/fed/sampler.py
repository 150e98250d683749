"""Per-round client sampling (port of ``fairfedmed_tpu/fed/sampler.py``;
reference federated_main.py:227-228, 606-613)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def sample_clients(num_users: int, frac: float, epoch: int, all_on_first_round: bool = True,
                   idxs_users_train: Sequence[int] = ()) -> List[int]:
    """The listed training users when there are any; every client in round 0
    of the prompt methods; else ``max(int(frac * num_users), 1)`` clients
    without replacement from numpy's global stream, which the CLI seeds (so
    one seed draws the same clients here and in the JAX package)."""
    if idxs_users_train:
        return list(idxs_users_train)
    if all_on_first_round and epoch == 0:
        return list(range(num_users))
    m = max(int(frac * num_users), 1)
    return list(np.random.choice(range(num_users), m, replace=False))
