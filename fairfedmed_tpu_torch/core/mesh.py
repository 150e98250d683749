"""The (clients x data) rank grid of a round over several ranks (the port's
own copy of ``fairfedmed_tpu/core/mesh.py`` with the runner's rule of JAX
``fed/parallel_driver.py:142-159``).

The JAX package lays clients out on a ``clients`` mesh axis and splits each
client's batch over an inner ``data`` axis.  The port does the same with
ranks: ``c`` client shards of ``d`` ranks each, shard ``i`` training the
contiguous client rows of ``P(CLIENT_AXIS)`` and data index ``j`` the
contiguous batch rows of ``P(CLIENT_AXIS, None, DATA_AXIS)``.  Ranks past
``c * d`` are idle in the round.  The ``d`` ranks of a shard sum their
gradients over the shard's process group (``data_group``); the ``c`` ranks of
a data index are the client axis (``client_group``), over which
``fed.parallel.make_parallel_round`` aggregates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch.distributed as dist

CLIENT_AXIS = "clients"
DATA_AXIS = "data"

_GROUPS = {}  # (default group, c, d) -> (data-row groups, client-column groups)


def mesh_shape(num_clients: int, world: int, batch_size: Optional[int] = None,
               data_axis_ok: bool = True) -> tuple:
    """``(c, d)`` for ``num_clients`` clients over ``world`` ranks: ``c =
    min(num_clients, world)``, lowered until it divides both; ``d = world //
    c``, 1 without a data axis, then lowered until it divides the batch."""
    c = min(num_clients, world)
    while c > 1 and (world % c != 0 or num_clients % c != 0):
        c -= 1
    d = world // c
    if not data_axis_ok:
        d = 1  # e.g. ResNet BatchNorm: the batch statistics must span the batch
    while batch_size is not None and d > 1 and batch_size % d != 0:
        d -= 1
    return c, d


@dataclass(frozen=True)
class RankMesh:
    """One round's layout.  ``ranks`` is the ``[c, d]`` grid; ``coord`` this
    rank's ``(client shard, data index)``, None when it is idle."""

    num_clients: int
    batch_size: Optional[int]
    ranks: np.ndarray
    coord: Optional[tuple]
    data_group: object = None
    client_group: object = None

    @property
    def c(self) -> int:
        return self.ranks.shape[0]

    @property
    def d(self) -> int:
        return self.ranks.shape[1]

    @property
    def per_shard(self) -> int:
        return self.num_clients // self.c

    def client_rows(self, shard: int) -> range:
        """The round positions of shard ``shard``'s clients."""
        k = self.per_shard
        return range(shard * k, (shard + 1) * k)

    def batch_rows(self, index: int) -> slice:
        """The batch rows of data index ``index``."""
        b = self.batch_size // self.d
        return slice(index * b, (index + 1) * b)

    @property
    def own_clients(self) -> range:
        """This rank's client positions (none when idle)."""
        return range(0) if self.coord is None else self.client_rows(self.coord[0])


def build_mesh(num_clients: int, world: int, batch_size: Optional[int] = None,
               data_axis_ok: bool = True, rank: int = 0) -> RankMesh:
    """The :class:`RankMesh` of a round (see :func:`mesh_shape`).  Inside an
    initialised process group every rank must call it for the same layouts
    in the same order: the first call for a ``(c, d)`` creates every group
    of that layout on every rank, the ones it is not in too, and later calls
    reuse them."""
    c, d = mesh_shape(num_clients, world, batch_size, data_axis_ok)
    ranks = np.arange(c * d).reshape(c, d)
    coord = (rank // d, rank % d) if rank < c * d else None
    data_group = client_group = None
    if dist.is_available() and dist.is_initialized() and world > 1:
        key = (dist.group.WORLD, c, d)
        if key not in _GROUPS:
            rows = [dist.new_group([int(r) for r in ranks[i]]) for i in range(c)] if d > 1 else []
            # a client column spanning every rank is the default group
            cols = ([dist.new_group([int(r) for r in ranks[:, j]]) for j in range(d)]
                    if c > 1 and (d > 1 or c < world) else [])
            _GROUPS[key] = (rows, cols)
        rows, cols = _GROUPS[key]
        if coord is not None:
            data_group = rows[coord[0]] if rows else None
            if c > 1:
                client_group = cols[coord[1]] if cols else dist.group.WORLD
    return RankMesh(num_clients, batch_size, ranks, coord, data_group, client_group)
