"""Process-group helpers for rounds over several ranks (the port's own copy
of ``fairfedmed_tpu/fed/dist.py``).

The JAX package runs one controller process per host and addresses every
device of the host from it; the port runs one process per card, as
``torchrun`` starts them (``python -m torch.distributed.run --nproc_per_node
N``), and joins them in a ``torch.distributed`` process group: ``nccl`` over
cards, ``gloo`` over CPU processes.  Every helper answers as one process does
(world 1, rank 0, main) when no group is initialised.

The JAX module's sharding helpers have rank-group counterparts here:
``data_parallel_sharding(mesh)`` becomes ``core.mesh.RankMesh.data_group``
(the group a client's batch is split over, whose gradients are summed) and
``replicated_sharding`` is the state every rank keeps whole;
``make_data_parallel_mesh(n)`` is ``core.mesh.build_mesh(1, n, ...)`` (one
client over ``n`` ranks).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# a collective that waits longer fails: a rank that diverged raises instead
# of hanging (long enough for rank 0's evaluation on the host path, which
# the other ranks wait out at the next round's first collective)
TIMEOUT = datetime.timedelta(minutes=30)

_owned = False  # whether init_from_env created the default group


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    """This rank's index on its machine (``LOCAL_RANK`` under torchrun)."""
    return int(os.environ.get("LOCAL_RANK", get_rank())) if is_initialized() else 0


def get_local_size() -> int:
    """Ranks on this machine (``LOCAL_WORLD_SIZE`` under torchrun)."""
    if not is_initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", get_world_size()))


def get_local_device_count() -> int:
    """Devices this process drives: one card (or the CPU) per rank."""
    return 1


def get_global_device_count() -> int:
    """Devices of the whole group, one per rank."""
    return get_world_size()


def is_main_process() -> bool:
    return get_rank() == 0


def backend() -> str | None:
    return dist.get_backend() if is_initialized() else None


def init_from_env(device) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes and
    return the device this rank runs on.

    * A group already initialised (by the caller) is adopted as it is, with
      its backend; ``device`` is returned unchanged.
    * ``WORLD_SIZE > 1``: ``init_process_group`` over ``env://`` with ``nccl``
      for a ``cuda`` device, which becomes ``cuda:<LOCAL_RANK>``, or ``gloo``
      for the CPU, with the finite ``TIMEOUT``.  Raises when
      ``LOCAL_WORLD_SIZE`` exceeds the visible cards.
    * Otherwise one process: ``device`` unchanged.
    """
    global _owned
    device = torch.device(device)
    if is_initialized():
        return device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    if device.type == "cuda":
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        visible = torch.cuda.device_count()
        if local_size > visible:
            raise RuntimeError(f"{local_size} ranks on this machine but {visible} visible CUDA "
                               "devices: NCCL needs one card per rank (run the ranks on the CPU "
                               "with the override USE_CUDA False)")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", timeout=TIMEOUT)
    else:
        dist.init_process_group("gloo", timeout=TIMEOUT)
    _owned = True
    return device


def shutdown() -> None:
    """Destroy the default group if :func:`init_from_env` created it."""
    global _owned
    if _owned and is_initialized():
        dist.destroy_process_group()
    _owned = False


def all_reduce_sum(tensors, group) -> list:
    """``tensors`` summed over ``group`` in ONE collective: joined into an
    fp32 buffer, reduced, split and cast back to each tensor's type.  The
    identity for ``group`` None (a group of one).  Keeps autograd out:
    callers reduce detached tensors."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].reshape(t.shape).to(t.dtype))
        offset += t.numel()
    return out
