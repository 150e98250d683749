"""Pytree checkpoints in ``step_N/`` directories (port of
``fairfedmed_tpu/train/checkpoint.py``, whose Orbax directories hold the
client-parallel rounds' federated state).

A tree is nested dicts (and lists) of tensors and Python ints, written with
``torch.save`` into ``<directory>/step_N/tree.pt``.  The step directory is
written under a temporary name and then renamed into place with
``os.replace``, so a reader never sees half a checkpoint, as Orbax's rename
guarantees.  ``load_pytree`` reads with ``torch.load(weights_only=True)``;
with a template it checks that the keys, shapes and dtypes match.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Mapping, Optional

import torch

TREE_FILE = "tree.pt"


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def host_copy(tree: Any) -> Any:
    """The tree with every tensor copied to the CPU in ONE device-to-host
    transfer: the device tensors' bytes are concatenated on the device,
    fetched once and split on the host (each leaf its own storage, so
    ``torch.save`` writes no shared buffer twice)."""
    dev = [t for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
    host = {}
    if dev:
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in dev])
        buf, off = flat.cpu(), 0
        for t in dev:
            n = t.numel() * t.element_size()
            host[id(t)] = buf[off:off + n].clone().view(t.dtype).reshape(t.shape)
            off += n
    return _map(tree, lambda x: host.get(id(x), x.detach().clone())
                if isinstance(x, torch.Tensor) else x)


def save_pytree(directory: str, tree: Any, step: Optional[int] = None) -> str:
    """Write ``tree`` to ``directory/step_{step}`` (or ``directory`` itself
    when ``step`` is None), atomically; returns the checkpoint path."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}") if step is not None else directory
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    try:
        torch.save(host_copy(tree), os.path.join(tmp, TREE_FILE))
        if os.path.isdir(path):  # force=True: replace an earlier save of the same step
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def check_like(tree: Any, template: Any, where: str = "") -> None:
    """Raise ``ValueError`` unless ``tree`` has ``template``'s keys and list
    lengths, and its tensors' shapes and dtypes."""
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"checkpoint structure at {where or '<root>'}: keys {got}, "
                             f"expected {sorted(template)}")
        for k in template:
            check_like(tree[k], template[k], f"{where}.{k}" if where else str(k))
    elif isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"checkpoint structure at {where}: expected a list of "
                             f"{len(template)}")
        for i, (a, b) in enumerate(zip(tree, template)):
            check_like(a, b, f"{where}.{i}")
    elif isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor):
            raise ValueError(f"checkpoint leaf {where}: {type(tree).__name__}, expected a tensor")
        if tuple(tree.shape) != tuple(template.shape) or tree.dtype != template.dtype:
            raise ValueError(f"checkpoint leaf {where}: {tuple(tree.shape)} {tree.dtype}, "
                             f"expected {tuple(template.shape)} {template.dtype}")
    elif isinstance(tree, torch.Tensor):
        raise ValueError(f"checkpoint leaf {where}: a tensor, expected "
                         f"{type(template).__name__}")


def load_pytree(path: str, template: Any = None, device=None) -> Any:
    """Read a :func:`save_pytree` checkpoint.  With ``template`` the tree
    must have its keys, and its tensors' shapes and dtypes, or this raises
    ``ValueError``; tensors land on ``device`` (default: the template's
    leaves' devices, else the CPU)."""
    tree = torch.load(os.path.join(os.path.abspath(path), TREE_FILE), map_location="cpu",
                      weights_only=True)
    if template is not None:
        check_like(tree, template, "")
        if device is None:
            leaves = [t for t in _leaves(template) if isinstance(t, torch.Tensor)]
            device = leaves[0].device if leaves else None
    if device is None:
        return tree
    return _map(tree, lambda x: x.to(device) if isinstance(x, torch.Tensor) else x)


def _leaves(tree: Any) -> list:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def latest_step(directory: str) -> Optional[int]:
    """Highest ``step_N`` subdirectory, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None
