"""Dotted-path views of nested parameter trees (the port's copy of the part
of ``fairfedmed_tpu/core/pytree.py`` it needs).

Trees are dicts and lists of tensors or arrays; a list index becomes a path
component, so a ResNet block reads ``layer1.0.bn1.weight`` as in the
reference's ``state_dict`` keys.
"""

from __future__ import annotations

from typing import Any, Mapping


def flatten_paths(tree: Any, sep: str = ".") -> dict:
    """Nested dicts / lists -> flat ``{dotted path: leaf}`` in walk order."""
    out: dict = {}

    def rec(node, prefix):
        if isinstance(node, Mapping):
            for k in node:
                rec(node[k], f"{prefix}{sep}{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{sep}{i}" if prefix else str(i))
        else:
            out[prefix] = node

    rec(tree, "")
    return out
