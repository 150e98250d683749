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


def unflatten_like(template: Any, flat: Mapping, sep: str = ".", prefix: str = "") -> Any:
    """``flatten_paths`` inverted onto ``template``'s dicts and lists: the
    same structure, each leaf taken from ``flat`` by its dotted path."""
    if isinstance(template, Mapping):
        return {k: unflatten_like(v, flat, sep, f"{prefix}{sep}{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten_like(v, flat, sep, f"{prefix}{sep}{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    return flat[prefix]
