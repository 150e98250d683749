"""Misc utilities: seeding, dirs, simple ASCII tables.

The port's own copy of the JAX package's ``utils/tools.py`` (Dassl's
set_random_seed and mkdir_if_missing, utils/fed_utils.py:103-114's
count_parameters) without the prettytable dependency.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's global and torch's default generators.  The
    loaders shuffle and the CLI picks clients from numpy's global stream, as
    in the JAX package, so one seed gives the same batches in both."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_if_missing(dirname: str) -> None:
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname, exist_ok=True)


def ascii_table(headers, rows) -> str:
    """Minimal PrettyTable-style renderer for param-count tables."""
    cols = [list(map(str, col)) for col in zip(headers, *rows)] if rows else [[str(h)] for h in headers]
    widths = [max(len(c) for c in col) for col in cols]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(row):
        return "| " + " | ".join(str(x).ljust(w) for x, w in zip(row, widths)) + " |"

    lines = [sep, fmt(headers), sep]
    lines += [fmt(r) for r in rows]
    lines.append(sep)
    return "\n".join(lines)


def count_parameters(params: dict, name_filter: str) -> int:
    """Print a table of parameter counts whose path contains ``name_filter``.

    ``params`` is a flat dict of path -> array or tensor (the trainer's
    ``named_parameters()``).  Mirrors utils/fed_utils.py:103-114.
    """
    rows = []
    total = 0
    for path, arr in params.items():
        if name_filter in path:
            n = int(np.prod(arr.shape)) if hasattr(arr, "shape") else 1
            rows.append((path, n))
            total += n
    print(ascii_table(["Modules", "Parameters"], rows))
    print(f"Total Trainable Params: {total}")
    return total
