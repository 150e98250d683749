"""Carry parameters across from the JAX package's layout.

The port keeps the JAX package's parameter tree (nested dicts, torch-
convention ``[out, in]`` weights, layer-stacked blocks), so its frozen CLIP
parameters, fetched to host as numpy arrays, convert leaf for leaf.  The
trainable state crosses through the reference-keyed ``state_dict()`` /
``load_state_dict()`` format that both trainers share.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_numpy(tree, device, dtype=torch.float32):
    """Nested dict of numpy arrays -> the same tree of tensors on ``device``
    in ``dtype``; ``logit_scale`` stays fp32, as the loss math reads it."""
    def conv(path, node):
        if isinstance(node, Mapping):
            return {k: conv(f"{path}.{k}" if path else str(k), v) for k, v in node.items()}
        leaf_dtype = torch.float32 if path == "logit_scale" else dtype
        return torch.tensor(np.asarray(node, dtype=np.float32), device=device, dtype=leaf_dtype)

    return conv("", tree)
