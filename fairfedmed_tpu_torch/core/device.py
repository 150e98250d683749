"""Device choice for the port's entry points: the GPU unless the caller asks
for the CPU, and never a silent move to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (or implied)
    and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (to the CLI: "
                           "the override USE_CUDA False) to run the port on the CPU (its "
                           "plain PyTorch paths)")
    return dev
