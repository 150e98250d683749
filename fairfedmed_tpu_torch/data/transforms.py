"""Input transforms: the head of the JAX package's ``build_transform``
(data/transforms.py:241-252) and the on-device preprocessing of the
in-memory datasets.

The medical datasets take no host transform: their normalisation runs inside
the model's forward, as in the reference (GLP_OT_SVLoRA.py:677-693).  Nor do
CIFAR-10/100: their uint8 NHWC batches are normalised and resized inside the
trainers' step (:class:`CifarPreprocess`, JAX glp_ot.py:295-303 and
promptfl.py:87-94).  The host pipelines of the other datasets are not ported
yet (ROADMAP M14b).
"""

from __future__ import annotations

import numpy as np
import torch

MEDICAL_DATASETS = {"FairFedMed", "FedChexMimic", "WangGrant"}
IN_MEMORY_DATASETS = {"Cifar10", "Cifar100"}


def build_transform(cfg, is_train: bool = True):
    """None for the medical and in-memory datasets and under
    ``INPUT.NO_TRANSFORM``; the other datasets' transforms raise."""
    if cfg.INPUT.NO_TRANSFORM or cfg.DATASET.NAME in MEDICAL_DATASETS | IN_MEMORY_DATASETS:
        return None
    raise NotImplementedError(
        f"host transforms for {cfg.DATASET.NAME!r} are not ported yet (ROADMAP M14b)")


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` fp32 weights of ``jax.image.resize(...,
    method="bilinear")`` along one axis (jax/_src/image/scale.py
    ``compute_weight_mat``, translation 0, antialias on): the triangle
    kernel at half-pixel sample positions, widened by the scale when
    downsampling, each output's weights normalised to sum 1 and zero where
    the sample falls outside the input.  Upsampling gives
    ``F.interpolate(mode="bilinear", align_corners=False)``'s taps."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def device_preprocess(cfg, device):
    """The trainers' on-device preprocessing of ``cfg``'s dataset: a
    :class:`CifarPreprocess` for CIFAR-10/100, None for the medical
    datasets, which the trainers normalise themselves."""
    if cfg.DATASET.NAME not in IN_MEMORY_DATASETS:
        return None
    size = cfg.INPUT.SIZE[0] if not isinstance(cfg.INPUT.SIZE, str) else 224
    return CifarPreprocess(cfg.DATASET.NAME, size, device)


class CifarPreprocess:
    """The trainers' on-device CIFAR preprocessing (JAX glp_ot.py:295-303,
    promptfl.py:87-94): uint8 NHWC -> ``/255`` -> the dataset's mean/std ->
    NCHW -> bilinear resize to ``size`` as ``jax.image.resize`` computes it,
    two small matmuls with :func:`resize_weights`' matrices (none when the
    input is already ``size``).  The constants are put on ``device`` once,
    for CIFAR's 32x32 inputs: a copy from the host inside a step would make
    the host wait for the device."""

    def __init__(self, dataset_name: str, size: int, device):
        from .datasets.cifar import MEAN_STD

        mean, std = MEAN_STD[dataset_name]
        self.size = size
        self.mean = torch.tensor(mean, dtype=torch.float32).to(device)
        self.std = torch.tensor(std, dtype=torch.float32).to(device)
        w = torch.from_numpy(resize_weights(32, size))
        self.w_rows = w.t().contiguous().to(device)  # [size, in]: rows = w_rows @ x
        self.w_cols = w.to(device)                   # [in, size]: cols = x @ w_cols

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        x = image.float() / 255.0
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        if (h, w) == (self.size, self.size):
            return x
        if (h, w) != (32, 32):
            raise ValueError(f"CIFAR inputs are 32x32, got {h}x{w}")
        return self.w_rows @ x @ self.w_cols
