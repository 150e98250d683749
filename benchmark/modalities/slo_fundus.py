"""SLO fundus photographs: one uint8 [H, W] image a sample, stored under the
NPZ member ``slo_fundus``.  The dataset gives the model its transpose
repeated over 3 channels; the model divides by 255 and takes CLIP's mean
and standard deviation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TRAINABLE_FRONT = False  # nothing trainable lies below the tower

def _smooth_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """[n, size, size] uint8 photo-like grey images: coarse random levels
    upsampled bicubically, plus fine noise (so deflate finds some structure,
    as it does in a fundus photograph)."""
    coarse = max(2, size // 24)
    levels = torch.from_numpy(rng.integers(0, 256, (n, 1, coarse, coarse)).astype(np.float32))
    up = F.interpolate(levels, size=(size, size), mode="bicubic", align_corners=False)[:, 0]
    noise = torch.from_numpy(rng.integers(-12, 13, (n, size, size)).astype(np.float32))
    return (up + noise).round().clamp(0, 255).to(torch.uint8).numpy()


def _cup(pixels: np.ndarray, labels: np.ndarray, cup: dict) -> np.ndarray:
    """``pixels`` with a bright central disc (the optic cup) whose radius, a
    share of the side, is ``cup["radius"][label]``: the cup-to-disc ratio
    that grows with glaucoma, so each class's images differ in content."""
    size = pixels.shape[-1]
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(yy - (size - 1) / 2, xx - (size - 1) / 2) / size
    discs = np.stack([r < rad for rad in cup["radius"]])  # [classes, size, size]
    return np.clip(pixels.astype(np.int16) + cup["level"] * discs[labels], 0, 255).astype(np.uint8)


def make_split(rng: np.random.Generator, labels: np.ndarray, traffic: dict, device) -> np.ndarray:
    """A split's stored images, uint8 [n, size, size], drawn from ``rng``;
    with ``cup`` each carries its class's optic cup (``_cup``)."""
    pixels = _smooth_images(rng, len(labels), traffic["size"])
    if "cup" in traffic:
        pixels = _cup(pixels, labels, traffic["cup"])
    return pixels


def npz_members(stored: np.ndarray) -> dict:
    return {"slo_fundus": stored}


def fed(stored: np.ndarray, traffic: dict) -> np.ndarray:
    """What the dataset gives the model for stored pixels [n, H, W]: the
    transpose, repeated over 3 channels -> [n, 3, W, H] uint8."""
    t = np.ascontiguousarray(np.transpose(stored, (0, 2, 1)))
    return np.repeat(t[:, None], 3, axis=1)


def images_per_sample(traffic: dict) -> int:
    return 1


def front_macs(traffic: dict) -> tuple:
    """(forward, backward) multiply-adds of the front end a sample: none."""
    return 0, 0


def front(model, img, state):
    """Normalised images [n, 3, H, W] from what the dataset gives: /255,
    then CLIP's mean and standard deviation."""
    return (img.float() / 255.0 - model.mean) / model.std
