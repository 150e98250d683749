"""AutoAugment / RandAugment host-side augmentation policies.

The port's own copy of the JAX package's ``data/autoaugment.py``.  Capability
parity with the reference's transform bank
(``Dassl/dassl/data/transforms/autoaugment.py:9-272`` and
``randaugment.py:221-363``): the AutoAugment ImageNet / CIFAR10 / SVHN
sub-policy tables and the three RandAugment variants
(``RandAugment``/``RandAugment2``/``RandAugmentFixMatch``).

Design differs from the reference: policies are *data* (flat tuples) fed to a
single op dispatcher, and randomness comes from one ``np.random.Generator`` so
augmentation streams are reproducible per worker/seed.  Inputs/outputs are
numpy HWC uint8 arrays (the native currency of the host pipeline); PIL is used
internally for the geometric/photometric ops, imported where an op runs, so
importing the port imports no PIL.

``build_transform`` builds these classes with ``seed=None``, as the JAX
package does: a run with a policy draws from fresh OS entropy and is not
reproducible in either package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
_FILL = (128, 128, 128)

# --------------------------------------------------------------------------
# Single-op dispatcher.  ``mag`` is already resolved to its physical value.
# Signed ops receive a ``sign`` in {-1, +1} drawn by the caller.
# --------------------------------------------------------------------------


def _apply_op(img: Image.Image, op: str, mag: float, sign: int,
              rng: np.random.Generator):
    from PIL import Image, ImageEnhance, ImageOps

    if op == "shearX":
        return img.transform(img.size, Image.AFFINE, (1, sign * mag, 0, 0, 1, 0),
                             Image.BICUBIC, fillcolor=_FILL)
    if op == "shearY":
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, sign * mag, 1, 0),
                             Image.BICUBIC, fillcolor=_FILL)
    if op == "translateX":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, sign * mag * img.size[0], 0, 1, 0), fillcolor=_FILL)
    if op == "translateY":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0, 0, 1, sign * mag * img.size[1]), fillcolor=_FILL)
    if op == "translateXabs":
        return img.transform(img.size, Image.AFFINE, (1, 0, sign * mag, 0, 1, 0),
                             fillcolor=_FILL)
    if op == "translateYabs":
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, sign * mag),
                             fillcolor=_FILL)
    if op == "rotate":
        # rotate on an RGBA canvas then composite over grey so corners fill
        # with the fill colour (autoaugment.py:192-197 behavior).
        rot = img.convert("RGBA").rotate(sign * mag)
        return Image.composite(rot, Image.new("RGBA", rot.size, (128,) * 4),
                               rot).convert(img.mode)
    if op == "color":
        return ImageEnhance.Color(img).enhance(1 + sign * mag)
    if op == "contrast":
        return ImageEnhance.Contrast(img).enhance(1 + sign * mag)
    if op == "brightness":
        return ImageEnhance.Brightness(img).enhance(1 + sign * mag)
    if op == "sharpness":
        return ImageEnhance.Sharpness(img).enhance(1 + sign * mag)
    if op == "color_abs":
        return ImageEnhance.Color(img).enhance(mag)
    if op == "contrast_abs":
        return ImageEnhance.Contrast(img).enhance(mag)
    if op == "brightness_abs":
        return ImageEnhance.Brightness(img).enhance(mag)
    if op == "sharpness_abs":
        return ImageEnhance.Sharpness(img).enhance(mag)
    if op == "posterize":
        return ImageOps.posterize(img, max(1, int(mag)))
    if op == "solarize":
        return ImageOps.solarize(img, int(mag))
    if op == "solarize_add":
        arr = np.asarray(img).astype(np.int64)
        added = np.clip(arr + int(mag), 0, 255)
        out = np.where(arr < 128, added, arr).astype(np.uint8)
        return Image.fromarray(out)
    if op == "autocontrast":
        return ImageOps.autocontrast(img)
    if op == "equalize":
        return ImageOps.equalize(img)
    if op == "invert":
        return ImageOps.invert(img)
    if op == "cutout_abs":
        if mag <= 0:
            return img
        w, h = img.size
        x0 = int(max(0, rng.uniform(0, w) - mag / 2.0))
        y0 = int(max(0, rng.uniform(0, h) - mag / 2.0))
        x1, y1 = int(min(w, x0 + mag)), int(min(h, y0 + mag))
        out = img.copy()
        out.paste(Image.new(img.mode, (x1 - x0, y1 - y0), _FILL), (x0, y0))
        return out
    if op == "identity":
        return img
    raise ValueError(f"unknown augmentation op: {op}")


_SIGNED = {"shearX", "shearY", "translateX", "translateY", "translateXabs",
           "translateYabs", "rotate", "color", "contrast", "brightness",
           "sharpness"}

# --------------------------------------------------------------------------
# AutoAugment: magnitude index 0-9 maps into a per-op linspace
# (autoaugment.py:173-189), sub-policies are (p, op, mag_idx) pairs.
# --------------------------------------------------------------------------

_AA_RANGES = {
    "shearX": (0.0, 0.3), "shearY": (0.0, 0.3),
    "translateX": (0.0, 150 / 331), "translateY": (0.0, 150 / 331),
    "rotate": (0.0, 30.0), "color": (0.0, 0.9), "contrast": (0.0, 0.9),
    "sharpness": (0.0, 0.9), "brightness": (0.0, 0.9),
    "posterize": (8.0, 4.0), "solarize": (256.0, 0.0),
    "autocontrast": (0.0, 0.0), "equalize": (0.0, 0.0), "invert": (0.0, 0.0),
}


def _aa_mag(op: str, idx: int) -> float:
    lo, hi = _AA_RANGES[op]
    val = lo + (hi - lo) * idx / 9.0
    if op == "posterize":
        val = round(val)
    return val


# (p1, op1, m1, p2, op2, m2) — the published best-24/25 sub-policy tables.
IMAGENET_POLICY: Sequence[Tuple] = (
    (0.4, "posterize", 8, 0.6, "rotate", 9),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
    (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.4, "equalize", 4, 0.8, "rotate", 8),
    (0.6, "solarize", 3, 0.6, "equalize", 7),
    (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.2, "rotate", 3, 0.6, "solarize", 8),
    (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.8, "rotate", 8, 0.4, "color", 0),
    (0.4, "rotate", 9, 0.6, "equalize", 2),
    (0.0, "equalize", 7, 0.8, "equalize", 8),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "rotate", 8, 1.0, "color", 2),
    (0.8, "color", 8, 0.8, "solarize", 7),
    (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.6, "shearX", 5, 1.0, "equalize", 9),
    (0.4, "color", 0, 0.6, "equalize", 3),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
)

CIFAR10_POLICY: Sequence[Tuple] = (
    (0.1, "invert", 7, 0.2, "contrast", 6),
    (0.7, "rotate", 2, 0.3, "translateX", 9),
    (0.8, "sharpness", 1, 0.9, "sharpness", 3),
    (0.5, "shearY", 8, 0.7, "translateY", 9),
    (0.5, "autocontrast", 8, 0.9, "equalize", 2),
    (0.2, "shearY", 7, 0.3, "posterize", 7),
    (0.4, "color", 3, 0.6, "brightness", 7),
    (0.3, "sharpness", 9, 0.7, "brightness", 9),
    (0.6, "equalize", 5, 0.5, "equalize", 1),
    (0.6, "contrast", 7, 0.6, "sharpness", 5),
    (0.7, "color", 7, 0.5, "translateX", 8),
    (0.3, "equalize", 7, 0.4, "autocontrast", 8),
    (0.4, "translateY", 3, 0.2, "sharpness", 6),
    (0.9, "brightness", 6, 0.2, "color", 8),
    (0.5, "solarize", 2, 0.0, "invert", 3),
    (0.2, "equalize", 0, 0.6, "autocontrast", 0),
    (0.2, "equalize", 8, 0.6, "equalize", 4),
    (0.9, "color", 9, 0.6, "equalize", 6),
    (0.8, "autocontrast", 4, 0.2, "solarize", 8),
    (0.1, "brightness", 3, 0.7, "color", 0),
    (0.4, "solarize", 5, 0.9, "autocontrast", 3),
    (0.9, "translateY", 9, 0.7, "translateY", 9),
    (0.9, "autocontrast", 2, 0.8, "solarize", 3),
    (0.8, "equalize", 8, 0.1, "invert", 3),
    (0.7, "translateY", 9, 0.9, "autocontrast", 1),
)

SVHN_POLICY: Sequence[Tuple] = (
    (0.9, "shearX", 4, 0.2, "invert", 3),
    (0.9, "shearY", 8, 0.7, "invert", 5),
    (0.6, "equalize", 5, 0.6, "solarize", 6),
    (0.9, "invert", 3, 0.6, "equalize", 3),
    (0.6, "equalize", 1, 0.9, "rotate", 3),
    (0.9, "shearX", 4, 0.8, "autocontrast", 3),
    (0.9, "shearY", 8, 0.4, "invert", 5),
    (0.9, "shearY", 5, 0.2, "solarize", 6),
    (0.9, "invert", 6, 0.8, "autocontrast", 1),
    (0.6, "equalize", 3, 0.9, "rotate", 3),
    (0.9, "shearX", 4, 0.3, "solarize", 3),
    (0.8, "shearY", 8, 0.7, "invert", 4),
    (0.9, "equalize", 5, 0.6, "translateY", 6),
    (0.9, "invert", 4, 0.6, "equalize", 7),
    (0.3, "contrast", 3, 0.8, "rotate", 4),
    (0.8, "invert", 5, 0.0, "translateY", 2),
    (0.7, "shearY", 6, 0.4, "solarize", 8),
    (0.6, "invert", 4, 0.8, "rotate", 4),
    (0.3, "shearY", 7, 0.9, "translateX", 3),
    (0.1, "shearX", 6, 0.6, "invert", 5),
    (0.7, "solarize", 2, 0.6, "translateY", 7),
    (0.8, "shearY", 4, 0.8, "invert", 8),
    (0.7, "shearX", 9, 0.8, "translateY", 3),
    (0.8, "shearY", 5, 0.7, "autocontrast", 3),
    (0.7, "shearX", 2, 0.1, "invert", 5),
)

# --------------------------------------------------------------------------
# RandAugment op banks: (op, minval, maxval).  Variant 1 is the TPU
# efficientnet bank (randaugment.py:244-262); variant 2 and fixmatch use
# fraction-of-range signed ops (randaugment.py:267-309).
# --------------------------------------------------------------------------

RANDAUGMENT_BANK: Sequence[Tuple] = (
    ("autocontrast", 0, 1), ("equalize", 0, 1), ("invert", 0, 1),
    ("rotate", 0, 30), ("posterize", 4, 8), ("solarize", 0, 256),
    ("solarize_add", 0, 110), ("color_abs", 0.1, 1.9), ("contrast_abs", 0.1, 1.9),
    ("brightness_abs", 0.1, 1.9), ("sharpness_abs", 0.1, 1.9),
    ("shearX", 0.0, 0.3), ("shearY", 0.0, 0.3), ("cutout_abs", 0, 40),
    ("translateXabs", 0.0, 100), ("translateYabs", 0.0, 100),
)

RANDAUGMENT2_BANK: Sequence[Tuple] = (
    ("autocontrast", 0, 1), ("brightness_abs", 0.1, 1.9), ("color_abs", 0.1, 1.9),
    ("contrast_abs", 0.1, 1.9), ("equalize", 0, 1), ("identity", 0, 1),
    ("invert", 0, 1), ("posterize", 4, 8), ("rotate", -30, 30),
    ("sharpness_abs", 0.1, 1.9), ("shearX", -0.3, 0.3), ("shearY", -0.3, 0.3),
    ("solarize", 0, 256), ("translateX", -0.3, 0.3), ("translateY", -0.3, 0.3),
)

FIXMATCH_BANK: Sequence[Tuple] = (
    ("autocontrast", 0, 1), ("brightness_abs", 0.05, 0.95), ("color_abs", 0.05, 0.95),
    ("contrast_abs", 0.05, 0.95), ("equalize", 0, 1), ("identity", 0, 1),
    ("posterize", 4, 8), ("rotate", -30, 30), ("sharpness_abs", 0.05, 0.95),
    ("shearX", -0.3, 0.3), ("shearY", -0.3, 0.3), ("solarize", 0, 256),
    ("translateX", -0.3, 0.3), ("translateY", -0.3, 0.3),
)


def _to_pil(img: np.ndarray):
    from PIL import Image

    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return Image.fromarray(np.ascontiguousarray(img.astype(np.uint8)))


class AutoAugmentPolicy:
    """Pick one random sub-policy per call; each half fires with its own p."""

    def __init__(self, table: Sequence[Tuple], seed: Optional[int] = None):
        self.table = table
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        pil = _to_pil(img)
        p1, op1, m1, p2, op2, m2 = self.table[int(self.rng.integers(len(self.table)))]
        for p, op, m in ((p1, op1, m1), (p2, op2, m2)):
            if self.rng.random() < p:
                sign = int(self.rng.choice((-1, 1))) if op in _SIGNED else 1
                pil = _apply_op(pil, op, _aa_mag(op, m), sign, self.rng)
        return np.asarray(pil)


def imagenet_policy(seed=None):
    return AutoAugmentPolicy(IMAGENET_POLICY, seed)


def cifar10_policy(seed=None):
    return AutoAugmentPolicy(CIFAR10_POLICY, seed)


def svhn_policy(seed=None):
    return AutoAugmentPolicy(SVHN_POLICY, seed)


class RandAugment:
    """n random ops at fixed magnitude m/30 of each op's range."""

    def __init__(self, n: int = 2, m: int = 10, seed: Optional[int] = None):
        assert 0 <= m <= 30
        self.n, self.m = n, m
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        pil = _to_pil(img)
        for _ in range(self.n):
            op, lo, hi = RANDAUGMENT_BANK[int(self.rng.integers(len(RANDAUGMENT_BANK)))]
            val = (self.m / 30.0) * (hi - lo) + lo
            sign = int(self.rng.choice((-1, 1))) if op in _SIGNED else 1
            pil = _apply_op(pil, op, val, sign, self.rng)
        return np.asarray(pil)


class RandAugment2:
    """n random ops, each fired with prob p at a uniformly random magnitude."""

    def __init__(self, n: int = 2, p: float = 0.6, seed: Optional[int] = None):
        self.n, self.p = n, p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return _rand_bank(self.rng, _to_pil(img), RANDAUGMENT2_BANK, self.n, self.p)


class RandAugmentFixMatch:
    """n random ops at uniformly random magnitude (always fire)."""

    def __init__(self, n: int = 2, seed: Optional[int] = None):
        self.n = n
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return _rand_bank(self.rng, _to_pil(img), FIXMATCH_BANK, self.n, 1.1)


def _rand_bank(rng, pil, bank, n, p):
    for _ in range(n):
        op, lo, hi = bank[int(rng.integers(len(bank)))]
        if rng.random() > p:
            continue
        val = rng.random() * (hi - lo) + lo
        # signed ranges are encoded directly in (lo, hi); no extra sign flip
        pil = _apply_op(pil, op, val, 1, rng)
    return np.asarray(pil)
