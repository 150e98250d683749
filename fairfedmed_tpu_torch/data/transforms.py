"""Input transforms: the port's own copy of the JAX package's
``data/transforms.py`` (Dassl/dassl/data/transforms/transforms.py:15-360
semantics), and the on-device preprocessing of the in-memory datasets.

The host transforms are numpy functions over HWC float32 images in [0, 255];
the pipeline ends with to-CHW and the optional normalize, as the reference's
Resize -> (augment) -> ToTensor -> Normalize does.  Every random draw comes
from numpy's global RNG, in the JAX package's order, so one seed gives the
same images in both packages.  The JAX package calls cv2 for the resizes,
the Gaussian blur and the hue shift; the GPU machine has no cv2, so these are
numpy here, with cv2's conventions:

* ``resize``: separable taps at half-pixel centres as ``cv2.resize``
  computes them (bicubic with A = -0.75 and replicated edges, bilinear with
  clamped edges, nearest at ``floor(i * in / out)``), no antialiasing when
  downsampling and the bicubic overshoot kept (no clip), in float32;
* ``gaussian_blur``: ``cv2.getGaussianKernel``'s taps, applied along each
  axis over a ``BORDER_REFLECT_101`` border;
* the hue shift: cv2's uint8 RGB -> HSV (H in [0, 180), its fixed-point
  rounding) and back.

The medical datasets take no host transform: their normalisation runs inside
the model's forward, as in the reference (GLP_OT_SVLoRA.py:677-693).  Nor do
CIFAR-10/100: their uint8 NHWC batches are normalised and resized inside the
trainers' step (:class:`CifarPreprocess`, JAX glp_ot.py:295-303 and
promptfl.py:87-94).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

AVAI_CHOICES = [
    "random_flip", "random_resized_crop", "normalize", "instance_norm",
    "random_crop", "random_translation", "center_crop", "cutout",
    "imagenet_policy", "cifar10_policy", "svhn_policy", "randaugment",
    "randaugment_fixmatch", "randaugment2", "gaussian_noise", "colorjitter",
    "randomgrayscale", "gaussian_blur",
]

_CUBIC_A = np.float32(-0.75)


def _hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[2] not in (1, 3):
        img = img.transpose(1, 2, 0)  # CHW -> HWC
    return img.astype(np.float32)


def _taps(n_in: int, n_out: int, interpolation: str):
    """Source indices and float32 weights, both ``[n_out, k]``, of
    ``cv2.resize`` along one axis (imgproc/resize.cpp): the source
    coordinate ``(i + 0.5) * in / out - 0.5``, its fraction in float32; bilinear clamps it
    to the first and last pixel, bicubic takes 4 taps around it with cv2's
    cubic (A = -0.75) and replicated edges; nearest takes
    ``floor(i * in / out)``."""
    scale = 1.0 / (n_out / n_in)
    i = np.arange(n_out, dtype=np.float64)
    if interpolation == "nearest":
        idx = np.minimum(np.floor(i * scale).astype(np.int64), n_in - 1)
        return idx[:, None], np.ones((n_out, 1), np.float32)
    src = (i + 0.5) * scale - 0.5
    sx = np.floor(src).astype(np.int64)
    f = (src - sx).astype(np.float32)
    one = np.float32(1.0)
    if interpolation == "bilinear":
        low = sx < 0
        high = sx >= n_in - 1
        f = np.where(low | high, np.float32(0.0), f)
        sx = np.where(low, 0, np.where(high, n_in - 1, sx))
        idx = np.stack([sx, np.minimum(sx + 1, n_in - 1)], 1)
        return idx, np.stack([one - f, f], 1).astype(np.float32)
    if interpolation != "bicubic":
        raise KeyError(interpolation)
    a = _CUBIC_A
    x = f + one
    c0 = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + one
    x = one - f
    c2 = ((a + 2) * x - (a + 3)) * x * x + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def resize(img, size, interpolation="bilinear"):
    """``img`` [H, W, C] float32 resized to ``size`` (an int or (h, w)), as
    ``cv2.resize`` does: along the width first, then the height."""
    h, w = (size, size) if isinstance(size, int) else size
    img = np.asarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    ix, wx = _taps(img.shape[1], int(w), interpolation)
    iy, wy = _taps(img.shape[0], int(h), interpolation)
    rows = img[:, ix[:, 0]] * wx[None, :, 0, None]
    for k in range(1, ix.shape[1]):
        rows += img[:, ix[:, k]] * wx[None, :, k, None]
    out = rows[iy[:, 0]] * wy[:, 0, None, None]
    for k in range(1, iy.shape[1]):
        out += rows[iy[:, k]] * wy[:, k, None, None]
    return out


def resize_short_edge(img, s, interpolation="bilinear"):
    """torchvision Resize(int) semantics: the SHORTER edge becomes ``s``,
    aspect ratio preserved; the long edge TRUNCATES like torchvision's
    ``int(size * long / short)`` (not round)."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = s, max(1, int(w * s / h))
    else:
        nh, nw = max(1, int(h * s / w)), s
    return resize(img, (nh, nw), interpolation)


def random_flip(img):
    return img[:, ::-1] if np.random.rand() < 0.5 else img


def random_crop(img, size, padding=4):
    h, w = (size, size) if isinstance(size, int) else size
    img = np.pad(img, ((padding, padding), (padding, padding), (0, 0)), mode="constant")
    top = np.random.randint(0, img.shape[0] - h + 1)
    left = np.random.randint(0, img.shape[1] - w + 1)
    return img[top : top + h, left : left + w]


def center_crop(img, size):
    h, w = (size, size) if isinstance(size, int) else size
    # round-half offsets like torchvision F.center_crop
    # (int(round((H - h) / 2.0))), not floor — differs by one pixel when
    # the margin is odd
    top = max(int(round((img.shape[0] - h) / 2.0)), 0)
    left = max(int(round((img.shape[1] - w) / 2.0)), 0)
    return img[top : top + h, left : left + w]


def random_resized_crop(img, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                        interpolation="bilinear"):
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * np.random.uniform(*scale)
        aspect = np.exp(np.random.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = np.random.randint(0, h - ch + 1)
            left = np.random.randint(0, w - cw + 1)
            crop = img[top : top + ch, left : left + cw]
            return resize(crop, size, interpolation)
    # torchvision fallback: clamp to the nearest allowed aspect ratio while
    # keeping as much of the image as possible (NOT a square min(h,w) crop,
    # which would discard content torchvision keeps on extreme panoramas)
    in_ratio = w / h
    if in_ratio < min(ratio):
        cw, ch = w, int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        cw, ch = int(round(h * max(ratio))), h
    else:
        cw, ch = w, h
    top, left = (h - ch) // 2, (w - cw) // 2
    return resize(img[top : top + ch, left : left + cw], size, interpolation)


def random_translation(img, size, interpolation="bilinear", p=0.5):
    """Random2DTranslation (transforms.py:43-91): with prob 1-p just resize
    to ``size``; else resize to 1.125x and random-crop back — content is
    never discarded and no blank borders are produced (the previous
    zero-fill pixel shift was a different augmentation)."""
    h, w = (size, size) if isinstance(size, int) else size
    if np.random.uniform(0, 1) > p:
        return resize(img, (h, w), interpolation)
    nh, nw = int(round(h * 1.125)), int(round(w * 1.125))
    out = resize(img, (nh, nw), interpolation)
    x1 = int(round(np.random.uniform(0, nw - w)))
    y1 = int(round(np.random.uniform(0, nh - h)))
    return out[y1 : y1 + h, x1 : x1 + w]


def cutout(img, n_holes=1, length=16):
    h, w = img.shape[:2]
    out = img.copy()
    for _ in range(n_holes):
        y = np.random.randint(h)
        x = np.random.randint(w)
        y1, y2 = np.clip([y - length // 2, y + length // 2], 0, h)
        x1, x2 = np.clip([x - length // 2, x + length // 2], 0, w)
        out[y1:y2, x1:x2] = 0.0
    return out


def gaussian_noise(img, mean=0.0, std=0.15, p=0.5):
    """GaussianNoise (transforms.py:161-173): applied with prob ``p`` AFTER
    normalization, so ``std`` is in normalized units.  (It previously ran
    unconditionally pre-normalize with std*255 — ~4x the reference strength
    on 100% of images.)  The caller appends this after the final stage."""
    if np.random.uniform(0, 1) > p:
        return img
    return img + (np.random.standard_normal(img.shape).astype(np.float32)
                  * std + mean)


def _grayscale(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])


def colorjitter(img, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.0):
    """torchvision ColorJitter semantics: the four adjustments run in RANDOM
    order, each with a factor drawn from [max(0, 1-x), 1+x] (hue from
    [-hue, hue]); contrast blends toward the GRAYSCALE mean (not the
    all-channel mean) and hue shifts the HSV hue channel."""
    ops = []
    if brightness:
        f = np.random.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * f)
    if contrast:
        f_c = np.random.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: _grayscale(x).mean() * (1 - f_c) + x * f_c)
    if saturation:
        f_s = np.random.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda x: _grayscale(x)[..., None] * (1 - f_s) + x * f_s)
    if hue:
        f_h = np.random.uniform(-hue, hue)

        def _hue(x):
            hsv = rgb_to_hsv_u8(np.clip(x, 0, 255).astype(np.uint8)).astype(np.float32)
            hsv[..., 0] = (hsv[..., 0] + f_h * 180.0) % 180.0  # H in [0, 180)
            return hsv_to_rgb_u8(hsv.astype(np.uint8)).astype(np.float32)

        ops.append(_hue)
    out = img
    for i in np.random.permutation(len(ops)):
        # PIL's enhance ops saturate at [0,255] per OP (uint8 images), so
        # later stages must compose from the clamped value — an end-only
        # clip lets a brightened 350 feed the contrast blend where the
        # reference computes from 255.  Float precision is kept (no per-op
        # uint8 rounding; the hue op quantizes through uint8 HSV).
        out = np.clip(ops[int(i)](out), 0, 255)
    return out


def randomgrayscale(img, p=0.1):
    if np.random.rand() < p:
        return np.repeat(_grayscale(img)[..., None], img.shape[-1], axis=-1)
    return img



_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.round((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.round((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` of a uint8 [..., 3] image: H in
    [0, 180), S and V in [0, 255], with cv2's fixed-point divisions (12
    fractional bits, rounded)."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    sdiv, hdiv = _hsv_tables()
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# per hue sector, which of (v, p, q, t) is blue, green and red
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` of a uint8 [..., 3] image (H in
    [0, 180)): cv2's float sector formula, rounded to uint8.  Agrees with
    cv2 to 1 grey level (cv2's own rounding differs between versions)."""
    one = np.float32(1.0)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(np.float32)
    tab = np.stack([v, v * (one - s), v * (one - s * f), v * (one - s * (one - f))], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], -1)
    rgb = np.where((s == 0)[..., None], v[..., None], bgr[..., ::-1])
    return np.clip(np.rint(rgb * np.float32(255.0)), 0, 255).astype(np.uint8)


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(k, sigma)`` in float32 (sigma > 0): the taps
    ``exp(-x^2 / (2 sigma^2))`` at ``x = i - (k - 1) / 2``, normalised to sum
    1."""
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (t * np.float32(1.0 / float(t.astype(np.float64).sum()))).astype(np.float32)


def _blur(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """``img`` [H, W, C] convolved with ``kern`` along the width, then the
    height, over a ``BORDER_REFLECT_101`` border (np.pad's "reflect")."""
    r = len(kern) // 2
    img = np.asarray(img, np.float32)
    pad = np.pad(img, ((0, 0), (r, r), (0, 0)), mode="reflect")
    w = img.shape[1]
    rows = pad[:, 0:w] * kern[0]
    for j in range(1, len(kern)):
        rows += pad[:, j:j + w] * kern[j]
    pad = np.pad(rows, ((r, r), (0, 0), (0, 0)), mode="reflect")
    h = img.shape[0]
    out = pad[0:h] * kern[0]
    for j in range(1, len(kern)):
        out += pad[j:j + h] * kern[j]
    return out


def gaussian_blur(img, k=21, p=0.5):
    if np.random.rand() < p:
        sigma = np.random.uniform(0.1, 2.0)
        return _blur(img, gaussian_kernel(k, sigma)).reshape(img.shape)
    return img


def instance_norm(img, eps=1e-8):
    mean = img.mean((0, 1), keepdims=True)
    std = img.std((0, 1), keepdims=True)
    return (img - mean) / (std + eps)


class Compose:
    def __init__(self, fns: Sequence[Callable]):
        self.fns = list(fns)

    def __call__(self, img):
        img = _hwc(img)
        for fn in self.fns:
            img = fn(img)
        return img


def _final(cfg):
    mean = np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32)
    std = np.asarray(cfg.INPUT.PIXEL_STD, np.float32)
    do_norm = "normalize" in cfg.INPUT.TRANSFORMS

    def fn(img):
        img = img.astype(np.float32) / 255.0
        if do_norm:
            img = (img - mean.reshape(1, 1, -1)) / std.reshape(1, 1, -1)
        return img.transpose(2, 0, 1)  # HWC → CHW

    return fn


MEDICAL_DATASETS = {"FairFedMed", "FedChexMimic", "WangGrant"}
IN_MEMORY_DATASETS = {"Cifar10", "Cifar100"}


def _u8(policy):
    """Policies expect/return uint8 HWC; keep float inputs safe."""
    def fn(img):
        return policy(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
    return fn


def build_transform(cfg, is_train: bool = True) -> Optional[Callable]:
    """Compose the configured transforms (transforms.py:176-360): None for
    the medical and in-memory datasets, whose preprocessing runs on the
    device (see the module docstring), and under ``INPUT.NO_TRANSFORM``."""
    if cfg.INPUT.NO_TRANSFORM or cfg.DATASET.NAME in MEDICAL_DATASETS | IN_MEMORY_DATASETS:
        return None

    size = cfg.INPUT.SIZE if not isinstance(cfg.INPUT.SIZE, str) else (224, 224)
    choices = list(cfg.INPUT.TRANSFORMS)
    interp = cfg.INPUT.INTERPOLATION
    fns: List[Callable] = []

    if is_train:
        # resize only when NO crop op will produce the target size itself
        # (transforms.py:220-226's conditions list): with random_crop the
        # crop must operate on the ORIGINAL-size image, not a pre-warped one
        if "random_crop" not in choices and "random_resized_crop" not in choices:
            fns.append(lambda x: resize(x, size, interp))
        if "random_translation" in choices:
            fns.append(lambda x: random_translation(x, size, interp))
        if "random_crop" in choices:
            fns.append(lambda x: random_crop(x, size, cfg.INPUT.CROP_PADDING))
        if "random_resized_crop" in choices:
            fns.append(lambda x: random_resized_crop(x, size, scale=tuple(cfg.INPUT.RRCROP_SCALE), interpolation=interp))
        if "random_flip" in choices:
            fns.append(random_flip)
        # AutoAugment / RandAugment policy banks (transforms.py:203-225 wiring)
        if "imagenet_policy" in choices or "cifar10_policy" in choices \
                or "svhn_policy" in choices or "randaugment" in choices \
                or "randaugment_fixmatch" in choices or "randaugment2" in choices:
            from . import autoaugment as aa
            if "imagenet_policy" in choices:
                fns.append(_u8(aa.imagenet_policy()))
            if "cifar10_policy" in choices:
                fns.append(_u8(aa.cifar10_policy()))
            if "svhn_policy" in choices:
                fns.append(_u8(aa.svhn_policy()))
            if "randaugment" in choices:
                fns.append(_u8(aa.RandAugment(cfg.INPUT.RANDAUGMENT_N,
                                              cfg.INPUT.RANDAUGMENT_M)))
            if "randaugment_fixmatch" in choices:
                fns.append(_u8(aa.RandAugmentFixMatch(cfg.INPUT.RANDAUGMENT_N)))
            if "randaugment2" in choices:
                fns.append(_u8(aa.RandAugment2(cfg.INPUT.RANDAUGMENT_N)))
        if "colorjitter" in choices:
            fns.append(lambda x: colorjitter(x, cfg.INPUT.COLORJITTER_B, cfg.INPUT.COLORJITTER_C,
                                             cfg.INPUT.COLORJITTER_S, cfg.INPUT.COLORJITTER_H))
        if "randomgrayscale" in choices:
            fns.append(lambda x: randomgrayscale(x, cfg.INPUT.RGS_P))
        if "gaussian_blur" in choices:
            fns.append(lambda x: gaussian_blur(x, cfg.INPUT.GB_K, cfg.INPUT.GB_P))
        # cutout writes 0 pre-normalize: 0/255 == 0 in [0,1], equivalent to
        # the reference's post-ToTensor placement
        if "cutout" in choices:
            fns.append(lambda x: cutout(x, cfg.INPUT.CUTOUT_N, cfg.INPUT.CUTOUT_LEN))
        fns.append(_final(cfg))
        # gaussian noise rides AFTER normalize (std in normalized units, p=.5)
        if "gaussian_noise" in choices:
            fns.append(lambda x: gaussian_noise(x, cfg.INPUT.GN_MEAN, cfg.INPUT.GN_STD))
    else:
        # test pipeline (transforms.py:330-344): short-edge resize preserving
        # aspect ratio + UNCONDITIONAL center crop — warping straight to
        # (h, w) would distort every non-square source
        fns.append(lambda x: resize_short_edge(x, max(size) if not isinstance(size, int) else size, interp))
        fns.append(lambda x: center_crop(x, size))
        fns.append(_final(cfg))

    if "instance_norm" in choices:
        fns.append(lambda x: instance_norm(x.transpose(1, 2, 0)).transpose(2, 0, 1))
    return Compose(fns)


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
