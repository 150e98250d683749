"""3D OCT volumes: one uint8 [depth, height, width] stack of B-scans a
sample, stored under the NPZ member ``oct_bscans``.

What the dataset gives the model (FairFedMed's ``oct_bscans`` modality):
every ``slice_step``-th B-scan, each resized bilinearly to ``size`` x
``size`` (half-pixel centres, as OpenCV's INTER_LINEAR), in float32 on the
0-255 scale.  The model's front end (GLP_OT_SVLoRA's ``proj_per_3d_slice``)
splits a volume's slices into groups of ``dim_per_3d_slice``, maps each
group to a 3-channel image with a trainable 5x5 convolution applied to the
slices / 255, scales each image to [0, 1] by its own minimum and maximum
and takes CLIP's mean and standard deviation: ``images_per_sample`` images
a volume, which share the volume's group mix and whose logits are averaged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TRAINABLE_FRONT = True  # the slice projector lies below the tower: its input takes a gradient
CHUNK = 8  # volumes drawn at a time
MINMAX_EPS = 1e-5
KERNEL = 5


def make_split(rng: np.random.Generator, labels: np.ndarray, traffic: dict, device) -> np.ndarray:
    """A split's stored volumes, uint8 [n, depth, height, width], drawn on
    ``device`` from a generator seeded from ``rng``: coarse random levels
    upsampled trilinearly, fine noise, and a bright horizontal band (a
    retinal layer) across every B-scan whose thickness, a share of the
    height, is ``layer["thickness"][label]``, so each class's volumes
    differ in content."""
    depth, height, width = traffic["depth"], traffic["height"], traffic["width"]
    layer = traffic["layer"]
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    rows = (torch.arange(height, device=device, dtype=torch.float32) + 0.5) / height
    bands = torch.stack([(rows - layer["centre"]).abs() < t / 2 for t in layer["thickness"]])
    coarse = (max(2, depth // 16), max(2, height // 24), max(2, width // 24))
    out = np.empty((len(labels), depth, height, width), np.uint8)
    for i in range(0, len(labels), CHUNK):
        c = min(CHUNK, len(labels) - i)
        levels = torch.randint(0, 256, (c, 1, *coarse), generator=gen, device=device)
        vol = F.interpolate(levels.float(), size=(depth, height, width), mode="trilinear",
                            align_corners=False)[:, 0]
        vol += torch.randint(-12, 13, vol.shape, generator=gen, device=device)
        band = bands[torch.as_tensor(labels[i:i + c], device=device)]  # [c, height]
        vol += layer["level"] * band[:, None, :, None]
        out[i:i + c] = vol.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    return out


def npz_members(stored: np.ndarray) -> dict:
    return {"oct_bscans": stored}


def _taps(n_in: int, n_out: int):
    """Lower and upper source row of each output row and the upper one's
    weight, for a bilinear resize with half-pixel centres, the source
    coordinate clamped at 0 and the upper row at the last."""
    src = np.maximum((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    lower = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    return lower, np.minimum(lower + 1, n_in - 1), (src - lower).astype(np.float32)


def fed(stored: np.ndarray, traffic: dict) -> np.ndarray:
    """What the dataset gives the model for stored volumes [n, depth, H, W]:
    float32 [n, depth / slice_step, size, size]."""
    size = traffic["size"]
    kept = stored[:, ::traffic["slice_step"]]
    out = np.empty((*kept.shape[:2], size, size), np.float32)
    y0, y1, wy = _taps(kept.shape[2], size)
    x0, x1, wx = _taps(kept.shape[3], size)
    for i in range(len(kept)):  # a volume at a time: the temporaries stay small
        v = kept[i].astype(np.float32)
        rows = v[:, y0] * (1.0 - wy)[:, None] + v[:, y1] * wy[:, None]
        out[i] = rows[:, :, x0] * (1.0 - wx) + rows[:, :, x1] * wx
    return out


def images_per_sample(traffic: dict) -> int:
    kept = -(-traffic["depth"] // traffic["slice_step"])
    return kept // traffic["dim_per_3d_slice"]


def front_macs(traffic: dict) -> tuple:
    """(forward, backward) multiply-adds of the slice projector a volume:
    each image's 3 x 5 x 5 x dim_per_3d_slice products a pixel; backward its
    weight gradient alone (its input is data)."""
    macs = (images_per_sample(traffic) * traffic["size"] ** 2 * 3
            * traffic["dim_per_3d_slice"] * KERNEL ** 2)
    return macs, macs


def front(model, img, state):
    """Normalised images [n * images_per_sample, 3, size, size] from what
    the dataset gives, float32 [n, slices, size, size]."""
    n, slices, h, w = img.shape
    x = img.float().reshape(n * model.per_sample, slices // model.per_sample, h, w) / 255.0
    x = model.num.conv(x, state["proj_per_3d_slice.weight"], padding=KERNEL // 2) \
        + state["proj_per_3d_slice.bias"].reshape(1, -1, 1, 1)
    low = x.amin(dim=(1, 2, 3), keepdim=True)
    high = x.amax(dim=(1, 2, 3), keepdim=True)
    x = (x - low) / (high - low + MINMAX_EPS)
    return (x - model.mean) / model.std
