"""Write the committed FedChexMimic JPEG fixture: 8 smooth grayscale images,
4 at CheXpert's 320x320 and 4 at MIMIC's 336x336, encoded by PIL from a
seed, and ``decoded.npz`` with their pixels as libjpeg decodes them (the
port's native JPEG build, no resize), uint8 [H, W] per file.

    python tests/data/make_fedchexmimic_jpeg.py   # from the repository root

Needs PIL and the native JPEG build (libjpeg's headers).  The outputs are
committed: ``chip_smoke.py`` copies the JPEGs into its fixture (the GPU
machine may have no JPEG encoder) and holds the decoder it finds against
``decoded.npz``, as ``tests/test_torch_port_datasets.py`` does here.
"""

import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "data", "fedchexmimic_jpeg")
SIZES = (320,) * 4 + (336,) * 4


def smooth_image(rng, size):
    """A chest-film-like picture: a vertical gradient and a few broad
    Gaussian blobs, 20-235 grey levels."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = 0.3 * yy
    for _ in range(5):
        cy, cx = rng.uniform(0.2, 0.8, 2)
        sy, sx = rng.uniform(0.08, 0.3, 2)
        img += rng.uniform(-0.6, 0.8) * np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2)
    img = (img - img.min()) / (img.max() - img.min())
    return np.round(20 + 215 * img).astype(np.uint8)


def main():
    sys.path.insert(0, ROOT)
    from fairfedmed_tpu_torch import native

    if native.decoder("jpeg") != "libjpeg":
        raise SystemExit(f"the native JPEG build is needed: {native.build_log()[-400:]}")
    rng = np.random.default_rng(7)
    decoded = {}
    for i, size in enumerate(SIZES):
        name = f"{'chexpert' if size == 320 else 'mimic'}_{i}.jpg"
        path = os.path.join(OUT, name)
        Image.fromarray(smooth_image(rng, size), mode="L").save(path, quality=90)
        decoded[name] = native.decode_jpeg_gray(path, size).astype(np.uint8)
    np.savez_compressed(os.path.join(OUT, "decoded.npz"), **decoded)


if __name__ == "__main__":
    main()
