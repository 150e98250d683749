"""FairFedMed-Chest: CheXpert (site 1) + MIMIC-CXR (site 2).

The port's own copy of the JAX package's ``data/datasets/fedchexmimic.py``
(FedChexMimicDataset, utils/data_utils.py:729-790): per-site CSV
``meta_{chexpert,mimic}_{attr}_{train,test}.csv`` with ``filename``,
``{attr}_label`` columns and ``disease_label``; grayscale JPEG -> resize ->
repeat to 3 channels, raw 0-255 scale (the model normalises in its forward).

Two replacements keep it free of packages the GPU machine lacks: the CSVs
are read with the stdlib ``csv`` module (pandas in the JAX package) and the
synchronous path's bilinear resize is numpy (cv2 there), with the same
convention.  JPEGs decode on the native pool's threads (libjpeg) when the
JPEG build loaded and the loader prefetched them, else synchronously with
PIL, imported only there; ``native.decoder("jpeg")`` says which.  With
neither, ``load_item`` raises.
"""

from __future__ import annotations

import csv
import os
from typing import List

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from .fairfedmed import _resize2d, group_histogram


def _read_csv(path: str) -> dict:
    """The CSV's columns as lists of strings, keyed by the header."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {k: [] for k in header}
        for row in reader:
            for k, v in zip(header, row):
                cols[k].append(v)
    return cols


def _int_column(cols: dict, name: str) -> np.ndarray:
    # pandas reads an integer column as int64; int(float()) also takes "1.0"
    return np.asarray([int(float(v)) for v in cols[name]], np.int32)


def decode_gray_pil(path: str) -> np.ndarray:
    """The JPEG at ``path`` as grayscale fp32 [H, W] on the 0-255 scale,
    decoded by PIL (``convert("L")``, as the JAX package's synchronous
    path)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"no JPEG decoder for {path}: the native JPEG build is not loaded "
                           "(libjpeg's headers are missing) and PIL does not import") from e
    with Image.open(path) as im:
        return np.array(im.convert("L"), dtype=np.float32)


class FedChexMimicDataset:
    _pool = None  # shared native prefetch pool (lazy), like FairFedMedDataset's

    def __init__(self, base_path: str, site: int, attribute_type: str,
                 attributes: List[str], resolution: int = 224, depth: int = 3,
                 train: bool = True):
        self.base_path = base_path
        if site == 1:
            site_name = "chexpert"
            self.data_path = base_path
        elif site == 2:
            site_name = "mimic"
            self.data_path = os.path.join(base_path, "files_336p")
        else:
            raise NotImplementedError(f"FedChexMimic has 2 sites, got {site}")
        self.attribute_type = attribute_type
        self.attributes = list(attributes)
        self.resolution = resolution
        self.depth = depth

        split = "train" if train else "test"
        cols = _read_csv(os.path.join(base_path, f"meta_{site_name}_{attribute_type}_{split}.csv"))
        if "filename" not in cols:
            raise AssertionError("filename must be included in the head")
        self.data_files = list(cols["filename"])
        self.data_attrs = _int_column(cols, attribute_type + "_label")
        self.disease_labels = _int_column(cols, "disease_label")
        self.data_attributes = np.stack(
            [_int_column(cols, k + "_label") for k in self.attributes], axis=1
        ) if self.attributes else np.zeros((len(self.data_files), 0), np.int32)

    def __len__(self):
        return len(self.data_files)

    @property
    def labels(self) -> np.ndarray:
        return self.disease_labels

    @property
    def attrs_matrix(self) -> np.ndarray:
        return self.data_attributes

    def count_by_attribute(self, attr: str) -> List[int]:
        return group_histogram(self.data_attributes[:, self.attributes.index(attr)])

    @classmethod
    def _get_pool(cls):
        if cls._pool is None:
            from ...native import PrefetchPool
            cls._pool = PrefetchPool(n_threads=2)
        return cls._pool

    def prefetch(self, idxs):
        """Queue upcoming X-rays on the native JPEG pool (libjpeg and the
        bilinear resize on C++ threads outside the GIL).  A no-op without
        the JPEG build: ``load_item`` then decodes with PIL."""
        pool = self._get_pool()
        if not pool.supports_jpeg:
            return
        if not hasattr(self, "_tickets"):
            self._tickets = {}
        for i in idxs:
            i = int(i)
            if i in self._tickets:
                continue
            path = os.path.join(self.data_path, self.data_files[i])
            self._tickets[i] = pool.submit_jpeg(path, self.resolution)

    def clear_prefetch(self):
        """Drop uncollected tickets (an interrupted epoch)."""
        tickets = getattr(self, "_tickets", None)
        if not tickets:
            return
        pool = self._get_pool()
        for t in tickets.values():
            pool.discard(t)
        tickets.clear()

    def _decode(self, i: int) -> np.ndarray:
        path = os.path.join(self.data_path, self.data_files[i])
        tickets = getattr(self, "_tickets", None)
        if tickets and i in tickets:
            try:
                return self._get_pool().collect(tickets.pop(i))
            except (IOError, OSError):
                # files libjpeg rejects (CMYK, PNG named .jpg, truncation)
                # go to PIL, as in the JAX package
                pass
        image = decode_gray_pil(path)
        if image.shape[0] != self.resolution or image.shape[1] != self.resolution:
            image = _resize2d(image, self.resolution)
        return image

    def load_item(self, i: int):
        """(image fp32 [depth, res, res] on the 0-255 scale, disease label,
        attrs int vector)."""
        img = self._decode(int(i))[None]
        if self.depth > 1:
            img = np.repeat(img, self.depth, axis=0)
        attrs = self.data_attributes[i]
        return img.astype(np.float32), int(self.disease_labels[i]), attrs.astype(np.int32)


@DATASET_REGISTRY.register()
class FedChexMimic:
    """2-site cross-institutional chest X-ray FL (datasets/FedChexMimic.py)."""

    dataset_dir = "fedchexmimic"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.num_classes = 2

        self.federated_train_x = []
        self.federated_test_x = []
        for net_id in range(cfg.DATASET.USERS):
            size = cfg.INPUT.SIZE[0] if not isinstance(cfg.INPUT.SIZE, str) else 224
            common = dict(
                base_path=self.dataset_dir,
                site=net_id + 1,
                attribute_type=cfg.DATASET.ATTRIBUTE_TYPE,
                attributes=cfg.DATASET.ATTRIBUTES,
                resolution=size,
                depth=3,
            )
            self.federated_train_x.append(FedChexMimicDataset(train=True, **common))
            self.federated_test_x.append(FedChexMimicDataset(train=False, **common))

        self.lab2cname = {0: "NOT Pleural Effusion", 1: "Pleural Effusion"}
        self.classnames = ["NOT Pleural Effusion", "Pleural Effusion"]
