"""WangGrant heart-biomarker dataset (mac/onh TIFF fundus images).

Capability parity with ``WangGrantDataset`` (utils/data_utils.py:436-555).
Note the reference ships this class in a broken state: ``datasets/build.py:13``
imports a missing ``datasets/WangGrant.py`` module (ImportError as shipped)
and the attrs branch reads ``raw_data[k]`` off a pixel array.  Here the class
is functional — registered as ``WangGrant`` — and attrs come from CSV columns
when present.

CSV: per-site ``..._clean_site{k}_{train,valid}.csv`` is used when it exists
(mirroring FairFedMed's per-site convention); otherwise every client falls
back to the shared ``metatable_heart_biomarkers_binary_oneeye_clean_{train,
valid}.csv``, with ``id``, ``righteye`` and the binary disease columns
(heart.attack/heart.ckmb/heart.troponin/heart.proBNP); images live at
``<root>/<modality>/<id>_<OD|OS>_<modality>.tif``.

The port's own copy of the JAX package's ``data/datasets/wanggrant.py``.  Two
replacements keep it free of packages the GPU machine lacks: the CSV is read
with the stdlib ``csv`` module, each column typed as pandas types it (int,
else float, else str), and the bilinear resize is the numpy one of
``fairfedmed.py`` (cv2 in the JAX package), with the same convention.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from .fairfedmed import _resize2d


def _resize_chw(img: np.ndarray, res: int) -> np.ndarray:
    if img.shape[1] == res and img.shape[2] == res:
        return img
    return np.stack([_resize2d(c, res) for c in img])


def _typed(values: List[str]) -> list:
    """A CSV column's strings as pandas' ``read_csv`` types them: ints when
    every value is one, else floats when every value is one, else the
    strings."""
    for cast in (int, float):
        try:
            return [cast(v) for v in values]
        except ValueError:
            pass
    return list(values)


def _read_csv(path: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {k: _typed([r[j] for r in body]) for j, k in enumerate(header)}


class WangGrantDataset:
    """One site's split; TIFF decode via PIL, loader-compatible."""

    def __init__(self, disease_type: str, base_path: str, site: int = 1,
                 attribute_type: Optional[str] = None,
                 attributes: Optional[List[str]] = None,
                 modality_type: str = "mac", resolution: int = 224,
                 depth: int = 3, train: bool = True):
        self.base_path = base_path
        self.data_path = base_path
        self.modality_type = modality_type
        self.attributes = list(attributes or [])
        self.resolution = resolution
        self.depth = depth

        split = "train" if train else "valid"
        stem = "metatable_heart_biomarkers_binary_oneeye_clean"
        per_site = os.path.join(base_path, f"{stem}_site{site}_{split}.csv")
        shared = os.path.join(base_path, f"{stem}_{split}.csv")
        csv_path = per_site if os.path.exists(per_site) else shared
        df = _read_csv(csv_path)
        assert "id" in df and "righteye" in df, "file id must be included in the head"
        n = len(df["id"])
        self.data_files = [
            f"{df['id'][i]}_{'OD' if df['righteye'][i] == 1.0 else 'OS'}"
            for i in range(n)
        ]
        self._labels = [int(df[disease_type][i]) for i in range(n)]
        self._attr_rows = [
            [int(df[a][i]) if a in df else -1 for a in self.attributes]
            for i in range(n)
        ]

    def __len__(self):
        return len(self.data_files)

    @property
    def labels(self) -> np.ndarray:
        return np.asarray(self._labels, np.int32)

    def _load_tif(self, stem: str, modality: str) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.data_path, modality, f"{stem}_{modality}.tif")
        raw = np.asarray(Image.open(path).convert("RGB"))
        img = np.transpose(raw, (2, 0, 1)).astype(np.float32)  # [3, H, W]
        return _resize_chw(img, self.resolution)

    def load_item(self, i: int):
        stem = self.data_files[i]
        m = self.modality_type
        if m in ("mac", "onh", "mosaic"):
            img = self._load_tif(stem, m)
        elif m in ("onh_mac", "mac_onh"):
            img = np.concatenate([self._load_tif(stem, "mac"),
                                  self._load_tif(stem, "onh")], axis=0)
        else:
            raise NotImplementedError(m)
        attrs = (np.asarray(self._attr_rows[i], np.int32)
                 if self.attributes else None)
        return img, self._labels[i], attrs


@DATASET_REGISTRY.register()
class WangGrant:
    """Federated wrapper: one WangGrant split per client (USERS sites share
    the same CSVs when per-site files are absent)."""

    dataset_dir = "wanggrant"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        base = self.dataset_dir if os.path.isdir(self.dataset_dir) else root
        size = cfg.INPUT.SIZE[0] if not isinstance(cfg.INPUT.SIZE, str) else 224
        common = dict(
            disease_type=cfg.DATASET.DISEASE_TYPE or "heart.attack",
            base_path=base,
            attribute_type=cfg.DATASET.ATTRIBUTE_TYPE,
            attributes=cfg.DATASET.ATTRIBUTES,
            modality_type=cfg.DATASET.MODALITY_TYPE,
            resolution=size,
        )
        self.federated_train_x = [
            WangGrantDataset(site=i + 1, train=True, **common)
            for i in range(cfg.DATASET.USERS)]
        self.federated_test_x = [
            WangGrantDataset(site=i + 1, train=False, **common)
            for i in range(cfg.DATASET.USERS)]
        self.num_classes = 2
        self.lab2cname = {0: "negative", 1: "positive"}
        self.classnames = ["negative", "positive"]
