"""FairFedMed-Oph dataset (NPZ SLO-fundus / OCT B-scans + demographic
attributes).

The port's own copy of the JAX package's ``data/datasets/fairfedmed.py``
(FairFedMedDataset semantics, utils/data_utils.py:559-726): per-site CSV
``meta_site{k}_{attr}_{train,test}.csv`` with a ``filename`` column; rows with
attribute -1 or empty modality arrays are filtered; labels come from the NPZ
``glaucoma`` field; ``attrs`` is the int vector over all configured
attributes.

A one-pass metadata index (attrs, label, modality presence per file) is built
once and cached as a JSON sidecar next to the CSV, so startup costs one scan
ever and ``count_by_attribute`` is a lookup.  Pixel members decode through the
native NPZ reader (``native/``) and its prefetch pool.

Two replacements keep it free of packages the GPU machine lacks: the CSV's
``filename`` column is read with the stdlib ``csv`` module (pandas in the JAX
package) and the bilinear resize is numpy (cv2 there), with the same
convention: half-pixel centres, clamped edges, no anti-aliasing.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

import numpy as np

from ...utils.registry import DATASET_REGISTRY

MED_ATTRIBUTES = ("race", "language", "ethnicity", "gender", "maritalstatus", "hispanic")


def _bilinear_taps(n_in: int, n_out: int):
    """Source rows (lower, upper) and the upper weight for each output row,
    as cv2.INTER_LINEAR computes them: half-pixel centres, a source
    coordinate below 0 clamped to 0, the upper tap clamped to the last row."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.maximum(src, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _resize2d(img: np.ndarray, res: int) -> np.ndarray:
    """Bilinear resize of a 2D image to ``(res, res)`` in float32, the
    convention of the JAX package's ``cv2.resize(..., INTER_LINEAR)``
    (itself standing in for the reference's skimage resize, PARITY.md §2.5).
    Agrees with it to float rounding."""
    img = img.astype(np.float32)
    y0, y1, wy = _bilinear_taps(img.shape[0], res)
    x0, x1, wx = _bilinear_taps(img.shape[1], res)
    rows = img[y0] * (1.0 - wy)[:, None] + img[y1] * wy[:, None]
    return rows[:, x0] * (1.0 - wx) + rows[:, x1] * wx


def group_histogram(vals: np.ndarray) -> List[int]:
    """Group-size histogram over [0..max seen group id], ignoring -1/unknown
    (reference data_manager.py:443-460 semantics).  The width depends on the
    observed ids: the CLI zero-pads ragged per-client widths."""
    vals = np.asarray(vals)
    if vals.size == 0:
        return []
    return np.bincount(vals[vals >= 0], minlength=int(vals.max()) + 1).tolist()


class FairFedMedDataset:
    """One site's split; lazily decodes NPZs, eagerly indexes metadata."""

    # members each modality needs from the NPZ
    _MODALITY_MEMBERS = {
        "slo_fundus": ("slo_fundus",), "oct_bscans": ("oct_bscans",),
        "oct_bscans_3d": ("oct_bscans",), "rnflt": ("rnflt",), "ilm": ("ilm",),
        "rnflt+ilm": ("rnflt", "ilm"), "clockhours": ("clockhours",),
    }
    _pool = None  # shared native prefetch pool (lazy)

    def __init__(
        self,
        base_path: str,
        site: int,
        attribute_type: Optional[str] = None,
        attributes: Optional[List[str]] = None,
        modality_type: Optional[str] = None,
        resolution: int = 224,
        depth: int = 3,
        train: bool = True,
        use_index_cache: bool = True,
    ):
        self.base_path = base_path
        self.data_path = os.path.join(base_path, "all")
        if modality_type not in self._MODALITY_MEMBERS:
            # the reference raises NotImplementedError (data_utils.py:608-609);
            # the presence filter would otherwise give an empty dataset
            raise NotImplementedError(
                f"unknown modality_type {modality_type!r}; one of "
                f"{sorted(self._MODALITY_MEMBERS)}")
        self.modality_type = modality_type
        self.attribute_type = attribute_type
        self.attributes = list(attributes or [])
        self.resolution = resolution
        self.depth = depth

        split = "train" if train else "test"
        csv_path = os.path.join(base_path, f"meta_site{site}_{attribute_type}_{split}.csv")
        filenames = _read_filename_column(csv_path)
        index = self._load_or_build_index(csv_path, filenames, use_index_cache)

        # filter: attribute known (> -1) and target modality non-empty
        self.data_files: List[str] = []
        self.data_attrs: List[int] = []
        self._labels: List[int] = []
        self._attr_rows: List[List[int]] = []
        needed = self._MODALITY_MEMBERS[modality_type]
        for fname in filenames:
            meta = index[fname]
            if attribute_type and attribute_type not in meta["attrs"]:
                # the reference raises KeyError on raw_data[attribute_type]
                raise KeyError(
                    f"attribute {attribute_type!r} missing from {fname} "
                    f"(available: {sorted(meta['attrs'])})")
            attr = meta["attrs"].get(attribute_type, 0)
            if attribute_type in MED_ATTRIBUTES and attr <= -1:
                continue
            if not all(meta["modalities"].get(mk, False) for mk in needed):
                continue
            self.data_files.append(fname)
            self.data_attrs.append(attr)
            self._labels.append(meta["label"])
            row = []
            for k in self.attributes:
                if k not in meta["attrs"]:
                    # reference data_utils.py:724 raises KeyError on raw_data[k]
                    raise KeyError(
                        f"attribute {k!r} missing from {fname} "
                        f"(available: {sorted(meta['attrs'])})")
                row.append(meta["attrs"][k])
            self._attr_rows.append(row)

    # ---------------------------------------------------------------- index
    def _load_or_build_index(self, csv_path, filenames, use_cache):
        cache_path = csv_path + ".index.json"
        keys = set(self.attributes) | ({self.attribute_type} if self.attribute_type else set())
        if use_cache and os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    cached = json.load(f)
            except (json.JSONDecodeError, OSError):
                cached = {}  # a torn or unreadable sidecar is rebuilt
            # the sidecar must cover the files, the attribute keys it was
            # built with, and the NPZs' current mtimes
            cached_keys = set(cached.get("__attr_keys__", []))
            entries = {k: v for k, v in cached.items() if k != "__attr_keys__"}
            if set(filenames).issubset(entries) and keys.issubset(cached_keys):
                fresh = all(
                    abs(entries[f].get("mtime", -1.0)
                        - os.path.getmtime(os.path.join(self.data_path, f))) < 1e-6
                    for f in filenames)
                if fresh:
                    return entries
        index = {}
        for fname in filenames:
            path = os.path.join(self.data_path, fname)
            with np.load(path, allow_pickle=True) as raw:
                attrs = {k: int(raw[k]) for k in keys if k in raw}
                modalities = {mk: mk in raw.files and np.size(raw[mk]) > 0
                              for mk in ("slo_fundus", "oct_bscans", "rnflt", "ilm", "clockhours")}
                label = int(float(raw["glaucoma"])) if "glaucoma" in raw.files else 0
            index[fname] = {"attrs": attrs, "modalities": modalities, "label": label,
                            "mtime": os.path.getmtime(path)}
        if use_cache:
            # atomic publish (temp name + rename): a writer killed mid-dump
            # never leaves a torn sidecar
            try:
                tmp_path = f"{cache_path}.{os.getpid()}.tmp"
                with open(tmp_path, "w") as f:
                    json.dump({**index, "__attr_keys__": sorted(keys)}, f)
                os.replace(tmp_path, cache_path)
            except OSError:
                pass
        return index

    # ---------------------------------------------------------------- access
    def __len__(self):
        return len(self.data_files)

    @property
    def labels(self) -> np.ndarray:
        return np.asarray(self._labels, np.int32)

    @property
    def attrs_matrix(self) -> np.ndarray:
        """[len(self), num_attributes] int32."""
        return np.asarray(self._attr_rows, np.int32).reshape(len(self), len(self.attributes))

    def count_by_attribute(self, attr: str) -> List[int]:
        """Group-size histogram [0..max_group] (data_manager.py:443-460)."""
        col = self.attributes.index(attr) if attr in self.attributes else None
        vals = (self.attrs_matrix[:, col] if col is not None
                else np.asarray(self.data_attrs, np.int32))
        return group_histogram(vals)

    @classmethod
    def _get_pool(cls):
        if cls._pool is None:
            from ...native import PrefetchPool
            cls._pool = PrefetchPool(n_threads=2)
        return cls._pool

    def prefetch(self, idxs):
        """Queue upcoming samples' NPZ members on the native decode pool
        (C++ threads outside the GIL), overlapping decode with the step."""
        if not hasattr(self, "_tickets"):
            self._tickets = {}
        pool = self._get_pool()
        for i in idxs:
            i = int(i)
            if i in self._tickets:
                continue
            path = os.path.join(self.data_path, self.data_files[i])
            members = self._MODALITY_MEMBERS[self.modality_type]
            self._tickets[i] = {mk: pool.submit(path, mk) for mk in members}

    def clear_prefetch(self):
        """Drop uncollected prefetch tickets (an interrupted epoch) so their
        decoded payloads do not accumulate in the native ticket map."""
        tickets = getattr(self, "_tickets", None)
        if not tickets:
            return
        pool = self._get_pool()
        for entry in tickets.values():
            for t in entry.values():
                pool.discard(t)
        tickets.clear()

    def _raw_members(self, i: int) -> dict:
        tickets = getattr(self, "_tickets", {}).pop(i, None)
        if tickets is not None:
            pool = self._get_pool()
            return {mk: pool.collect(t) for mk, t in tickets.items()}
        from ...native import NpzReader

        path = os.path.join(self.data_path, self.data_files[i])
        with NpzReader(path) as r:
            return {mk: r.get(mk) for mk in self._MODALITY_MEMBERS[self.modality_type]}

    def load_item(self, i: int):
        """Decode one sample -> (image float32 [C,H,W] on the raw 0-255
        scale, label, attrs int vector).  Modality branches mirror
        data_utils.py:624-713; label and attrs come from the index."""
        m = self.modality_type
        raw = self._raw_members(i)
        res = self.resolution

        if m == "slo_fundus":
            img = np.transpose(raw["slo_fundus"]).astype(np.float32)
            # height-only trigger like the reference (data_utils.py:669): a
            # width-only mismatch passes through un-resized
            if img.shape[0] != res:
                img = _resize2d(img, res)
            img = img[None]
            if self.depth > 1:
                img = np.repeat(img, self.depth, axis=0)
        elif m == "oct_bscans":
            oct_img = raw["oct_bscans"][::4].astype(np.float32)  # 128 -> 32 slices
            if oct_img.shape[1] != res:
                oct_img = np.stack([_resize2d(s, res) for s in oct_img])
            img = oct_img
        elif m == "oct_bscans_3d":
            # each voxel floored through an integer before the float cast
            # (data_utils.py:655-656 astype(int).astype(np.float32)): the
            # identity for uint8 sites, not for float-valued volumes
            img = raw["oct_bscans"].astype(np.int64).astype(np.float32)[None]
        elif m == "rnflt":
            img = raw["rnflt"].astype(np.float32)
            if img.shape[0] != res:
                img = _resize2d(img, res)
            img = img[None]
            if self.depth > 1:
                img = np.repeat(img, self.depth, axis=0)
        elif m == "ilm":
            img = raw["ilm"].astype(np.float32)
            img = img - img.min()
            if img.shape[0] != res:
                img = _resize2d(img, res)
            img = img[None]
            if self.depth > 1:
                img = np.repeat(img, self.depth, axis=0)
        elif m == "rnflt+ilm":
            rn = raw["rnflt"].astype(np.float32)
            if rn.shape[0] != res:
                rn = _resize2d(rn, res)
            il = raw["ilm"].astype(np.float32)
            il = il - il.min()
            if il.shape[0] != res:
                il = _resize2d(il, res)
            rn, il = rn[None], il[None]
            if self.depth > 1:
                rn = np.repeat(rn, self.depth, axis=0)
                il = np.repeat(il, self.depth, axis=0)
            img = np.concatenate([rn, il], axis=0)
        else:  # clockhours
            img = raw["clockhours"].astype(np.float32)

        label = self._labels[i]
        attrs = np.asarray(self._attr_rows[i], np.int32)
        return img.astype(np.float32), label, attrs

    def load_item_u8(self, i: int):
        """The uint8 decode for the client-parallel runner's device caches
        (JAX fairfedmed.py:316-346): ``(image uint8 [C, H, W], label,
        attrs)``, equal to ``load_item``'s values, or None where the modality
        needs float work (a resize, a min-shift, a float source).  It skips
        the fp32 copies, four times the bytes of the payload."""
        m = self.modality_type
        res = self.resolution
        if m not in ("slo_fundus", "oct_bscans", "oct_bscans_3d"):
            return None
        raw = self._raw_members(i)
        src = raw["slo_fundus"] if m == "slo_fundus" else raw["oct_bscans"]
        if src.dtype != np.uint8:
            return None
        if m == "slo_fundus":
            img = np.transpose(src)
            if img.shape[0] != res or img.shape[1] != res:
                return None  # needs float interpolation
            img = img[None]
            if self.depth > 1:
                img = np.repeat(img, self.depth, axis=0)
        elif m == "oct_bscans":
            img = src[::4]  # 128 -> 32 slices
            if img.shape[1] != res:
                return None
        else:  # oct_bscans_3d
            img = src[None]
        label = self._labels[i]
        attrs = np.asarray(self._attr_rows[i], np.int32)
        return np.ascontiguousarray(img), label, attrs


def _read_filename_column(csv_path: str) -> List[str]:
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if "filename" not in (reader.fieldnames or ()):
            raise AssertionError("filename must be included in the head")
        return [row["filename"] for row in reader]


@DATASET_REGISTRY.register()
class FairFedMed:
    """3-site FL dataset; classes {NOT Glaucoma, Glaucoma}
    (datasets/FairFedMed.py:7-48)."""

    dataset_dir = "fairfedmed"

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
                modality_type=cfg.DATASET.MODALITY_TYPE,
                resolution=size,  # the reference hardcodes 224 and asserts
                depth=3,          # INPUT.SIZE == clip resolution; this follows SIZE
            )
            self.federated_train_x.append(FairFedMedDataset(train=True, **common))
            self.federated_test_x.append(FairFedMedDataset(train=False, **common))

        self.lab2cname = {0: "NOT Glaucoma", 1: "Glaucoma"}
        # the reference stores classnames as a python set (unstable order);
        # the documented order is fixed here
        self.classnames = ["NOT Glaucoma", "Glaucoma"]
