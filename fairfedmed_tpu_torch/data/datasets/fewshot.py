"""Few-shot federated image-folder datasets: Caltech101, OxfordPets,
OxfordFlowers, Food101, DescribableTextures.

Capability parity with the reference's CoOp-style dataset family
(``datasets/caltech101.py:21-82``, ``datasets/oxford_pets.py:13-103``,
``datasets/oxford_flowers.py:15-80``, ``datasets/food101.py``,
``datasets/dtd.py:13-72``): each dataset resolves a train/val/test split
(``split_zhou_*.json`` if present, else built from the raw layout and saved),
optionally subsamples base/new class halves, then builds per-client federated
train/test lists via the class-partition splitters in ``..base``.

The port's own copy of the JAX package's ``data/datasets/fewshot.py``.
Images are JPEG/PNG paths decoded lazily with PIL (imported there) into
uint8 HWC arrays; the host transform pipeline (``..transforms``) crops,
resizes, flips and normalizes them, and the trainers pass the CHW batch on
unchanged.  ``load_split`` writes the split JSON into the dataset directory
when it is absent, as the JAX package does; the split is drawn from Python's
global ``random`` in the JAX package's order.
"""

from __future__ import annotations

import json
import math
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..base import (
    Datum, DatasetBase, generate_federated_dataset,
    generate_federated_fewshot_dataset, generate_fewshot_dataset,
)


def listdir_nohidden(path: str) -> List[str]:
    return sorted(f for f in os.listdir(path) if not f.startswith("."))


def read_split(filepath: str, path_prefix: str):
    """Load a split_zhou_*.json: {train,val,test: [(relpath, label, cname)]}
    (oxford_pets.py:152-167)."""
    with open(filepath) as f:
        split = json.load(f)

    def convert(items):
        return [Datum(impath=os.path.join(path_prefix, imp), label=int(lab),
                      classname=cname) for imp, lab, cname in items]

    return convert(split["train"]), convert(split["val"]), convert(split["test"])


def save_split(train, val, test, filepath: str, path_prefix: str):
    """Write the json split with paths relative to path_prefix
    (oxford_pets.py:129-149)."""
    def extract(items):
        out = []
        for item in items:
            imp = item.impath.replace(path_prefix, "").lstrip("/")
            out.append((imp, item.label, item.classname))
        return out

    os.makedirs(os.path.dirname(filepath), exist_ok=True)
    # atomic publish: a killed writer must not leave a torn split file
    tmp = f"{filepath}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"train": extract(train), "val": extract(val),
                   "test": extract(test)}, f, indent=1)
    os.replace(tmp, filepath)
    print(f"Saved split to {filepath}")


def split_trainval(trainval: Sequence[Datum], p_val: float = 0.2):
    """Per-class random val carve-out (oxford_pets.py:106-126)."""
    tracker = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item.label].append(idx)
    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            (val if n < n_val else train).append(trainval[idx])
    return train, val


def read_and_split_data(image_dir: str, p_trn: float = 0.5, p_val: float = 0.2,
                        ignored: Sequence[str] = (), new_cnames: Optional[Dict] = None):
    """Scan an images/<class>/<img> tree into train/val/test
    (dtd.py:75-110)."""
    categories = [c for c in listdir_nohidden(image_dir) if c not in ignored]
    categories.sort()
    train, val, test = [], [], []
    for label, category in enumerate(categories):
        category_dir = os.path.join(image_dir, category)
        images = [os.path.join(category_dir, im) for im in listdir_nohidden(category_dir)]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        assert n_train > 0 and n_val > 0 and n_total - n_train - n_val > 0
        cname = new_cnames[category] if new_cnames and category in new_cnames else category

        def collate(ims):
            return [Datum(impath=im, label=label, classname=cname) for im in ims]

        train.extend(collate(images[:n_train]))
        val.extend(collate(images[n_train : n_train + n_val]))
        test.extend(collate(images[n_train + n_val :]))
    return train, val, test


def subsample_classes(*datasets, subsample: str = "all"):
    """Keep base (first ceil(n/2)) or new (rest) class half, relabelled 0..m
    (oxford_pets.py:170-200)."""
    assert subsample in ("all", "base", "new")
    if subsample == "all":
        return datasets
    labels = sorted({item.label for item in datasets[0]})
    m = math.ceil(len(labels) / 2)
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabeler = {y: y_new for y_new, y in enumerate(selected)}
    out = []
    for dataset in datasets:
        out.append([Datum(impath=item.impath, label=relabeler[item.label],
                          domain=item.domain, classname=item.classname)
                    for item in dataset if item.label in relabeler])
    return tuple(out)


class ImageListSplit:
    """One client's list of path-backed Datums, ClientLoader-compatible."""

    def __init__(self, items: Sequence[Datum]):
        self.items = list(items)
        self.labels_arr = np.asarray([d.label for d in self.items], np.int32)

    def __len__(self):
        return len(self.items)

    @property
    def labels(self) -> np.ndarray:
        return self.labels_arr

    def load_item(self, i: int):
        from PIL import Image

        item = self.items[i]
        img = Image.open(item.impath).convert("RGB")
        return np.asarray(img, np.uint8), item.label, None


class FewShotFederatedDataset(DatasetBase):
    """Shared skeleton of the five CoOp-style datasets
    (caltech101.py:24-82 flow)."""

    dataset_dir = ""

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        total_train, val, test = self.load_split(cfg)

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            train = generate_fewshot_dataset(total_train, num_shots=num_shots, repeat=False)
            val = generate_fewshot_dataset(val, num_shots=min(num_shots, 4), repeat=False)
        else:
            train = total_train

        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)

        repeat_rate = self.repeat_rate(cfg)

        fed_train = fed_test = None
        if cfg.DATASET.USERS > 0:
            if cfg.DATASET.USEALL:
                fed_train = generate_federated_dataset(
                    total_train, cfg.DATASET.USERS, num_shots=num_shots,
                    is_iid=cfg.DATASET.IID, repeat_rate=repeat_rate)
            else:
                fed_train = generate_federated_fewshot_dataset(
                    total_train, cfg.DATASET.USERS, num_shots=num_shots,
                    is_iid=cfg.DATASET.IID, repeat_rate=repeat_rate)
            fed_test = generate_federated_dataset(
                test, cfg.DATASET.USERS, num_shots=num_shots,
                is_iid=cfg.DATASET.IID, repeat_rate=repeat_rate)
            fed_train = [ImageListSplit(c) for c in fed_train]
            fed_test = [ImageListSplit(c) for c in fed_test]

        lab2cname, classnames = self.get_lab2cname(test)
        super().__init__(train_x=train, test=test, federated_train_x=fed_train,
                         federated_test_x=fed_test, lab2cname=lab2cname,
                         classnames=classnames)

    # subclasses override -------------------------------------------------
    split_filename = ""
    image_subdir = "images"

    def load_split(self, cfg):
        image_dir = os.path.join(self.dataset_dir, type(self).image_subdir)
        split_path = os.path.join(self.dataset_dir, type(self).split_filename)
        if os.path.exists(split_path):
            return read_split(split_path, image_dir)
        train, val, test = self.build_split(cfg, image_dir)
        save_split(train, val, test, split_path, image_dir)
        return train, val, test

    def build_split(self, cfg, image_dir):
        raise NotImplementedError

    def repeat_rate(self, cfg) -> float:
        """Per-dataset overlap rate; subclasses override (OxfordPets pins
        0.1 for its 20-client setup, oxford_pets.py:60-65)."""
        return cfg.DATASET.REPEATRATE


@DATASET_REGISTRY.register()
class Caltech101(FewShotFederatedDataset):
    dataset_dir = "caltech-101"
    split_filename = "split_zhou_Caltech101.json"
    image_subdir = "101_ObjectCategories"
    IGNORED = ("BACKGROUND_Google", "Faces_easy")
    NEW_CNAMES = {"airplanes": "airplane", "Faces": "face",
                  "Leopards": "leopard", "Motorbikes": "motorbike"}

    def build_split(self, cfg, image_dir):
        return read_and_split_data(image_dir, ignored=self.IGNORED,
                                   new_cnames=self.NEW_CNAMES)


@DATASET_REGISTRY.register()
class OxfordPets(FewShotFederatedDataset):
    dataset_dir = "oxford_pets"
    split_filename = "split_zhou_OxfordPets.json"

    def repeat_rate(self, cfg) -> float:
        # hardcoded overlap for the 20-client setup (oxford_pets.py:60-65)
        return 0.1 if cfg.DATASET.USERS == 20 else cfg.DATASET.REPEATRATE

    def build_split(self, cfg, image_dir):
        trainval = self._read_anno(image_dir, "trainval.txt")
        test = self._read_anno(image_dir, "test.txt")
        train, val = split_trainval(trainval)
        return train, val, test

    def _read_anno(self, image_dir, split_file):
        """annotations/<split>.txt lines: imname label species breedid
        (oxford_pets.py:85-103)."""
        filepath = os.path.join(self.dataset_dir, "annotations", split_file)
        items = []
        with open(filepath) as f:
            for line in f:
                imname, label, _, _ = line.strip().split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                items.append(Datum(impath=os.path.join(image_dir, imname + ".jpg"),
                                   label=int(label) - 1, classname=breed))
        return items


@DATASET_REGISTRY.register()
class OxfordFlowers(FewShotFederatedDataset):
    dataset_dir = "oxford_flowers"
    split_filename = "split_zhou_OxfordFlowers.json"
    image_subdir = "jpg"

    def build_split(self, cfg, image_dir):
        """jpg/ + imagelabels.mat + cat_to_name.json
        (oxford_flowers.py:77-106 layout)."""
        from scipy.io import loadmat

        labels = loadmat(os.path.join(self.dataset_dir, "imagelabels.mat"))["labels"][0]
        with open(os.path.join(self.dataset_dir, "cat_to_name.json")) as f:
            cat_to_name = json.load(f)
        tracker = defaultdict(list)
        for i, label in enumerate(labels, start=1):
            tracker[int(label)].append(os.path.join(image_dir, f"image_{i:05d}.jpg"))
        train, val, test = [], [], []
        for label, impaths in tracker.items():
            random.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            cname = cat_to_name[str(label)]
            for j, imp in enumerate(impaths):
                item = Datum(impath=imp, label=label - 1, classname=cname)
                if j < n_train:
                    train.append(item)
                elif j < n_train + n_val:
                    val.append(item)
                else:
                    test.append(item)
        return train, val, test


@DATASET_REGISTRY.register()
class Food101(FewShotFederatedDataset):
    dataset_dir = "food-101"
    split_filename = "split_zhou_Food101.json"

    def build_split(self, cfg, image_dir):
        return read_and_split_data(image_dir)


@DATASET_REGISTRY.register()
class DescribableTextures(FewShotFederatedDataset):
    dataset_dir = "dtd"
    split_filename = "split_zhou_DescribableTextures.json"

    def build_split(self, cfg, image_dir):
        return read_and_split_data(image_dir)
