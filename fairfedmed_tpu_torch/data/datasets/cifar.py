"""CIFAR-10/100 federated datasets with non-IID partitioning.

The port's own copy of the JAX package's ``data/datasets/cifar.py``
(datasets/cifar10.py + utils/dataloader.py:308-345 semantics), reading the
standard CIFAR python pickle batches directly (no torchvision).  Images stay
in memory as uint8 HWC and items carry no attributes; the normalisation and
the 32 -> ``INPUT.SIZE`` bilinear resize run on the device inside the
trainers' step (``data/transforms.py:CifarPreprocess``): normalisation is a
per-channel affine map, so it commutes with the resize.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..partition import partition_indices

# hardcoded channel stats (Dassl/dassl/data/data_manager.py:368-377)
CIFAR10_MEAN, CIFAR10_STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
CIFAR100_MEAN, CIFAR100_STD = (0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)
MEAN_STD = {"Cifar10": (CIFAR10_MEAN, CIFAR10_STD), "Cifar100": (CIFAR100_MEAN, CIFAR100_STD)}


def _unpickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar10_arrays(datadir: str):
    d = os.path.join(datadir, "cifar-10-batches-py")
    xs, ys = [], []
    for i in range(1, 6):
        b = _unpickle(os.path.join(d, f"data_batch_{i}"))
        xs.append(b["data"])
        ys.extend(b["labels"])
    X_train = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_train = np.asarray(ys, np.int64)
    tb = _unpickle(os.path.join(d, "test_batch"))
    X_test = np.asarray(tb["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_test = np.asarray(tb["labels"], np.int64)
    meta = _unpickle(os.path.join(d, "batches.meta"))
    classnames = list(meta["label_names"])
    return X_train.astype(np.uint8), y_train, X_test.astype(np.uint8), y_test, classnames


def load_cifar100_arrays(datadir: str):
    d = os.path.join(datadir, "cifar-100-python")
    tr = _unpickle(os.path.join(d, "train"))
    te = _unpickle(os.path.join(d, "test"))
    X_train = np.asarray(tr["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_train = np.asarray(tr["fine_labels"], np.int64)
    X_test = np.asarray(te["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_test = np.asarray(te["fine_labels"], np.int64)
    meta = _unpickle(os.path.join(d, "meta"))
    classnames = list(meta["fine_label_names"])
    return X_train.astype(np.uint8), y_train, X_test.astype(np.uint8), y_test, classnames


class ArrayClientSplit:
    """One client's in-memory array shard, loader-compatible."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images = images
        self.labels_arr = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.labels_arr)

    @property
    def labels(self) -> np.ndarray:
        return self.labels_arr

    def load_item(self, i: int):
        return self.images[i], int(self.labels_arr[i]), None


def build_client_splits(cfg, X_train, y_train, X_test, y_test, num_classes: int,
                        expand=None):
    """Partition label arrays per cfg and wrap each client's slice in
    ArrayClientSplit, for every array dataset (CIFAR, the MNIST family,
    FEMNIST).  ``expand`` maps a raw image array to the loader's layout
    (e.g. adding a channel axis)."""
    expand = expand or (lambda x: x)
    idx_train, idx_test = partition_indices(
        y_train, y_test, cfg.DATASET.PARTITION, cfg.DATASET.USERS,
        beta=cfg.DATASET.BETA, num_classes=num_classes)
    fed_train = [ArrayClientSplit(expand(X_train[idx_train[i]]), y_train[idx_train[i]])
                 for i in range(cfg.DATASET.USERS)]
    fed_test = [ArrayClientSplit(expand(X_test[idx_test[i]]), y_test[idx_test[i]])
                for i in range(cfg.DATASET.USERS)]
    return fed_train, fed_test


class _CifarBase:
    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        X_train, y_train, X_test, y_test, classnames = type(self).load_arrays(self.dataset_dir)
        self.num_classes = len(classnames)
        self.federated_train_x, self.federated_test_x = build_client_splits(
            cfg, X_train, y_train, X_test, y_test, self.num_classes)
        self.classnames = classnames
        self.lab2cname = {i: c for i, c in enumerate(classnames)}


@DATASET_REGISTRY.register()
class Cifar10(_CifarBase):
    dataset_dir = "cifar-10"
    load_arrays = staticmethod(load_cifar10_arrays)


@DATASET_REGISTRY.register()
class Cifar100(_CifarBase):
    dataset_dir = "cifar-100"
    load_arrays = staticmethod(load_cifar100_arrays)
