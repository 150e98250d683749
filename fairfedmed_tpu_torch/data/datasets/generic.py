"""Generic FL benchmark datasets: MNIST / FashionMNIST / SVHN / FEMNIST /
CelebA / Shakespeare characters.

Capability parity with the reference's torchvision-truncated family
(``utils/dataset.py:65-941`` and the ``load_*_data`` helpers in
``utils/dataloader.py:260-380``), rebuilt torch-free: idx-ubyte readers for
(Fashion)MNIST, scipy ``loadmat`` for SVHN, the Leaf FEMNIST processed tensors
(read via torch.load — cpu torch ships in the image — with a numpy ``.npz``
alternative), CelebA attr-txt parsing, and a numpy ``CharacterDataset`` for
next-character prediction over ``string.printable``.

Each loader returns plain arrays; the registry classes reuse the
``partition_indices`` non-IID splitters and ``ArrayClientSplit`` per-client
shards exactly like CIFAR.

The port's own copy of the JAX package's ``data/datasets/generic.py``.  The
array datasets' uint8 HWC images go through the host transform pipeline
(``..transforms``), where MNIST's one channel becomes three by numpy's
broadcast against the 3-channel mean and std, as in the JAX package.
"""

from __future__ import annotations

import gzip
import os
import string
import struct
from typing import List

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from .cifar import build_client_splits


# --------------------------------------------------------------------------
# raw-format readers
# --------------------------------------------------------------------------

def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx(path: str) -> np.ndarray:
    """Read an idx-ubyte file (the MNIST container format)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist_arrays(datadir: str, fashion: bool = False):
    """(X_train u8 [N,28,28], y_train, X_test, y_test).  Looks for the raw
    idx files under <datadir>/<name>/raw/ or <datadir> directly."""
    name = "FashionMNIST" if fashion else "MNIST"
    candidates = [os.path.join(datadir, name, "raw"), os.path.join(datadir, name), datadir]
    base = next((c for c in candidates
                 if os.path.exists(os.path.join(c, "train-images-idx3-ubyte"))
                 or os.path.exists(os.path.join(c, "train-images-idx3-ubyte.gz"))), None)
    if base is None:
        raise FileNotFoundError(f"no idx files for {name} under {datadir}")
    X_train = read_idx(os.path.join(base, "train-images-idx3-ubyte"))
    y_train = read_idx(os.path.join(base, "train-labels-idx1-ubyte")).astype(np.int64)
    X_test = read_idx(os.path.join(base, "t10k-images-idx3-ubyte"))
    y_test = read_idx(os.path.join(base, "t10k-labels-idx1-ubyte")).astype(np.int64)
    return X_train, y_train, X_test, y_test


def load_svhn_arrays(datadir: str):
    """SVHN cropped-digit .mat files; labels remapped 10→0 like torchvision."""
    from scipy.io import loadmat

    def one(split):
        m = loadmat(os.path.join(datadir, f"{split}_32x32.mat"))
        X = np.transpose(m["X"], (3, 0, 1, 2))  # [N, 32, 32, 3] u8
        y = m["y"].reshape(-1).astype(np.int64)
        y[y == 10] = 0
        return X, y

    X_train, y_train = one("train")
    X_test, y_test = one("test")
    return X_train, y_train, X_test, y_test


def load_femnist_arrays(datadir: str):
    """Leaf-preprocessed FEMNIST: (X u8/float [N,28,28], y, writer_index).

    Accepts either the torch ``training.pt``/``test.pt`` tensors the reference
    loads (utils/dataset.py:737) or ``femnist_{train,test}.npz`` sidecars with
    data/targets/users keys.
    """
    processed = os.path.join(datadir, "FEMNIST", "processed")

    def one(split):
        npz = os.path.join(datadir, f"femnist_{split}.npz")
        if os.path.exists(npz):
            z = np.load(npz)
            return np.asarray(z["data"]), np.asarray(z["targets"], np.int64), np.asarray(z["users"])
        import torch

        fname = "training.pt" if split == "train" else "test.pt"
        data, targets, users = torch.load(os.path.join(processed, fname),
                                          weights_only=False)
        return (np.asarray(data), np.asarray(targets, dtype=np.int64),
                np.asarray(users))

    X_train, y_train, u_train = one("train")
    X_test, y_test, u_test = one("test")
    return X_train, y_train, u_train, X_test, y_test, u_test


def load_celeba_labels(datadir: str, target_attr: str = "Male"):
    """Parse list_attr_celeba.txt + list_eval_partition.txt →
    (train_files, y_train, test_files, y_test) with 0/1 labels
    (utils/dataloader.py:346-358 uses the Male attribute)."""
    attr_path = os.path.join(datadir, "list_attr_celeba.txt")
    part_path = os.path.join(datadir, "list_eval_partition.txt")
    with open(attr_path) as f:
        f.readline()  # count
        names = f.readline().split()
        col = names.index(target_attr)
        files, ys = [], []
        for line in f:
            parts = line.split()
            files.append(parts[0])
            ys.append(1 if int(parts[1 + col]) > 0 else 0)
    split = {}
    with open(part_path) as f:
        for line in f:
            fname, s = line.split()
            split[fname] = int(s)
    missing = [f_ for f_ in files if f_ not in split]
    if missing:
        # defaulting unlisted files to the TRAIN split would silently leak
        # test images into training on a truncated partition file
        raise ValueError(
            f"{part_path} is missing {len(missing)} files present in "
            f"{attr_path} (first: {missing[0]}); the partition file is "
            "truncated or mismatched")
    tr_f = [f_ for f_ in files if split[f_] == 0]
    te_f = [f_ for f_ in files if split[f_] == 2]
    y = dict(zip(files, ys))
    return (tr_f, np.asarray([y[f_] for f_ in tr_f], np.int64),
            te_f, np.asarray([y[f_] for f_ in te_f], np.int64))


class CharacterDataset:
    """Next-character prediction over string.printable
    (utils/dataset.py:892-941)."""

    def __init__(self, file_path: str, chunk_len: int):
        self.all_characters = string.printable
        self.vocab_size = self.n_characters = len(self.all_characters)
        self.chunk_len = chunk_len
        with open(file_path) as f:
            self.text = f.read()
        char2idx = {c: i for i, c in enumerate(self.all_characters)}
        self.tokenized_text = np.asarray([char2idx[c] for c in self.text], np.int64)
        n = len(self)
        # TRUE zero-copy strided views over the token array (the reference
        # slices per item, utils/dataset.py:892-941; materializing [n, chunk]
        # copies would cost ~2*chunk_len*8 bytes per character of text)
        if n:
            windows = np.lib.stride_tricks.sliding_window_view(
                self.tokenized_text, chunk_len)
            self.inputs = windows[:n]
            self.targets = windows[1 : n + 1]
        else:
            self.inputs = np.zeros((0, chunk_len), np.int64)
            self.targets = np.zeros((0, chunk_len), np.int64)

    def __len__(self):
        return max(0, len(self.text) - self.chunk_len)

    def __getitem__(self, idx):
        return self.inputs[idx], self.targets[idx], idx


# --------------------------------------------------------------------------
# registry classes (CIFAR-style array federated datasets)
# --------------------------------------------------------------------------

class _ArrayFederatedBase:
    """Shared: load arrays → partition → per-client ArrayClientSplit."""

    classnames: List[str] = []

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        X_train, y_train, X_test, y_test = self.load(root)
        self.num_classes = len(self.classnames)
        self.federated_train_x, self.federated_test_x = build_client_splits(
            cfg, X_train, y_train, X_test, y_test, self.num_classes)
        self.lab2cname = {i: c for i, c in enumerate(self.classnames)}

    def load(self, root):
        raise NotImplementedError


@DATASET_REGISTRY.register()
class Mnist(_ArrayFederatedBase):
    classnames = [str(i) for i in range(10)]

    def load(self, root):
        X_train, y_train, X_test, y_test = load_mnist_arrays(root)
        return X_train[..., None], y_train, X_test[..., None], y_test


@DATASET_REGISTRY.register()
class FashionMnist(_ArrayFederatedBase):
    classnames = ["T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
                  "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot"]

    def load(self, root):
        X_train, y_train, X_test, y_test = load_mnist_arrays(root, fashion=True)
        return X_train[..., None], y_train, X_test[..., None], y_test


@DATASET_REGISTRY.register()
class Svhn(_ArrayFederatedBase):
    classnames = [str(i) for i in range(10)]

    def load(self, root):
        return load_svhn_arrays(root)


@DATASET_REGISTRY.register()
class Femnist:
    """Writer-grouped federated split: clients = contiguous writer blocks
    (the Leaf-natural partition; utils/datasplit.py:66 uses label partition,
    this class additionally exposes the writer index)."""

    classnames = [str(i) for i in range(10)] + list(string.ascii_uppercase) + \
        list(string.ascii_lowercase)

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        X_train, y_train, u_train, X_test, y_test, u_test = load_femnist_arrays(root)
        self.num_classes = int(max(y_train.max(), y_test.max())) + 1
        self.federated_train_x, self.federated_test_x = build_client_splits(
            cfg, X_train, y_train, X_test, y_test, self.num_classes,
            expand=lambda x: x[..., None])
        self.users_index = u_train
        self.classnames = type(self).classnames[: self.num_classes]
        self.lab2cname = {i: c for i, c in enumerate(self.classnames)}
