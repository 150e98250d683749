"""Feature-skew federated datasets: DomainNet (6 domains) and
Office-Caltech-10 (4 domains).

Capability parity with the reference's domain benchmarks
(``datasets/domainnet.py:6-32``, ``datasets/office.py:6-35``,
``utils/data_utils.py:55-383,853-999``): each domain's samples come from a
numpy pickle ``<dir>/{site}_train.pkl`` / ``{site}_test.pkl`` holding
``(paths, text_labels)``; clients are either one-per-domain (no label skew)
or per-domain Dirichlet partitions (label skew added to the feature skew,
``SPLIT_CLIENT`` splits every domain into several clients).

The reference's IMBALANCE_TRAIN-without-SPLIT_CLIENT path crashes upstream
(it indexes a numpy array with the whole party→indices dict,
utils/data_utils.py:121 + :1068); here that mode keeps one client per domain
and assigns it Dirichlet party ``domain_index % USERS`` — documented
deviation, the shipped configs always set SPLIT_CLIENT for skewed runs.

The port's own copy of the JAX package's ``data/datasets/domain.py``, with
the same draws from numpy's global RNG.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ...utils.registry import DATASET_REGISTRY
from ..base import Datum, DatasetBase
from .fewshot import ImageListSplit


def dirichlet_partition_pair(train_labels: np.ndarray, test_labels: np.ndarray,
                             beta: float, n_parties: int, num_classes: int,
                             min_require_size: int = 2):
    """Per-class Dirichlet split applied with the SAME proportions to train
    and test indices (utils/data_utils.py:853-905 semantics, incl. the
    fixed np.random.seed(0) before each class shuffle and the cap that
    stops over-full parties receiving more)."""
    n_train = len(train_labels)
    min_size = 0
    attempt = 0
    while min_size < min_require_size:
        attempt += 1
        if attempt > 1000:
            # unsatisfiable requirement (e.g. a split with fewer than
            # n_parties*min_require_size samples) must error, not hang the
            # dataset constructor in an endless redraw loop
            raise ValueError(
                f"dirichlet_partition_pair: could not reach min_require_size="
                f"{min_require_size} for {n_parties} parties after 1000 "
                f"draws (train={n_train}, test={len(test_labels)} samples)")
        idx_train: List[List[int]] = [[] for _ in range(n_parties)]
        idx_test: List[List[int]] = [[] for _ in range(n_parties)]
        for k in range(num_classes):
            train_idx_k = np.where(train_labels == k)[0]
            test_idx_k = np.where(test_labels == k)[0]
            if attempt == 1:
                # reference resets the seed per class (data_utils.py:877);
                # with the seed reset, a failed first pass would repeat
                # IDENTICALLY forever — later attempts draw fresh randomness
                # (documented deviation that only changes the would-hang case)
                np.random.seed(0)
            np.random.shuffle(train_idx_k)
            np.random.shuffle(test_idx_k)
            proportions = np.random.dirichlet(np.repeat(beta, n_parties))
            proportions = np.array([
                p * (len(idx_j) < n_train / n_parties)
                for p, idx_j in zip(proportions, idx_train)
            ])
            proportions = proportions / proportions.sum()
            cut_train = (np.cumsum(proportions) * len(train_idx_k)).astype(int)[:-1]
            cut_test = (np.cumsum(proportions) * len(test_idx_k)).astype(int)[:-1]
            for j, (tr, te) in enumerate(zip(np.split(train_idx_k, cut_train),
                                             np.split(test_idx_k, cut_test))):
                idx_train[j].extend(tr.tolist())
                idx_test[j].extend(te.tolist())
        min_size = min(min(len(j) for j in idx_train), min(len(j) for j in idx_test))
    for j in range(n_parties):
        np.random.shuffle(idx_train[j])
        np.random.shuffle(idx_test[j])
    return idx_train, idx_test


class _DomainFederatedBase(DatasetBase):
    """Shared loader for pickle-backed domain datasets."""

    sites: Sequence[str] = ()
    pkl_subdir = ""
    label_dict: Dict[str, int] = {}
    clients_per_domain_split = 5  # SPLIT_CLIENT mode

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.pkl_subdir)
        sites = type(self).sites
        label_dict = type(self).label_dict
        num_classes = len(label_dict)

        fed_train: List[ImageListSplit] = []
        fed_test: List[ImageListSplit] = []
        for dom, site in enumerate(sites):
            tr_paths, tr_labels = self._load_pkl(root, site, "train")
            te_paths, te_labels = self._load_pkl(root, site, "test")
            tr_items = self._to_datums(root, tr_paths, tr_labels, dom)
            te_items = self._to_datums(root, te_paths, te_labels, dom)
            if not cfg.DATASET.IMBALANCE_TRAIN:
                fed_train.append(ImageListSplit(tr_items))
                fed_test.append(ImageListSplit(te_items))
                continue
            y_tr = np.asarray([label_dict[t] for t in tr_labels])
            y_te = np.asarray([label_dict[t] for t in te_labels])
            if cfg.DATASET.SPLIT_CLIENT:
                n_parties = type(self).clients_per_domain_split
                min_req = 2
            else:
                n_parties = max(cfg.DATASET.USERS, 1)
                min_req = 5
            idx_tr, idx_te = dirichlet_partition_pair(
                y_tr, y_te, cfg.DATASET.BETA, n_parties, num_classes, min_req)
            if cfg.DATASET.SPLIT_CLIENT:
                for j in range(n_parties):
                    fed_train.append(ImageListSplit([tr_items[i] for i in idx_tr[j]]))
                    fed_test.append(ImageListSplit([te_items[i] for i in idx_te[j]]))
            else:
                j = dom % n_parties
                fed_train.append(ImageListSplit([tr_items[i] for i in idx_tr[j]]))
                fed_test.append(ImageListSplit([te_items[i] for i in idx_te[j]]))

        classnames = [c for c, _ in sorted(label_dict.items(), key=lambda kv: kv[1])]
        lab2cname = {v: k for k, v in label_dict.items()}
        print("train_data_num_list:", [len(c) for c in fed_train])
        print("test_data_num_list:", [len(c) for c in fed_test])
        super().__init__(federated_train_x=fed_train, federated_test_x=fed_test,
                         lab2cname=lab2cname, classnames=classnames)

    def _load_pkl(self, root, site, split):
        path = os.path.join(self.dataset_dir, f"{site}_{split}.pkl")
        paths, labels = np.load(path, allow_pickle=True)
        return list(paths), list(labels)

    def _to_datums(self, root, paths, labels, domain):
        ld = type(self).label_dict
        return [Datum(impath=os.path.join(root, p), label=ld[t], domain=domain,
                      classname=t) for p, t in zip(paths, labels)]


@DATASET_REGISTRY.register()
class DomainNet(_DomainFederatedBase):
    sites = ("clipart", "infograph", "painting", "quickdraw", "real", "sketch")
    pkl_subdir = "DomainNet"
    label_dict = {"bird": 0, "feather": 1, "headphones": 2, "ice_cream": 3,
                  "teapot": 4, "tiger": 5, "whale": 6, "windmill": 7,
                  "wine_glass": 8, "zebra": 9}
    clients_per_domain_split = 5


@DATASET_REGISTRY.register()
class Office(_DomainFederatedBase):
    sites = ("amazon", "caltech", "dslr", "webcam")
    pkl_subdir = "office_caltech_10"
    label_dict = {"back_pack": 0, "bike": 1, "calculator": 2, "headphones": 3,
                  "keyboard": 4, "laptop_computer": 5, "monitor": 6,
                  "mouse": 7, "mug": 8, "projector": 9}
    clients_per_domain_split = 3
