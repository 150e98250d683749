"""DataManager and per-client batch loaders.

The port's own copy of the JAX package's ``data/manager.py``, which replaces
Dassl/dassl/data/data_manager.py:62-239's DataLoader machinery with host-side
numpy batching:

* train loaders drop the last incomplete batch like the reference
  (drop_last=is_train when the client has at least batch_size samples); test
  loaders pad the final batch to full size and report ``n_valid``, so every
  forward runs at one shape and the evaluator slices on the host;
* per-client loaders sit in ``fed_train_loader_x_dict`` /
  ``fed_test_loader_x_dict`` keyed by client index, as in the reference;
* shuffling draws from numpy's global RNG (``np.random.permutation``), which
  the CLI seeds, so one seed gives the same batches here and in the JAX
  package;
* a structured ``DATALOADER.TRAIN_X.SAMPLER`` needs a dataset with a Datum
  list (``.items``); a client dataset without one (FairFedMed) shuffles at
  random after one warning, as in the JAX package.  The samplers themselves
  are not ported yet (ROADMAP M14b).

``prefetch_to_device`` keeps the next batches on the device while the host
decodes, with pinned host memory and non-blocking copies on CUDA.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..utils.registry import DATASET_REGISTRY
from ..utils.tools import ascii_table
from .transforms import build_transform


def build_dataset(cfg):
    from . import datasets  # noqa: F401  (registers the ported datasets)

    name = cfg.DATASET.NAME
    if name not in DATASET_REGISTRY.registered_names():
        raise NotImplementedError(f"dataset {name!r} is not ported yet (ROADMAP M14); "
                                  f"ported: {DATASET_REGISTRY.registered_names()}")
    return DATASET_REGISTRY.get(name)(cfg)


class ClientLoader:
    """Batches one client's dataset.

    ``dataset`` needs ``__len__`` and ``load_item(i) -> (img, label, attrs|None)``;
    optional ``labels``/``attrs_matrix``/``count_by_attribute`` pass through,
    and ``prefetch``/``clear_prefetch`` when present queue the next batch on
    the native decode pool.
    """

    def __init__(self, dataset, batch_size: int, is_train: bool,
                 transform=None, pad_final: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.is_train = is_train
        self.transform = transform
        self.pad_final = pad_final and not is_train

    def _drop_last(self, n_stream: int) -> bool:
        return self.is_train and n_stream >= self.batch_size

    def __len__(self):
        n = len(self.dataset)
        if self._drop_last(n):
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        n = len(self.dataset)
        if self.is_train:
            return np.random.permutation(n)
        return np.arange(n)

    def __iter__(self):
        idxs = self._indices()
        n = len(idxs)
        bs = self.batch_size
        stop = (n // bs) * bs if self._drop_last(n) else n
        can_prefetch = hasattr(self.dataset, "prefetch")
        try:
            if can_prefetch and stop > 0:
                self.dataset.prefetch([int(i) for i in idxs[:bs]])
            for start in range(0, stop, bs):
                chunk = idxs[start:start + bs]
                if can_prefetch and start + bs < stop:
                    # queue the next batch on the native decode pool while
                    # this one is assembled and the device is busy
                    self.dataset.prefetch([int(i) for i in idxs[start + bs:start + 2 * bs]])
                n_valid = len(chunk)
                if self.pad_final and 0 < n_valid < bs:
                    chunk = np.resize(chunk, bs)  # cycle earlier indices as padding
                imgs, labels, attrs = [], [], []
                for i in chunk:
                    img, label, attr = self.dataset.load_item(int(i))
                    if self.transform is not None:
                        img = self.transform(img)
                    imgs.append(img)
                    labels.append(label)
                    if attr is not None:
                        attrs.append(attr)
                batch = {
                    "img": np.stack(imgs),
                    "label": np.asarray(labels, np.int32),
                    "n_valid": n_valid,
                }
                if attrs:
                    if len(attrs) != len(chunk):
                        # a mixed None/non-None stream would pair samples with
                        # other samples' demographics
                        raise ValueError(
                            f"dataset returned attrs for {len(attrs)} of "
                            f"{len(chunk)} items in one batch; per-item attrs "
                            "must be uniformly present or uniformly None")
                    batch["attrs"] = np.stack(attrs).astype(np.int32)
                yield batch
        finally:
            # an interrupted epoch leaves queued tickets whose decoded
            # payloads would otherwise stay in the native ticket map
            if can_prefetch and hasattr(self.dataset, "clear_prefetch"):
                self.dataset.clear_prefetch()


class DataManager:
    """Builds the dataset and one train + one test loader per client."""

    def __init__(self, cfg):
        self.cfg = cfg
        dataset = build_dataset(cfg)
        self.dataset = dataset
        tfm_train = build_transform(cfg, is_train=True)
        tfm_test = build_transform(cfg, is_train=False)
        stype = cfg.DATALOADER.TRAIN_X.SAMPLER

        self.fed_train_loader_x_dict = {}
        self.fed_test_loader_x_dict = {}
        warned_sampler = False
        for idx in range(cfg.DATASET.USERS):
            client_ds = dataset.federated_train_x[idx]
            if stype not in ("RandomSampler", "SequentialSampler"):
                # structured samplers need a Datum list (JAX manager.py:141-158)
                if hasattr(client_ds, "items"):
                    raise NotImplementedError(f"sampler {stype!r} is not ported yet "
                                              "(ROADMAP M14b: data/samplers.py)")
                if not warned_sampler:  # once, on the first client it concerns
                    warned_sampler = True
                    print(f"WARNING: sampler {stype!r} requires a Datum-list "
                          f"dataset (.items); {type(client_ds).__name__} has "
                          f"none (client {idx}) — falling back to random "
                          "shuffling")
            self.fed_train_loader_x_dict[idx] = ClientLoader(
                client_ds,
                batch_size=cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                is_train=True,
                transform=tfm_train,
            )
            self.fed_test_loader_x_dict[idx] = ClientLoader(
                dataset.federated_test_x[idx],
                batch_size=cfg.DATALOADER.TEST.BATCH_SIZE,
                is_train=False,
                transform=tfm_test,
            )

        self._num_classes = dataset.num_classes
        self._lab2cname = dataset.lab2cname
        if cfg.VERBOSE:
            self.show_dataset_summary(cfg)

    @property
    def num_classes(self):
        return self._num_classes

    @property
    def lab2cname(self):
        return self._lab2cname

    def show_dataset_summary(self, cfg):
        rows = [
            ["Dataset", cfg.DATASET.NAME],
            ["# classes", f"{self.num_classes:,}"],
            ["# clients", f"{cfg.DATASET.USERS:,}"],
        ]
        for idx in range(cfg.DATASET.USERS):
            rows.append([
                f"client {idx} train/test",
                f"{len(self.fed_train_loader_x_dict[idx].dataset):,} / "
                f"{len(self.fed_test_loader_x_dict[idx].dataset):,}",
            ])
        print(ascii_table(["Field", "Value"], rows))


def _to_device(value, device: torch.device):
    """An array of the batch as a tensor on ``device``: pinned and copied
    without blocking on CUDA; on the CPU only wrapped as a tensor."""
    if not hasattr(value, "shape"):
        return value  # e.g. n_valid
    t = torch.as_tensor(value)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(loader, size: int = 2, device="cpu"):
    """Software pipeline (the JAX package's data/manager.py:201-224): keep
    ``size`` batches on ``device`` ahead of the consumer while the host
    decodes the next ones."""
    device = torch.device(device)
    it = iter(loader)
    queue = collections.deque()

    def enqueue(n):
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            queue.append({k: _to_device(v, device) for k, v in batch.items()})

    enqueue(size)
    while queue:
        out = queue.popleft()
        enqueue(1)
        yield out
