"""Index samplers for domain/class-balanced minibatching.

The port's own copy of the JAX package's ``data/samplers.py``.  Capability
parity with ``Dassl/dassl/data/samplers.py:8-206``: Random /
Sequential plus the three structured samplers (RandomDomainSampler,
SeqDomainSampler, RandomClassSampler).  Samplers here are plain index-stream
factories (``__iter__`` yields sample indices) consumed by ``ClientLoader``;
randomness rides the global numpy/random RNG seeded by ``set_random_seed``,
matching the reference.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Sequence

import numpy as np


class RandomSampler:
    def __init__(self, data_source: Sequence):
        self.data_source = data_source

    def __iter__(self):
        return iter(np.random.permutation(len(self.data_source)).tolist())

    def __len__(self):
        return len(self.data_source)


class SequentialSampler:
    def __init__(self, data_source: Sequence):
        self.data_source = data_source

    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


def _group_by(data_source, key):
    groups = defaultdict(list)
    for i, item in enumerate(data_source):
        groups[key(item)].append(i)
    return groups


def _drain_domains(domain_dict, domain_order, n_img_per_domain):
    """Draw n_img_per_domain images per visited domain until any domain
    can't fill another draw (samplers.py:39-58 stop rule)."""
    pools = {d: list(v) for d, v in domain_dict.items()}
    final = []
    stop = False
    while not stop:
        for domain in domain_order():
            # check BEFORE drawing: the reference sets its stop flag but still
            # finishes the round, so a second short domain in the same round
            # would make random.sample raise ValueError and crash the epoch
            if len(pools[domain]) < n_img_per_domain:
                stop = True
                break
            idxs = random.sample(pools[domain], n_img_per_domain)
            final.extend(idxs)
            for idx in idxs:
                pools[domain].remove(idx)
            if len(pools[domain]) < n_img_per_domain:
                stop = True
    return final


class RandomDomainSampler:
    """N random domains × K images per minibatch (samplers.py:8-61)."""

    def __init__(self, data_source, batch_size: int, n_domain: int):
        self.domain_dict = _group_by(data_source, lambda it: it.domain)
        self.domains = list(self.domain_dict)
        if not n_domain or n_domain <= 0:
            n_domain = len(self.domains)
        assert batch_size % n_domain == 0
        self.n_domain = n_domain
        self.n_img_per_domain = batch_size // n_domain
        self.length = len(list(self.__iter__()))

    def __iter__(self):
        order = lambda: random.sample(self.domains, self.n_domain)
        return iter(_drain_domains(self.domain_dict, order, self.n_img_per_domain))

    def __len__(self):
        return self.length


class SeqDomainSampler:
    """Every domain in sorted order × K images per minibatch
    (samplers.py:63-115)."""

    def __init__(self, data_source, batch_size: int):
        self.domain_dict = _group_by(data_source, lambda it: it.domain)
        self.domains = sorted(self.domain_dict)
        assert batch_size % len(self.domains) == 0
        self.n_img_per_domain = batch_size // len(self.domains)
        self.length = len(list(self.__iter__()))

    def __iter__(self):
        order = lambda: list(self.domains)
        return iter(_drain_domains(self.domain_dict, order, self.n_img_per_domain))

    def __len__(self):
        return self.length


class RandomClassSampler:
    """N random classes × K instances per minibatch (samplers.py:117-179)."""

    def __init__(self, data_source, batch_size: int, n_ins: int):
        if batch_size < n_ins:
            raise ValueError(f"batch_size={batch_size} must be ≥ n_ins={n_ins}")
        self.batch_size = batch_size
        self.n_ins = n_ins
        self.ncls_per_batch = batch_size // n_ins
        self.index_dic = _group_by(data_source, lambda it: it.label)
        self.labels = list(self.index_dic)
        assert len(self.labels) >= self.ncls_per_batch
        self.length = len(list(self.__iter__()))

    def __iter__(self):
        batch_idxs_dict = defaultdict(list)
        for label in self.labels:
            idxs = list(self.index_dic[label])
            if len(idxs) < self.n_ins:
                idxs = np.random.choice(idxs, size=self.n_ins, replace=True).tolist()
            random.shuffle(idxs)
            for start in range(0, len(idxs) - self.n_ins + 1, self.n_ins):
                batch_idxs_dict[label].append(idxs[start : start + self.n_ins])
        avai = list(self.labels)
        final = []
        while len(avai) >= self.ncls_per_batch:
            for label in random.sample(avai, self.ncls_per_batch):
                final.extend(batch_idxs_dict[label].pop(0))
                if not batch_idxs_dict[label]:
                    avai.remove(label)
        return iter(final)

    def __len__(self):
        return self.length


def build_sampler(sampler_type: str, cfg=None, data_source=None,
                  batch_size: int = 32, n_domain: int = 0, n_ins: int = 16):
    """samplers.py:182-206 dispatch."""
    if sampler_type == "RandomSampler":
        return RandomSampler(data_source)
    if sampler_type == "SequentialSampler":
        return SequentialSampler(data_source)
    if sampler_type == "RandomDomainSampler":
        return RandomDomainSampler(data_source, batch_size, n_domain)
    if sampler_type == "SeqDomainSampler":
        return SeqDomainSampler(data_source, batch_size)
    if sampler_type == "RandomClassSampler":
        return RandomClassSampler(data_source, batch_size, n_ins)
    raise ValueError(f"Unknown sampler type: {sampler_type}")
