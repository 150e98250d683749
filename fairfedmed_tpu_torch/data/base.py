"""Dataset base structures (mirrors Dassl/dassl/data/datasets/base_dataset.py
and utils/data_utils.py:20-60).

The port's own copy of the JAX package's ``data/base.py``.  The few-shot and
federated splitters draw from Python's global ``random`` and re-seed it where
the reference does (``random.seed(2023)``), and the class assignment from its
own ``random.Random(seed)``, in the JAX package's order, so one seed gives the
same per-client splits in both packages.

``Datum`` carries either an in-memory array (``data``) or an image path
(``impath``); federated datasets expose ``federated_train_x`` /
``federated_test_x`` as per-client lists.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import List, Sequence


class Datum:
    """One sample: in-memory data or a path, plus label/domain/classname."""

    def __init__(self, impath: str = "", label: int = 0, domain: int = 0,
                 classname: str = "", data=None):
        self.impath = impath
        self.label = int(label)
        self.domain = int(domain)
        self.classname = classname
        self.data = data


class DatasetBase:
    """Federated dataset container.

    Sub-classes set ``federated_train_x``/``federated_test_x`` (lists of
    per-client sample lists or dataset objects), ``lab2cname`` and
    ``classnames``.
    """

    dataset_dir = ""

    def __init__(self, train_x=None, test=None, federated_train_x=None,
                 federated_test_x=None, lab2cname=None, classnames=None):
        self.train_x = train_x
        self.test = test
        self.federated_train_x = federated_train_x
        self.federated_test_x = federated_test_x
        self.lab2cname = lab2cname or {}
        self.classnames = classnames or []

    @property
    def num_classes(self) -> int:
        return len(self.classnames)

    @staticmethod
    def get_lab2cname(data_source: Sequence[Datum]):
        mapping = {item.label: item.classname for item in data_source}
        labels = sorted(mapping)
        lab2cname = {label: mapping[label] for label in labels}
        classnames = [mapping[label] for label in labels]
        return lab2cname, classnames


def split_dataset_by_label(data_source: Sequence[Datum]):
    out = defaultdict(list)
    for item in data_source:
        out[item.label].append(item)
    return out


def generate_fewshot_dataset(data_source: Sequence[Datum], num_shots: int,
                             repeat: bool = True) -> List[Datum]:
    """Sample a num_shots-per-class subset (base_dataset.py semantics)."""
    if num_shots < 1:
        return list(data_source)
    tracker = split_dataset_by_label(data_source)
    out = []
    for label, items in tracker.items():
        if len(items) >= num_shots:
            out.extend(random.sample(items, num_shots))
        elif repeat:
            out.extend(random.choices(items, k=num_shots))
        else:
            out.extend(items)
    return out


def assign_classes_to_users(class_num: int, num_users: int, num_shots: int,
                            is_iid: bool, repeat_rate: float, seed: int = 2023):
    """Class→client assignment shared by both federated splitters
    (base_dataset.py:251-305 and :360-437 semantics).

    Classes are shuffled with a fixed seed then handed out in contiguous
    chunks of ``round(class_num/num_users)``; the last client absorbs the
    remainder.  With ``repeat_rate``>0 the first ``int(repeat_rate*class_num)``
    shuffled classes are shared: either by every client, or — when
    ``fold = num_users//num_shots`` > 0 — split across client folds.

    Returns (user_class_dict, class_repeat_list).
    """
    class_list = list(range(class_num))
    r = random.Random(seed)
    r.shuffle(class_list)
    if is_iid:
        return {i: list(range(class_num)) for i in range(num_users)}, []

    if repeat_rate <= 0:
        cpu = int(round(class_num / num_users))
        out = {}
        for i in range(num_users):
            hi = class_num if i == num_users - 1 else (i + 1) * cpu
            out[i] = class_list[i * cpu : hi]
        return out, []

    repeat_num = int(repeat_rate * class_num)
    class_repeat = class_list[:repeat_num]
    class_norepeat = class_list[repeat_num:]
    cpu = int(round((class_num - repeat_num) / num_users))
    fold = int(num_users / num_shots) if num_shots > 0 else 0
    out = {i: [] for i in range(num_users)}
    if fold > 0:
        client_per_fold = int(round(num_users / fold))
        repeat_per_fold = int(round(repeat_num / fold))
        client_list = list(range(num_users))
        r.shuffle(client_list)
        folds = {k: client_list[k * client_per_fold : min((k + 1) * client_per_fold, num_users)]
                 for k in range(fold)}
        for i in range(num_users):
            for k, members in folds.items():
                if i in members:
                    hi = repeat_num if k == fold - 1 else (k + 1) * repeat_per_fold
                    out[i].extend(class_repeat[k * repeat_per_fold : hi])
    else:
        for i in range(num_users):
            out[i].extend(class_repeat)
    for i in range(num_users):
        hi = class_num - repeat_num if i == num_users - 1 else (i + 1) * cpu
        out[i].extend(class_norepeat[i * cpu : hi])
    return out, class_repeat


def generate_federated_fewshot_dataset(
    data_source: Sequence[Datum],
    num_users: int,
    num_shots: int = -1,
    is_iid: bool = False,
    repeat_rate: float = 0.0,
    repeat: bool = False,
) -> List[List[Datum]]:
    """Federated few-shot splits (base_dataset.py:223-339 semantics).

    Each client samples ``num_shots`` per owned class; shared (repeat) classes
    contribute ``max(num_shots//num_users, 1)`` shots instead so total overlap
    stays bounded.
    """
    if num_shots < 1:
        return [list(data_source) for _ in range(num_users)]
    # the reference reseeds the GLOBAL stream before sampling
    # (base_dataset.py:262 random.seed(2023)), making the per-client image
    # picks themselves fixed across runs — reproduce for split-level parity
    random.seed(2023)
    tracker = split_dataset_by_label(data_source)
    class_num = len({d.label for d in data_source})
    user_classes, class_repeat = assign_classes_to_users(
        class_num, num_users, num_shots, is_iid, repeat_rate)
    repeat_set = set(class_repeat)
    per_client: List[List[Datum]] = [[] for _ in range(num_users)]
    for i in range(num_users):
        owned = set(user_classes[i])
        for label, items in tracker.items():
            if label not in owned:
                continue
            if label in repeat_set:
                k = max(int(num_shots / num_users), 1)
                per_client[i].extend(random.sample(items, min(k, len(items))))
            elif len(items) >= num_shots:
                per_client[i].extend(random.sample(items, num_shots))
            elif repeat:
                per_client[i].extend(random.choices(items, k=num_shots))
            else:
                per_client[i].extend(items)
    return per_client


def generate_federated_dataset(
    data_source: Sequence[Datum],
    num_users: int,
    num_shots: int = -1,
    is_iid: bool = False,
    repeat_rate: float = 0.0,
) -> List[List[Datum]]:
    """Federated full-data splits — the USEALL path (base_dataset.py:341-480).

    iid: every class's samples are shuffled once and dealt to clients in
    disjoint ``round(len/num_users)`` slices.  non-iid: each client owns ALL
    samples of its assigned classes; shared (repeat) classes are dealt in
    disjoint per-client slices like iid.

    Reference quirk, mirrored deliberately: in fold mode (``repeat_rate>0``
    and ``num_users >= num_shots``) the per-client slice width grows to
    ``round(len / (num_users/fold))`` but is still indexed by the GLOBAL
    client index (base_dataset.py:402,457) — clients whose
    ``idx * width >= len(items)`` receive EMPTY slices for iid/repeat
    classes, exactly as upstream does.  Similarly ``assign_classes_to_users``
    leaves ``num_users - fold*round(num_users/fold)`` tail clients in no
    fold (no repeat classes), mirroring ``client_idx_fold`` coverage
    (base_dataset.py:386-392).
    """
    random.seed(2023)  # fixed sample order, as in base_dataset.py:368
    tracker = split_dataset_by_label(data_source)
    class_num = len({d.label for d in data_source})
    user_classes, class_repeat = assign_classes_to_users(
        class_num, num_users, num_shots, is_iid, repeat_rate)
    repeat_set = set(class_repeat)
    fold = int(num_users / num_shots) if (repeat_rate > 0 and num_shots > 0) else 0

    sample_order = {}
    sample_per_user = {}
    for label, items in tracker.items():
        order = list(range(len(items)))
        random.shuffle(order)
        sample_order[label] = order
        denom = (num_users / fold) if fold > 0 else num_users
        sample_per_user[label] = int(round(len(items) / denom))

    per_client: List[List[Datum]] = [[] for _ in range(num_users)]
    for i in range(num_users):
        owned = set(user_classes[i])
        for label, items in tracker.items():
            if label not in owned:
                continue
            if is_iid or label in repeat_set:
                spu = sample_per_user[label]
                chosen = set(sample_order[label][i * spu : min((i + 1) * spu, len(items))])
                per_client[i].extend(v for k, v in enumerate(items) if k in chosen)
            else:
                per_client[i].extend(items)
    return per_client
