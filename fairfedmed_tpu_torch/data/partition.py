"""Non-IID data partitioners (mirrors utils/datasplit.py:47-480).

The port's own copy of the JAX package's ``data/partition.py``.  Every
partitioner takes label arrays and returns per-client index maps for the
train and test splits.  Randomness comes from numpy's global RNG and
Python's ``random`` (both seeded by ``set_random_seed``), like the
reference; ``iid-label100`` and ``noniid-labeldir100`` re-seed both, as the
reference does.  The draws are the JAX package's, in the same order, so the
CLI's later draws of users see the same global state in both packages.
"""

from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np

# CIFAR-100 fine→coarse label table (utils/datasplit.py:285-296)
CIFAR100_COARSE = np.array([
    4, 1, 14, 8, 0, 6, 7, 7, 18, 3,
    3, 14, 9, 18, 7, 11, 3, 9, 7, 11,
    6, 11, 5, 10, 7, 6, 13, 15, 3, 15,
    0, 11, 1, 10, 12, 14, 16, 9, 11, 5,
    5, 19, 8, 8, 15, 13, 14, 17, 18, 10,
    16, 4, 17, 4, 2, 0, 17, 4, 18, 17,
    10, 3, 2, 12, 12, 16, 12, 1, 9, 19,
    2, 10, 0, 1, 16, 12, 9, 13, 15, 13,
    16, 19, 2, 4, 6, 19, 5, 5, 8, 19,
    18, 1, 2, 15, 6, 0, 17, 8, 14, 13,
])

IndexMap = Dict[int, np.ndarray]


def partition_indices(
    y_train: np.ndarray,
    y_test: np.ndarray,
    partition: str,
    n_parties: int,
    beta: float = 0.4,
    num_classes: int | None = None,
) -> Tuple[IndexMap, IndexMap]:
    """Dispatch on the partition strategy names used by the reference CLI."""
    y_train = np.asarray(y_train)
    y_test = np.asarray(y_test)
    K = num_classes if num_classes is not None else int(max(y_train.max(), y_test.max())) + 1

    if partition == "homo":
        return _homo(y_train, y_test, n_parties)
    if partition == "noniid-labeldir":
        return _label_dirichlet(y_train, y_test, n_parties, beta, K)
    if partition == "noniid-labeluni":
        return _label_uniform_skewed(y_train, y_test, n_parties, K)
    if partition == "iid-label100":
        return _iid_label100(y_train, y_test, n_parties)
    if partition.startswith("noniid-#label"):
        k = int(partition[len("noniid-#label"):])
        return _label_quantity(y_train, y_test, n_parties, K, k)
    if partition == "noniid-labeldir100":
        return _hierarchical_dirichlet(y_train, y_test, n_parties, K, beta)
    raise ValueError(f"Unknown partition strategy: {partition}")


def _homo(y_train, y_test, n_parties):
    idxs_train = np.random.permutation(len(y_train))
    idxs_test = np.random.permutation(len(y_test))
    return (
        {i: c for i, c in enumerate(np.array_split(idxs_train, n_parties))},
        {i: c for i, c in enumerate(np.array_split(idxs_test, n_parties))},
    )


def _label_dirichlet(y_train, y_test, n_parties, beta, K, min_require_size=10):
    """Per-class Dirichlet split applied jointly to train+test
    (utils/datasplit.py:298-325): proportions are drawn once per class and
    capped so no client exceeds N/n_parties before renormalisation."""
    N_train = len(y_train)
    min_size = 0
    tries = 0
    while min_size < min_require_size:
        # The reference loops unconditionally (datasplit.py:298) — with a
        # test split smaller than min_require_size * n_parties it spins
        # FOREVER.  Each retry consumes the same RNG draws as the
        # reference, so results are identical wherever the reference
        # terminates; where it would hang, raise a diagnosis instead.
        tries += 1
        if tries > 1000:
            raise RuntimeError(
                f"noniid-labeldir cannot satisfy min_require_size="
                f"{min_require_size} for {n_parties} parties over "
                f"{len(y_train)} train / {len(y_test)} test samples after "
                "1000 redraws (the reference loops forever here) — use "
                "fewer parties or a larger split")
        idx_batch_train = [[] for _ in range(n_parties)]
        idx_batch_test = [[] for _ in range(n_parties)]
        for k in range(K):
            train_idx_k = np.where(y_train == k)[0]
            test_idx_k = np.where(y_test == k)[0]
            np.random.shuffle(train_idx_k)
            np.random.shuffle(test_idx_k)
            proportions = np.random.dirichlet(np.repeat(beta, n_parties))
            proportions = np.array([
                p * (len(idx_j) < N_train / n_parties)
                for p, idx_j in zip(proportions, idx_batch_train)
            ])
            proportions = proportions / proportions.sum()
            cut_train = (np.cumsum(proportions) * len(train_idx_k)).astype(int)[:-1]
            cut_test = (np.cumsum(proportions) * len(test_idx_k)).astype(int)[:-1]
            idx_batch_train = [a + b.tolist() for a, b in zip(idx_batch_train, np.split(train_idx_k, cut_train))]
            idx_batch_test = [a + b.tolist() for a, b in zip(idx_batch_test, np.split(test_idx_k, cut_test))]
            min_size = min(
                min(len(j) for j in idx_batch_train),
                min(len(j) for j in idx_batch_test),
            )
    out_train, out_test = {}, {}
    for j in range(n_parties):
        np.random.shuffle(idx_batch_train[j])
        np.random.shuffle(idx_batch_test[j])
        out_train[j] = np.asarray(idx_batch_train[j])
        out_test[j] = np.asarray(idx_batch_test[j])
    return out_train, out_test


def _label_uniform_skewed(y_train, y_test, n_parties, K):
    """``noniid-labeluni`` (utils/datasplit.py:201-279): each client holds
    ``num`` classes.  Every class is claimed exactly ``num*n_parties/K``
    times (greedy max-remaining-count draw), and each claim takes a
    uniform(0.4, 0.6)-normalized PROPORTION of the class's samples — a
    label-skewed split, NOT an even per-class division.  ``num`` follows the
    reference's per-dataset table (cifar10→2, cifar100→10, binary→1)."""
    table = {10: 2, 100: 10, 2: 1}
    if K not in table:
        raise ValueError(
            f"noniid-labeluni has no classes-per-client rule for K={K} "
            "(reference supports 10/100/2-class datasets)")
    num = table[K]
    assert (num * n_parties) % K == 0, "equal classes appearance is needed"
    count_per_class = (num * n_parties) // K
    class_dict = {}
    for i in range(K):
        probs = np.random.uniform(0.4, 0.6, size=count_per_class)
        class_dict[i] = {"count": count_per_class,
                         "prob": (probs / probs.sum()).tolist()}
    class_part = {"class": [], "prob": []}
    for _ in range(n_parties):
        c = []
        for _ in range(num):
            counts = [class_dict[i]["count"] for i in range(K)]
            max_ids = np.where(np.array(counts) == max(counts))[0]
            c.append(int(np.random.choice(max_ids)))
            class_dict[c[-1]]["count"] -= 1
        class_part["class"].append(c)
        class_part["prob"].append([class_dict[i]["prob"].pop() for i in c])

    data_idx_tr = {i: np.where(y_train == i)[0] for i in range(K)}
    data_idx_te = {i: np.where(y_test == i)[0] for i in range(K)}
    n_tr = {i: len(data_idx_tr[i]) for i in range(K)}
    n_te = {i: len(data_idx_te[i]) for i in range(K)}
    for v in data_idx_tr.values():
        random.shuffle(v)  # python-random shuffle, like the reference
    for v in data_idx_te.values():
        random.shuffle(v)
    out_tr = {i: np.ndarray(0, dtype=np.int64) for i in range(n_parties)}
    out_te = {i: np.ndarray(0, dtype=np.int64) for i in range(n_parties)}
    for u in range(n_parties):
        for c, p in zip(class_part["class"][u], class_part["prob"][u]):
            e_tr, e_te = int(n_tr[c] * p), int(n_te[c] * p)
            out_tr[u] = np.append(out_tr[u], data_idx_tr[c][:e_tr])
            out_te[u] = np.append(out_te[u], data_idx_te[c][:e_te])
            data_idx_tr[c] = data_idx_tr[c][e_tr:]
            data_idx_te[c] = data_idx_te[c][e_te:]
    return out_tr, out_te


def _iid_label100(y_train, y_test, n_parties):
    """``iid-label100`` (utils/datasplit.py:123-199): CIFAR-100 clustered by
    coarse label — clients ``5i..5i+4`` share coarse group ``i`` and each
    holds ``(N/n_parties)//5`` samples of each of its 5 fine labels.  The
    reference pins seed 12345 (and, as a side effect kept here for parity,
    reseeds the GLOBAL numpy RNG)."""
    seed = 12345
    rng = random.Random(seed)
    np.random.seed(seed)
    n_samples_tr, n_samples_te = len(y_train), len(y_test)
    sel_tr = rng.sample(range(n_samples_tr), n_samples_tr)
    sel_te = rng.sample(range(n_samples_te), n_samples_te)
    per_tr = int((n_samples_tr / n_parties) // 5)
    per_te = int((n_samples_te / n_parties) // 5)

    by_fine_tr = {k: [] for k in range(100)}
    by_fine_te = {k: [] for k in range(100)}
    for idx in sel_tr:
        by_fine_tr[int(y_train[idx])].append(idx)
    for idx in sel_te:
        by_fine_te[int(y_test[idx])].append(idx)
    fine_by_coarse = {k: [] for k in range(20)}
    for fine, coarse in enumerate(CIFAR100_COARSE):
        fine_by_coarse[int(coarse)].append(fine)

    out_tr = {i: np.ndarray(0, dtype=np.int64) for i in range(n_parties)}
    out_te = {i: np.ndarray(0, dtype=np.int64) for i in range(n_parties)}
    for by_fine, out, per in ((by_fine_tr, out_tr, per_tr),
                              (by_fine_te, out_te, per_te)):
        for u in range(n_parties):
            fines = fine_by_coarse[u // 5]
            for k in range(5):
                f = fines[k]
                pick = rng.sample(list(by_fine[f]), per)
                out[u] = np.append(out[u], pick)
                for idx in pick:
                    by_fine[f].remove(idx)
    return out_tr, out_te


def _label_quantity(y_train, y_test, n_parties, K, k_per_client):
    """noniid-#label{k}: each client holds k classes (utils/datasplit.py)."""
    times = np.zeros(K, dtype=int)
    contain = []
    for i in range(n_parties):
        current = [i % K]
        times[i % K] += 1
        j = 1
        while j < k_per_client:
            ind = random.randint(0, K - 1)
            if ind not in current:
                current.append(ind)
                times[ind] += 1
                j += 1
        contain.append(current)
    out_train = {i: np.array([], dtype=int) for i in range(n_parties)}
    out_test = {i: np.array([], dtype=int) for i in range(n_parties)}
    for cls in range(K):
        if times[cls] == 0:
            continue
        idx_k_train = np.where(y_train == cls)[0]
        idx_k_test = np.where(y_test == cls)[0]
        np.random.shuffle(idx_k_train)
        np.random.shuffle(idx_k_test)
        split_train = np.array_split(idx_k_train, times[cls])
        split_test = np.array_split(idx_k_test, times[cls])
        ids = 0
        for i in range(n_parties):
            if cls in contain[i]:
                out_train[i] = np.append(out_train[i], split_train[ids])
                out_test[i] = np.append(out_test[i], split_test[ids])
                ids += 1
    return out_train, out_test


def _hierarchical_dirichlet(y_train, y_test, n_parties, K, beta):
    """noniid-labeldir100: pachinko-style coarse→fine Dirichlet allocation over
    the CIFAR-100 hierarchy (utils/datasplit.py:280-430).  The COARSE prior is
    drawn with the CLI ``beta`` (datasplit.py:376) — that is where the label
    skew lives; the fine-within-coarse prior uses the reference's fixed
    alpha=10.  The reference pins seed 12345 (and reseeds the GLOBAL numpy
    RNG, kept here for parity); the split is computed over the concatenated
    train+test pool then re-separated."""
    y = np.concatenate([y_train, y_test], axis=0)
    n_fine = 100
    n_coarse = 20
    seed, alpha = 12345, 10
    rng = random.Random(seed)
    np.random.seed(seed)

    n_samples = len(y)
    selected = rng.sample(list(range(n_samples)), n_samples)
    n_per_client = n_samples // n_parties

    by_fine = {k: [] for k in range(n_fine)}
    by_coarse = {k: [] for k in range(n_coarse)}
    for idx in selected:
        fine = int(y[idx])
        coarse = int(CIFAR100_COARSE[fine])
        by_fine[fine].append(idx)
        by_coarse[coarse].append(idx)

    fine_by_coarse = {c: [f for f in range(n_fine) if CIFAR100_COARSE[f] == c] for c in range(n_coarse)}
    available_coarse = list(range(n_coarse))
    client_idxs = [[] for _ in range(n_parties)]

    for client in range(n_parties):
        coarse_prior = np.random.dirichlet(alpha=[beta] * len(available_coarse))
        fine_priors = {c: np.random.dirichlet(alpha=[alpha] * len(fine_by_coarse[c]))
                       for c in available_coarse}
        for _ in range(n_per_client):
            probs = np.array([coarse_prior[i] if len(by_coarse[c]) > 0 else 0.0
                              for i, c in enumerate(available_coarse)])
            if probs.sum() == 0:
                break
            probs /= probs.sum()
            ci = np.random.choice(len(available_coarse), p=probs)
            coarse = available_coarse[ci]
            fines = fine_by_coarse[coarse]
            fprobs = np.array([fine_priors[coarse][i] if len(by_fine[f]) > 0 else 0.0
                               for i, f in enumerate(fines)])
            if fprobs.sum() == 0:
                continue
            fprobs /= fprobs.sum()
            fine = fines[np.random.choice(len(fines), p=fprobs)]
            idx = by_fine[fine].pop()
            by_coarse[CIFAR100_COARSE[fine]].remove(idx)
            client_idxs[client].append(idx)

    n_train = len(y_train)
    out_train, out_test = {}, {}
    for j in range(n_parties):
        arr = np.asarray(client_idxs[j])
        out_train[j] = arr[arr < n_train]
        out_test[j] = arr[arr >= n_train] - n_train
    return out_train, out_test


def record_class_counts(y, idx_map: IndexMap) -> dict:
    """Per-client class histograms (reference's traindata_cls_counts)."""
    out = {}
    for client, idxs in idx_map.items():
        vals, counts = np.unique(np.asarray(y)[idxs], return_counts=True)
        out[client] = {int(v): int(c) for v, c in zip(vals, counts)}
    return out
