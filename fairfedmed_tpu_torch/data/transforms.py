"""Input transforms: only the head of the JAX package's ``build_transform``
(data/transforms.py:241-252).

The medical datasets take no host transform: their normalisation runs inside
the model's forward, as in the reference (GLP_OT_SVLoRA.py:677-693).  The
host pipelines of the other datasets are not ported yet.
"""

from __future__ import annotations

MEDICAL_DATASETS = {"FairFedMed", "FedChexMimic", "WangGrant"}
IN_MEMORY_DATASETS = {"Cifar10", "Cifar100"}


def build_transform(cfg, is_train: bool = True):
    """None for the medical datasets and under ``INPUT.NO_TRANSFORM``; the
    other datasets' transforms raise."""
    if cfg.INPUT.NO_TRANSFORM or cfg.DATASET.NAME in MEDICAL_DATASETS:
        return None
    raise NotImplementedError(
        f"host transforms for {cfg.DATASET.NAME!r} are not ported yet (ROADMAP M14)")
