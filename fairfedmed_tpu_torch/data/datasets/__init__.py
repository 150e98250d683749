"""Datasets of the port, registered by name in ``DATASET_REGISTRY``.  Only
FairFedMed is ported; ``data.manager.build_dataset`` refuses the others."""

from .fairfedmed import FairFedMed, FairFedMedDataset  # noqa: F401  (registers FairFedMed)
