"""Datasets of the port, registered by name in ``DATASET_REGISTRY``:
FairFedMed, FedChexMimic, Cifar10 and Cifar100.  ``data.manager.build_dataset``
refuses the others (ROADMAP M14b)."""

from .cifar import Cifar10, Cifar100  # noqa: F401  (register)
from .fairfedmed import FairFedMed, FairFedMedDataset  # noqa: F401
from .fedchexmimic import FedChexMimic, FedChexMimicDataset  # noqa: F401
