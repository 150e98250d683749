"""Datasets of the port, registered by name in ``DATASET_REGISTRY``: the
JAX package's 16 (FairFedMed, FedChexMimic, WangGrant; Cifar10, Cifar100;
Caltech101, OxfordPets, OxfordFlowers, Food101, DescribableTextures;
DomainNet, Office; Mnist, FashionMnist, Svhn, Femnist)."""

from .cifar import Cifar10, Cifar100  # noqa: F401  (register)
from .domain import DomainNet, Office  # noqa: F401
from .fairfedmed import FairFedMed, FairFedMedDataset  # noqa: F401
from .fedchexmimic import FedChexMimic, FedChexMimicDataset  # noqa: F401
from .fewshot import (  # noqa: F401
    Caltech101, DescribableTextures, Food101, OxfordFlowers, OxfordPets,
)
from .generic import CharacterDataset, FashionMnist, Femnist, Mnist, Svhn  # noqa: F401
from .wanggrant import WangGrant, WangGrantDataset  # noqa: F401
