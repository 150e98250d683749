"""The port's image-folder and array datasets against the JAX package's:
``data/base.py``'s splitters, ``data/samplers.py``, ``ClientLoader`` and
``DataManager`` with a sampler, the five few-shot datasets, DomainNet and
Office, the MNIST family, SVHN, FEMNIST, ``CharacterDataset`` and WangGrant,
on synthetic files written here, and the client-parallel runner's refusal of
the device cache for a loader with a sampler.

Each dataset is built by both packages after the same seeds, each on its own
copy of the files (the few-shot datasets write their split JSON into the
dataset directory).  Items (path relative to the root, label, domain, class
name), class names and labels are equal; the first batches through
``DataManager`` (with the host transforms of ``rn50.yaml``: bicubic random
resized crop, flip, normalize) agree to 0.02 grey levels over 255 * std, the
resize tolerance of ``tests/test_torch_port_transforms.py``; WangGrant's
bilinear resize (numpy against cv2) to 1e-3 on the 0-255 scale.  Split
draws, sampler streams and labels are exact.
"""

import json
import os
import random
import shutil
import string
import struct

import numpy as np
import pytest
import torch

from fairfedmed_tpu import config as jconfig
from fairfedmed_tpu.data import base as jbase
from fairfedmed_tpu.data import manager as jmanager
from fairfedmed_tpu.data import samplers as jsamplers
from fairfedmed_tpu.data.datasets import generic as jgeneric
from fairfedmed_tpu.utils.registry import DATASET_REGISTRY as JREG
from fairfedmed_tpu_torch import config as tconfig
from fairfedmed_tpu_torch.data import base as tbase
from fairfedmed_tpu_torch.data import manager as tmanager
from fairfedmed_tpu_torch.data import samplers as tsamplers
from fairfedmed_tpu_torch.data.datasets import generic as tgeneric
from fairfedmed_tpu_torch.fed import parallel_driver as tdriver
from fairfedmed_tpu_torch.utils.registry import DATASET_REGISTRY as TREG
from tests.fixtures import make_domain_fixture

torch.set_num_threads(1)

CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BATCH_TOL = 0.02 / 255.0 / min(CLIP_STD)
WANGGRANT_TOL = 1e-3
OFFICE_SITES = ("amazon", "caltech", "dslr", "webcam")
OFFICE_CLASSES = ("back_pack", "bike", "calculator", "headphones", "keyboard",
                  "laptop_computer", "monitor", "mouse", "mug", "projector")


# --------------------------------------------------------------------------- #
# data/base.py
# --------------------------------------------------------------------------- #

def _datums(mod, n_classes=7, per_class=(1, 2, 3, 5, 8), n_domains=3):
    out = []
    for c in range(n_classes):
        for i in range(per_class[c % len(per_class)]):
            out.append(mod.Datum(impath=f"c{c}/i{i}.jpg", label=c, domain=(c + i) % n_domains,
                                 classname=f"class {c}"))
    return out


def _keys(items):
    return [(d.impath, d.label, d.domain, d.classname) for d in items]


@pytest.mark.parametrize("num_shots,repeat", [(2, False), (3, True), (0, False)])
def test_generate_fewshot_dataset(num_shots, repeat):
    outs = []
    for mod in (jbase, tbase):
        random.seed(4)
        outs.append(_keys(mod.generate_fewshot_dataset(_datums(mod), num_shots, repeat)))
        outs[-1].append(random.random())  # the global stream after the draws
    assert outs[1] == outs[0]


@pytest.mark.parametrize("args", [(10, 3, 2, False, 0.0), (10, 3, 2, True, 0.0),
                                  (12, 4, 2, False, 0.25), (12, 4, 8, False, 0.25),
                                  (20, 10, 2, False, 0.1)])
def test_assign_classes_to_users(args):
    assert tbase.assign_classes_to_users(*args, seed=7) == \
        jbase.assign_classes_to_users(*args, seed=7)


@pytest.mark.parametrize("splitter", ["generate_federated_fewshot_dataset",
                                      "generate_federated_dataset"])
@pytest.mark.parametrize("num_users,num_shots,is_iid,repeat_rate", [
    (3, 2, False, 0.0), (3, 2, True, 0.0), (4, 2, False, 0.3), (2, 1, False, 0.3)])
def test_federated_splitters(splitter, num_users, num_shots, is_iid, repeat_rate):
    outs = []
    for mod in (jbase, tbase):
        random.seed(1)
        clients = getattr(mod, splitter)(_datums(mod), num_users, num_shots=num_shots,
                                         is_iid=is_iid, repeat_rate=repeat_rate)
        outs.append(([_keys(c) for c in clients], random.random()))
    assert outs[1] == outs[0]


# --------------------------------------------------------------------------- #
# data/samplers.py and ClientLoader
# --------------------------------------------------------------------------- #

SAMPLERS = {
    "RandomDomainSampler": dict(batch_size=6, n_domain=3),
    "RandomDomainSampler_all": dict(batch_size=6, n_domain=0),
    "SeqDomainSampler": dict(batch_size=6),
    "RandomClassSampler": dict(batch_size=6, n_ins=2),
    "RandomSampler": {},
    "SequentialSampler": {},
}


def _sampler(mod, name, items):
    kw = dict(SAMPLERS[name])
    return mod.build_sampler(name.replace("_all", ""), data_source=items, **kw)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_streams(name):
    streams = []
    for mod, bmod in ((jsamplers, jbase), (tsamplers, tbase)):
        random.seed(3)
        np.random.seed(3)
        s = _sampler(mod, name, _datums(bmod))
        streams.append((len(s), [list(s) for _ in range(3)], random.random(), np.random.rand()))
    assert streams[1] == streams[0]
    assert streams[0][1][0], "an empty stream"


class _ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load_item(self, i):
        d = self.items[i]
        return np.full((2, 2, 3), i, np.float32), d.label, None


@pytest.mark.parametrize("name", ["RandomDomainSampler", "RandomClassSampler"])
def test_client_loader_with_sampler(name):
    batches = []
    for mod, smod, bmod in ((jmanager, jsamplers, jbase), (tmanager, tsamplers, tbase)):
        random.seed(5)
        np.random.seed(5)
        items = _datums(bmod)
        loader = mod.ClientLoader(_ListDataset(items), batch_size=6, is_train=True,
                                  sampler=_sampler(smod, name, items))
        batches.append((len(loader), [(b["img"], b["label"], b["n_valid"])
                                      for _ in range(2) for b in loader]))
    assert batches[1][0] == batches[0][0]
    assert len(batches[1][1]) == len(batches[0][1]) > 0
    for (gi, gl, gn), (wi, wl, wn) in zip(batches[1][1], batches[0][1]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gn == wn


class _ShortSampler:
    """A stream of 3 indices, fewer than the batch."""

    def __iter__(self):
        return iter(range(3))

    def __len__(self):
        return 3


def test_short_sampler_stream_still_trains_a_batch():
    """A sampler that yields fewer indices than the batch (RandomClassSampler
    on a client owning one class): the loader drops by the stream, not the
    dataset, and trains one short batch in both packages."""
    lens = []
    for mod, bmod in ((jmanager, jbase), (tmanager, tbase)):
        items = [bmod.Datum(impath=f"{i}", label=0) for i in range(20)]
        loader = mod.ClientLoader(_ListDataset(items), batch_size=8, is_train=True,
                                  sampler=_ShortSampler())
        lens.append((len(loader), [len(b["label"]) for b in loader]))
    assert lens[1] == lens[0] == (1, [3])


class _Cfg:
    """The runner's view of the config: the train batch size."""

    class DATALOADER:
        class TRAIN_X:
            BATCH_SIZE = 4


def test_parallel_runner_refuses_the_device_cache_for_a_sampler():
    """A transform-free loader with a structured sampler gets no device
    cache (its stream is not a permutation of the indices), so the round
    assembles its batches on the host from the sampler's stream."""
    items = _datums(tbase)
    random.seed(2)
    np.random.seed(2)
    sampler = tsamplers.RandomDomainSampler(items, 4, 2)
    loader = tmanager.ClientLoader(_ListDataset(items), batch_size=4, is_train=True,
                                   sampler=sampler)
    runner = tdriver.ParallelRoundRunner.__new__(tdriver.ParallelRoundRunner)
    runner.cfg, runner.device, runner._attr_col = _Cfg, torch.device("cpu"), None
    runner.trainer = type("T", (), {"fed_train_loader_x_dict": {0: loader}})()
    runner._data_cache, runner._eval_cache = {}, {}
    runner._cache_budget, runner._cached_bytes = 1 << 30, 0
    assert runner._decode_loader(loader) is None
    assert runner._round_batches_device([0]) == (None, None)
    random.seed(9)
    np.random.seed(9)
    streams, n_steps = runner._round_batches([0])
    random.seed(9)
    np.random.seed(9)
    want = list(sampler)
    want = want[:len(want) // 4 * 4]
    got = [int(v) for i in range(n_steps[0]) for v in streams[0](i)["img"][:, 0, 0, 0]]
    assert got == want and n_steps[0] == len(want) // 4 > 0
    # without the sampler the same loader is cached
    loader.sampler = None
    assert runner._decode_loader(loader) is not None


# --------------------------------------------------------------------------- #
# the datasets
# --------------------------------------------------------------------------- #

def _jpeg(path, rng, hw, gray=False):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    shape = hw if gray else (*hw, 3)
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(path)


def _write_caltech_like(root, image_dir, classes, n_per_class, seed):
    rng = np.random.default_rng(seed)
    for c in classes:
        for i in range(n_per_class):
            hw = (int(rng.integers(20, 40)), int(rng.integers(20, 40)))
            _jpeg(os.path.join(root, image_dir, c, f"img_{i}.jpg"), rng, hw, gray=i == 1)


def _write_pets(root, seed):
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "oxford_pets")
    os.makedirs(os.path.join(base, "annotations"))
    breeds = ["abyssinian", "Bengal", "great_pyrenees", "pug"]
    for split, n in (("trainval", 5), ("test", 2)):
        with open(os.path.join(base, "annotations", f"{split}.txt"), "w") as f:
            for label, breed in enumerate(breeds, start=1):
                for i in range(n):
                    name = f"{breed}_{split}{i}"
                    _jpeg(os.path.join(base, "images", name + ".jpg"), rng, (30, 26))
                    f.write(f"{name} {label} 1 {label}\n")


def _write_flowers(root, seed):
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "oxford_flowers")
    labels = np.repeat(np.arange(1, 5), 6)
    rng.shuffle(labels)
    for i in range(len(labels)):
        _jpeg(os.path.join(base, "jpg", f"image_{i + 1:05d}.jpg"), rng, (28, 34))
    savemat(os.path.join(base, "imagelabels.mat"), {"labels": labels[None, :]})
    with open(os.path.join(base, "cat_to_name.json"), "w") as f:
        json.dump({str(k): f"flower {k}" for k in range(1, 5)}, f)


def _write_image_folders(root):
    classes = [f"class_{c}" for c in range(6)] + ["airplanes", "Faces", "Leopards",
                                                   "Motorbikes", "BACKGROUND_Google",
                                                   "Faces_easy"]
    _write_caltech_like(root, "caltech-101/101_ObjectCategories", classes, 5, seed=1)
    _write_caltech_like(root, "food-101/images", [f"dish_{c}" for c in range(5)], 5, seed=2)
    _write_caltech_like(root, "dtd/images", [f"texture_{c}" for c in range(5)], 5, seed=3)
    _write_pets(root, seed=4)
    _write_flowers(root, seed=5)
    make_domain_fixture(root, n_train=30, n_test=20, size=20)
    make_domain_fixture(root, pkl_subdir="office_caltech_10", sites=OFFICE_SITES,
                        label_names=OFFICE_CLASSES, n_train=30, n_test=20, size=20, seed=1)


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def _write_arrays(root):
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(6)
    for name in ("MNIST", "FashionMNIST"):
        d = os.path.join(root, name, "raw")
        os.makedirs(d)
        for split, n in (("train", 200), ("t10k", 60)):
            _write_idx(os.path.join(d, f"{split}-images-idx3-ubyte"),
                       rng.integers(0, 256, (n, 28, 28)))
            _write_idx(os.path.join(d, f"{split}-labels-idx1-ubyte"), np.arange(n) % 10)
    for split, n in (("train", 40), ("test", 16)):
        savemat(os.path.join(root, f"{split}_32x32.mat"),
                {"X": rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8),
                 "y": (np.arange(n) % 10 + 1)[:, None]})
        np.savez(os.path.join(root, f"femnist_{split}.npz"),
                 data=rng.integers(0, 256, (n, 28, 28)).astype(np.uint8),
                 targets=np.arange(n) % 62, users=np.arange(n) // 4)
    with open(os.path.join(root, "corpus.txt"), "w") as f:
        f.write("To be, or not to be, that is the question:\n" * 3)
    base = os.path.join(root, "wanggrant")
    os.makedirs(os.path.join(base, "mac"))
    stem = "metatable_heart_biomarkers_binary_oneeye_clean"
    for split, ids in (("train", range(100, 106)), ("valid", range(200, 204))):
        rows = ["id,righteye,heart.attack,gender"]
        for i in ids:
            eye = "OD" if i % 2 else "OS"
            rows.append(f"{i},{1.0 if eye == 'OD' else 0.0},{i % 2},{(i // 2) % 2}")
            img = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(base, "mac", f"{i}_{eye}_mac.tif"))
        with open(os.path.join(base, f"{stem}_{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_imagefolder"))
    _write_image_folders(root)
    _write_arrays(root)
    return root


def _cfg(mod, name, root, **dataset):
    cfg = mod.get_cfg_default()
    cfg.DATASET.NAME = name
    cfg.DATASET.ROOT = root
    cfg.DATASET.USERS = 2
    cfg.DATASET.NUM_SHOTS = 2
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 5
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = list(CLIP_STD)
    cfg.VERBOSE = False
    for k, v in dataset.items():
        setattr(cfg.DATASET, k, v)
    return cfg


def _item_keys(split, root):
    if hasattr(split, "items"):
        return [(os.path.relpath(d.impath, root), d.label, d.domain, d.classname)
                for d in split.items]
    return np.asarray(split.labels).tolist()


def _build_both(data_root, tmp_path, name, **dataset):
    """Both packages' DataManager for ``name`` after the same seeds, each on
    its own copy of the files; the first two train batches of client 0 and
    the first test batch of each client, drawn after the same seeds."""
    out = {}
    for key, cfg_mod, mod in (("jax", jconfig, jmanager), ("port", tconfig, tmanager)):
        root = str(tmp_path / key)
        shutil.copytree(data_root, root)
        cfg = _cfg(cfg_mod, name, root, **dataset)
        random.seed(1)
        np.random.seed(1)
        dm = mod.DataManager(cfg)
        np.random.seed(2)
        random.seed(2)
        train = [b for _, b in zip(range(2), dm.fed_train_loader_x_dict[0])]
        tests = [next(iter(dm.fed_test_loader_x_dict[i])) for i in range(cfg.DATASET.USERS)
                 if len(dm.fed_test_loader_x_dict[i].dataset)]
        ds = dm.dataset
        out[key] = dict(
            classnames=list(ds.classnames), lab2cname=dict(ds.lab2cname),
            num_classes=dm.num_classes,
            train=[_item_keys(c, root) for c in ds.federated_train_x],
            test=[_item_keys(c, root) for c in ds.federated_test_x],
            batches=train + tests)
    return out["jax"], out["port"]


def _assert_same(want, got):
    for k in ("classnames", "lab2cname", "num_classes", "train", "test"):
        assert got[k] == want[k], k
    assert len(got["batches"]) == len(want["batches"]) > 0
    for g, w in zip(got["batches"], want["batches"]):
        assert g.keys() == w.keys() and g["n_valid"] == w["n_valid"]
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["img"].shape == w["img"].shape and g["img"].shape[1] == 3
        np.testing.assert_allclose(g["img"], w["img"], atol=BATCH_TOL, rtol=0)


DATASETS = {
    "Caltech101": {}, "Caltech101_useall": {"USEALL": True},
    "Caltech101_base": {"SUBSAMPLE_CLASSES": "base"},
    "OxfordPets": {}, "OxfordFlowers": {}, "Food101": {}, "DescribableTextures": {"IID": True},
    "DomainNet": {"USERS": 6}, "Office": {"USERS": 4},
    "Office_imbalance": {"USERS": 2, "IMBALANCE_TRAIN": True, "BETA": 5.0},
    "Office_split_client": {"USERS": 12, "IMBALANCE_TRAIN": True, "SPLIT_CLIENT": True,
                            "BETA": 0.5},
    "DomainNet_split_client": {"USERS": 30, "IMBALANCE_TRAIN": True, "SPLIT_CLIENT": True,
                               "BETA": 0.5},
    "Mnist": {"PARTITION": "noniid-labeldir", "BETA": 0.5},
    "FashionMnist": {"PARTITION": "homo"},
    "Svhn": {"PARTITION": "noniid-#label3"},
    "Femnist": {"PARTITION": "homo"},
}


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_dataset_matches_jax(data_root, tmp_path, case):
    want, got = _build_both(data_root, tmp_path, case.split("_")[0], **DATASETS[case])
    _assert_same(want, got)
    if case == "Caltech101":
        # the ignored folders are gone, the renamed ones renamed
        assert {"airplane", "face", "leopard", "motorbike"} <= set(got["classnames"])
        assert not {"BACKGROUND_Google", "Faces_easy", "Faces"} & set(got["classnames"])
    if case == "DomainNet_split_client":
        assert len(got["train"]) == 30
    if case == "Mnist":
        assert got["batches"][0]["img"].shape == (4, 3, 32, 32)  # 1 channel -> 3


def test_every_jax_dataset_is_registered_and_built(data_root, tmp_path):
    from fairfedmed_tpu_torch.data import datasets  # noqa: F401
    from fairfedmed_tpu.data import datasets as jdatasets  # noqa: F401

    covered = {c.split("_")[0] for c in DATASETS} | {"FairFedMed", "FedChexMimic",
                                                     "WangGrant", "Cifar10", "Cifar100"}
    assert TREG.registered_names() == JREG.registered_names()
    assert set(TREG.registered_names()) == covered


def test_femnist_torch_file(data_root, tmp_path):
    """FEMNIST's processed ``training.pt`` / ``test.pt`` (torch.load)."""
    root = tmp_path / "femnist_pt"
    d = root / "FEMNIST" / "processed"
    d.mkdir(parents=True)
    for split, fname in (("train", "training.pt"), ("test", "test.pt")):
        with np.load(os.path.join(data_root, f"femnist_{split}.npz")) as z:
            torch.save((torch.from_numpy(z["data"]), torch.from_numpy(z["targets"]),
                        torch.from_numpy(z["users"])), d / fname)
    got, want = tgeneric.load_femnist_arrays(str(root)), jgeneric.load_femnist_arrays(str(root))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_character_dataset(data_root):
    path = os.path.join(data_root, "corpus.txt")
    got, want = tgeneric.CharacterDataset(path, 7), jgeneric.CharacterDataset(path, 7)
    assert len(got) == len(want) > 0 and got.vocab_size == want.vocab_size == len(
        string.printable)
    for i in (0, 5, len(want) - 1):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)


def test_celeba_labels(tmp_path):
    with open(tmp_path / "list_attr_celeba.txt", "w") as f:
        f.write("4\nAttractive Male Young\n")
        for i, m in enumerate((1, -1, 1, -1)):
            f.write(f"{i:06d}.jpg -1 {m} 1\n")
    with open(tmp_path / "list_eval_partition.txt", "w") as f:
        for i in range(4):
            f.write(f"{i:06d}.jpg {0 if i < 3 else 2}\n")
    got, want = (m.load_celeba_labels(str(tmp_path)) for m in (tgeneric, jgeneric))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_wanggrant(data_root, train):
    from fairfedmed_tpu.data.datasets import wanggrant as jwg
    from fairfedmed_tpu_torch.data.datasets import wanggrant as twg

    sets = []
    for cfg_mod, mod in ((jconfig, jwg), (tconfig, twg)):
        cfg = _cfg(cfg_mod, "WangGrant", data_root, MODALITY_TYPE="mac",
                   ATTRIBUTES=["gender", "race"])
        ds = mod.WangGrant(cfg)
        sets.append((ds, ds.federated_train_x[1] if train else ds.federated_test_x[0]))
    (jds, jsplit), (tds, tsplit) = sets
    assert (tds.classnames, tds.lab2cname, tds.num_classes) == \
        (jds.classnames, jds.lab2cname, jds.num_classes)
    assert tsplit.data_files == jsplit.data_files and len(tsplit) > 0
    np.testing.assert_array_equal(tsplit.labels, jsplit.labels)
    for i in range(len(jsplit)):
        (gi, gl, ga), (wi, wl, wa) = tsplit.load_item(i), jsplit.load_item(i)
        assert gi.shape == wi.shape == (3, 32, 32) and gl == wl
        np.testing.assert_allclose(gi, wi, atol=WANGGRANT_TOL, rtol=0)
        np.testing.assert_array_equal(ga, wa)  # race is not a column: -1
