"""The port's host data path against the JAX package's: the native NPZ
reader and its prefetch pool, the FairFedMed dataset, ClientLoader and
DataManager.

Inputs are the JAX package's ``make_fairfedmed_fixture`` at size 32 (no
resize at ``INPUT.SIZE`` 32) and at size 40 (the resize path), with rnflt,
ilm and clockhours members added so every 2D modality branch runs, and half
of the files rewritten with ``np.savez_compressed`` so the reader's inflate
path runs.  Tolerances: exact (bit-equal) everywhere except the bilinear
resize, where the port's numpy resize and the JAX package's cv2 resize agree
to atol 1e-3 on the 0-255 scale (float32 rounding of the same weights).
"""

import json
import os

import numpy as np
import pytest
import torch

from fairfedmed_tpu import native as jnative
from fairfedmed_tpu.config import get_cfg_default as jax_cfg_default
from fairfedmed_tpu.data import manager as jmanager
from fairfedmed_tpu.data.datasets import fairfedmed as jffm
from fairfedmed_tpu_torch import native as tnative
from fairfedmed_tpu_torch.config import get_cfg_default as port_cfg_default
from fairfedmed_tpu_torch.data import manager as tmanager
from fairfedmed_tpu_torch.data.datasets import fairfedmed as tffm
from tests.fixtures import make_fairfedmed_fixture

torch.set_num_threads(1)

ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]
MODALITIES = ["slo_fundus", "oct_bscans", "rnflt", "ilm", "rnflt+ilm", "clockhours"]
RESIZE_ATOL = 1e-3  # 0-255 scale


def _make_root(root, size, seed):
    """The JAX fixture (2 sites, 10 train / 7 test each) plus rnflt, ilm and
    clockhours members; odd-numbered files rewritten compressed."""
    base = make_fairfedmed_fixture(str(root), n_sites=2, n_train=10, n_test=7, size=size,
                                   seed=seed, oct_depth=8, oct_hw=size)
    rng = np.random.default_rng(seed + 100)
    all_dir = os.path.join(base, "all")
    for n, fname in enumerate(sorted(os.listdir(all_dir))):
        path = os.path.join(all_dir, fname)
        with np.load(path) as z:
            members = {k: z[k] for k in z.files}
        members["rnflt"] = rng.uniform(0, 350, (size, size)).astype(np.float32)
        members["ilm"] = rng.uniform(-40, 90, (size, size)).astype(np.float32)
        members["clockhours"] = rng.uniform(0, 200, (12,)).astype(np.float32)
        (np.savez_compressed if n % 2 else np.savez)(path, **members)
    return base


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {size: _make_root(tmp_path_factory.mktemp(f"ffm{size}"), size, seed=size)
            for size in (32, 40)}


def _datasets(base, modality, train, site=1):
    kw = dict(base_path=base, site=site, attribute_type="race", attributes=ATTRIBUTES,
              modality_type=modality, resolution=32, depth=3, train=train)
    return jffm.FairFedMedDataset(**kw), tffm.FairFedMedDataset(**kw)


# --------------------------------------------------------------------------- #
# native reader
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("compressed", [False, True], ids=["stored", "deflate"])
def test_npz_reader_and_pool_bit_equal_np_load(roots, compressed):
    assert tnative.decoder() == "native", tnative.build_log()
    all_dir = os.path.join(roots[32], "all")
    files = [os.path.join(all_dir, f) for n, f in enumerate(sorted(os.listdir(all_dir)))
             if n % 2 == int(compressed)][:4]
    pool = tnative.PrefetchPool(n_threads=2)
    try:
        for path in files:
            with np.load(path) as z:
                want = {k: z[k] for k in z.files}
            with tnative.NpzReader(path) as r, jnative.NpzReader(path) as jr:
                assert sorted(r.keys()) == sorted(want) == sorted(jr.keys())
                for k, v in want.items():
                    for got in (r.get(k), r[k], jr.get(k)):
                        assert got.dtype == v.dtype and got.shape == v.shape, k
                        np.testing.assert_array_equal(got, v, err_msg=k)
            tickets = {k: pool.submit(path, k) for k in want}
            dropped = pool.submit(path, "slo_fundus")
            pool.discard(dropped)
            for k, t in tickets.items():
                got = pool.collect(t)
                assert got.dtype == want[k].dtype and got.shape == want[k].shape
                np.testing.assert_array_equal(got, want[k], err_msg=k)
    finally:
        pool.close()
    with pytest.raises(KeyError):
        with tnative.NpzReader(files[0]) as r:
            r.get("no_such_member")


def test_numpy_fallback_reads_the_same(roots, monkeypatch):
    """With the native build unavailable the reader and the pool serve
    np.load's arrays and say so."""
    monkeypatch.setattr(tnative, "_lib", False)
    assert tnative.decoder() == "numpy"
    path = os.path.join(roots[32], "all", sorted(os.listdir(os.path.join(roots[32], "all")))[1])
    with np.load(path) as z:
        want = z["slo_fundus"]
    with tnative.NpzReader(path) as r:
        np.testing.assert_array_equal(r.get("slo_fundus"), want)
    pool = tnative.PrefetchPool()
    assert not pool.native
    np.testing.assert_array_equal(pool.collect(pool.submit(path, "slo_fundus")), want)


@pytest.mark.parametrize("shape,res", [((40, 40), 32), ((24, 24), 32), ((50, 37), 32),
                                       ((7, 9), 5), ((32, 32), 32)])
def test_bilinear_resize_matches_cv2(shape, res):
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    got, want = tffm._resize2d(img, res), jffm._resize2d(img, res)
    assert got.shape == want.shape == (res, res) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# dataset
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [32, 40], ids=["no_resize", "resize"])
@pytest.mark.parametrize("modality", MODALITIES)
def test_dataset_matches(roots, modality, size):
    resized = size != 32 and modality != "clockhours"
    for train in (True, False):
        jds, tds = _datasets(roots[size], modality, train)
        assert len(tds) == len(jds) > 0
        assert tds.data_files == jds.data_files
        np.testing.assert_array_equal(tds.labels, jds.labels)
        np.testing.assert_array_equal(tds.attrs_matrix, jds.attrs_matrix)
        for attr in ATTRIBUTES:
            assert tds.count_by_attribute(attr) == jds.count_by_attribute(attr)
        for i in range(len(tds)):
            (ti, tl, ta), (ji, jl, ja) = tds.load_item(i), jds.load_item(i)
            assert ti.dtype == ji.dtype == np.float32 and ti.shape == ji.shape
            assert tl == jl
            np.testing.assert_array_equal(ta, ja)
            if resized:
                np.testing.assert_allclose(ti, ji, atol=RESIZE_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(ti, ji)


def test_index_sidecar_and_unported_paths(roots, monkeypatch):
    base = roots[32]
    sidecar = os.path.join(base, "meta_site2_race_train.csv.index.json")
    if os.path.exists(sidecar):
        os.remove(sidecar)
    jffm.FairFedMedDataset(base, 2, "race", ATTRIBUTES, "slo_fundus", 32, train=True)
    with open(sidecar) as f:
        want = json.load(f)
    os.remove(sidecar)
    tffm.FairFedMedDataset(base, 2, "race", ATTRIBUTES, "slo_fundus", 32, train=True)
    with open(sidecar) as f:
        assert json.load(f) == want
    # a fresh sidecar is read, not rebuilt: no NPZ is opened
    monkeypatch.setattr(tffm.np, "load", None)
    tds = tffm.FairFedMedDataset(base, 2, "race", ATTRIBUTES, "slo_fundus", 32, train=True)
    monkeypatch.undo()
    assert len(tds) == 10
    assert tffm.group_histogram(np.array([2, -1, 0, 2])) == jffm.group_histogram(
        np.array([2, -1, 0, 2])) == [1, 0, 2]
    # the uint8 decode (ported): equal to the JAX package's and to load_item
    ds = tffm.FairFedMedDataset(base, 1, "race", ATTRIBUTES, "slo_fundus", 32, train=False)
    jds = jffm.FairFedMedDataset(base, 1, "race", ATTRIBUTES, "slo_fundus", 32, train=False)
    got, want = ds.load_item_u8(0), jds.load_item_u8(0)
    assert got[0].dtype == want[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0].astype(np.float32), ds.load_item(0)[0])
    with pytest.raises(NotImplementedError):
        tffm.FairFedMedDataset(base, 1, "race", ATTRIBUTES, "fundus_typo", 32)


def test_oct_bscans_3d_matches_on_float_volumes(tmp_path):
    """The whole volume as one channel, each voxel truncated through an
    integer before the float32 cast: equal to the JAX package's on volumes
    with fractional and negative voxels, where the truncation shows."""
    base = make_fairfedmed_fixture(str(tmp_path), n_sites=1, n_train=3, n_test=2, size=32,
                                   seed=9, oct_depth=8, oct_hw=12)
    rng = np.random.default_rng(9)
    all_dir = os.path.join(base, "all")
    for n, fname in enumerate(sorted(os.listdir(all_dir))):
        path = os.path.join(all_dir, fname)
        with np.load(path) as z:
            members = {k: z[k] for k in z.files}
        members["oct_bscans"] = rng.uniform(-20, 260, (8, 12, 12)).astype(np.float32)
        (np.savez_compressed if n % 2 else np.savez)(path, **members)
    for train in (True, False):
        jds, tds = _datasets(base, "oct_bscans_3d", train)
        assert len(tds) == len(jds) > 0
        for i in range(len(tds)):
            (ti, tl, ta), (ji, jl, ja) = tds.load_item(i), jds.load_item(i)
            assert ti.dtype == ji.dtype == np.float32 and ti.shape == ji.shape == (1, 8, 12, 12)
            assert tl == jl
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(ti, ji)
        raw = np.load(os.path.join(all_dir, tds.data_files[0]))["oct_bscans"]
        assert not np.array_equal(tds.load_item(0)[0][0], raw)  # the truncation ran


# --------------------------------------------------------------------------- #
# loaders
# --------------------------------------------------------------------------- #

def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["n_valid"] == w["n_valid"]
        for k in ("img", "label", "attrs"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("is_train", [True, False], ids=["train_shuffled", "test_padded"])
def test_client_loader_matches(roots, is_train):
    jds, tds = _datasets(roots[32], "slo_fundus", train=is_train)
    jl = jmanager.ClientLoader(jds, batch_size=4, is_train=is_train)
    tl = tmanager.ClientLoader(tds, batch_size=4, is_train=is_train)
    assert len(tl) == len(jl) == 2
    batches = {}
    for name, loader in (("jax", jl), ("port", tl)):
        np.random.seed(3)
        batches[name] = [b for _ in range(2) for b in loader]  # two epochs
    _assert_batches_equal(batches["port"], batches["jax"])
    if not is_train:  # 7 test items at batch 4: the last batch is padded
        assert [b["n_valid"] for b in batches["port"]] == [4, 3, 4, 3]
        assert batches["port"][1]["img"].shape[0] == 4


def _cfgs(root):
    out = []
    for cfg in (jax_cfg_default(), port_cfg_default()):
        cfg.DATASET.NAME = "FairFedMed"
        cfg.DATASET.ROOT = os.path.dirname(root)
        cfg.DATASET.USERS = 2
        cfg.DATASET.ATTRIBUTE_TYPE = "language"
        cfg.DATASET.ATTRIBUTES = list(ATTRIBUTES)
        cfg.INPUT.SIZE = (32, 32)
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
        cfg.DATALOADER.TEST.BATCH_SIZE = 3
        cfg.VERBOSE = False
        out.append(cfg)
    return out


def test_data_manager_matches_across_clients(roots):
    jcfg, tcfg = _cfgs(roots[32])
    jdm, tdm = jmanager.DataManager(jcfg), tmanager.DataManager(tcfg)
    assert (tdm.num_classes, tdm.lab2cname, tdm.dataset.classnames) == \
        (jdm.num_classes, jdm.lab2cname, jdm.dataset.classnames)
    for name in ("fed_train_loader_x_dict", "fed_test_loader_x_dict"):
        jd, td = getattr(jdm, name), getattr(tdm, name)
        assert sorted(td) == sorted(jd) == [0, 1]
        got, want = [], []
        np.random.seed(11)
        for c in (0, 1):
            want += list(jd[c])
        np.random.seed(11)
        for c in (0, 1):
            got += list(td[c])
        _assert_batches_equal(got, want)
        assert [len(td[c].dataset) for c in (0, 1)] == [len(jd[c].dataset) for c in (0, 1)]
        assert [td[c].dataset.count_by_attribute("language") for c in (0, 1)] == \
            [jd[c].dataset.count_by_attribute("language") for c in (0, 1)]


def test_prefetch_to_device_on_cpu_and_unported_options(roots):
    _, tcfg = _cfgs(roots[32])
    tdm = tmanager.DataManager(tcfg)
    loader = tdm.fed_test_loader_x_dict[0]
    want = list(loader)
    got = list(tmanager.prefetch_to_device(loader, size=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["n_valid"] == w["n_valid"]
        for k in ("img", "label", "attrs"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    _, cfg = _cfgs(roots[32])
    cfg.merge_from_list(["DATASET.NAME", "Cifar10"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tmanager.DataManager(cfg)
    # a structured sampler on a dataset without a Datum list shuffles at
    # random (the samplers are not ported; FairFedMed needs none): the same
    # batches as RandomSampler's from the same seed
    batches = {}
    for stype in ("RandomSampler", "RandomDomainSampler"):
        _, cfg = _cfgs(roots[32])
        cfg.merge_from_list(["DATALOADER.TRAIN_X.SAMPLER", stype])
        np.random.seed(3)
        batches[stype] = [b["label"] for b in tmanager.DataManager(cfg).fed_train_loader_x_dict[0]]
    assert len(batches["RandomSampler"]) > 0
    for got, want in zip(batches["RandomDomainSampler"], batches["RandomSampler"], strict=True):
        np.testing.assert_array_equal(got, want)


class _ListDataset:
    """A dataset of given (img, label, attrs) items, for the loader's edges."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load_item(self, i):
        return self.items[i]


def test_client_loader_edges_match():
    """A train stream shorter than the batch is not dropped, and a mixed
    None/non-None attrs stream raises, in both packages."""
    img = np.zeros((3, 4, 4), np.float32)
    short = _ListDataset([(img + i, i % 2, np.array([i], np.int32)) for i in range(3)])
    batches = {}
    for name, mod in (("jax", jmanager), ("port", tmanager)):
        np.random.seed(5)
        batches[name] = list(mod.ClientLoader(short, batch_size=4, is_train=True))
    _assert_batches_equal(batches["port"], batches["jax"])
    assert [b["n_valid"] for b in batches["port"]] == [3]
    mixed = _ListDataset([(img, 0, np.array([0], np.int32)), (img, 1, None)])
    for mod in (jmanager, tmanager):
        with pytest.raises(ValueError, match="uniformly"):
            list(mod.ClientLoader(mixed, batch_size=2, is_train=False))
