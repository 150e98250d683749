"""The port's FedChexMimic and CIFAR data path against the JAX package's.

* ``data/partition.py``: every scheme the CLI takes (``homo``,
  ``noniid-labeldir``, ``noniid-labeluni``, ``iid-label100``,
  ``noniid-#label2``, ``noniid-labeldir100``) gives the same index maps and
  class counts, and leaves numpy's global RNG and Python's ``random`` in
  the same state (the CLI's later draws of users read them).  Exact.
* CIFAR-10/100 (``make_cifar10_fixture``, and a CIFAR-100 fixture written
  here in the same pickle format): the same client splits and batches
  through the DataManager.  Exact.
* The trainers' on-device CIFAR preprocessing (GLP-OT and PromptFL) against
  the JAX trainers' ``jax.image.resize`` at 32 -> 48 (up), 32 -> 32 (the
  CPU tests' size) and 32 -> 16 (down, antialiased): atol 1e-5.
* FedChexMimic (``make_fedchexmimic_fixture`` at 32 and 40 pixels, read at
  32): items, labels, attributes and group counts equal to the JAX
  package's through the native libjpeg pool (exact: the same C++) and
  through PIL (exact without a resize; the numpy resize against cv2's to
  atol 1e-3 on the 0-255 scale).
* The port's JPEG decoders against ``tests/data/fedchexmimic_jpeg/
  decoded.npz`` (libjpeg's pixels of the committed JPEGs): within 1 grey
  level, the IDCT rounding two JPEG decoders may differ by.
* The client-parallel runner's device cache of a client's set
  (``_decode_loader``) equals the JAX runner's: FedChexMimic fp32 when the
  X-rays are resized, uint8 when they are at the target size already, CIFAR
  uint8 NHWC as loaded; labels and attributes alike.
* The native build tries the JPEG build first and stamps a failed one; what
  is not ported raises naming ROADMAP M14b.
"""

import builtins
import os
import pickle
import random
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.config import get_cfg_default as jax_cfg_default
from fairfedmed_tpu.data import manager as jmanager
from fairfedmed_tpu.data import partition as jpart
from fairfedmed_tpu.data.datasets import fedchexmimic as jchex
from fairfedmed_tpu.fed import parallel_driver as jdriver
from fairfedmed_tpu.train.trainers import glp_ot as jglp
from fairfedmed_tpu.train.trainers import promptfl as jpfl
from fairfedmed_tpu_torch import native as tnative
from fairfedmed_tpu_torch.config import get_cfg_default as port_cfg_default
from fairfedmed_tpu_torch.data import manager as tmanager
from fairfedmed_tpu_torch.data import partition as tpart
from fairfedmed_tpu_torch.data import transforms as ttransforms
from fairfedmed_tpu_torch.data.datasets import fedchexmimic as tchex
from fairfedmed_tpu_torch.fed import parallel_driver as tdriver
from fairfedmed_tpu_torch.train.trainers import glp_ot as tglp
from fairfedmed_tpu_torch.train.trainers import promptfl as tpfl
from tests.fixtures import make_cifar10_fixture, make_fedchexmimic_fixture

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(HERE, "data", "fedchexmimic_jpeg")
ATTRIBUTES = ["race", "gender", "age"]
PREPROCESS_ATOL = 1e-5
RESIZE_ATOL = 1e-3  # 0-255 scale: numpy against cv2, float32 rounding of the same taps
GREY_LEVELS = 1  # two JPEG decoders' IDCTs may round a pixel apart by one


# --------------------------------------------------------------------------- #
# partitions
# --------------------------------------------------------------------------- #

def _rng_states():
    return np.random.get_state(), random.getstate()


def _assert_rng_states_equal(a, b):
    (na, pa), (nb, pb) = a, b
    assert na[0] == nb[0] and na[2:] == nb[2:]
    np.testing.assert_array_equal(na[1], nb[1])
    assert pa == pb


@pytest.mark.parametrize("scheme,k,n_parties", [
    ("homo", 10, 4), ("noniid-labeldir", 10, 4), ("noniid-labeluni", 10, 5),
    ("iid-label100", 100, 100), ("noniid-#label2", 10, 4), ("noniid-labeldir100", 100, 10),
])
def test_partitions_match(scheme, k, n_parties):
    # balanced labels: iid-label100 gives each of its 100 clients an equal
    # share of 5 fine labels
    rng = np.random.default_rng(11)
    y_train = rng.permutation(np.repeat(np.arange(k), 2000 // k))
    y_test = rng.permutation(np.repeat(np.arange(k), 600 // k))
    out, states = {}, {}
    for name, mod in (("jax", jpart), ("port", tpart)):
        np.random.seed(1)
        random.seed(1)
        out[name] = mod.partition_indices(y_train, y_test, scheme, n_parties, beta=0.4,
                                          num_classes=k)
        states[name] = _rng_states()
        # the draws that follow (the CLI's np.random.choice of users)
        out[name] += (np.random.choice(n_parties, 2, replace=False), random.random())
    _assert_rng_states_equal(states["port"], states["jax"])
    for split in (0, 1):
        got, want = out["port"][split], out["jax"][split]
        assert sorted(got) == sorted(want) == list(range(n_parties))
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])
        y = y_train if split == 0 else y_test
        assert tpart.record_class_counts(y, got) == jpart.record_class_counts(y, want)
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])
    assert out["port"][3] == out["jax"][3]
    assert sum(len(v) for v in out["port"][0].values()) > 0
    with pytest.raises(ValueError, match="Unknown partition"):
        tpart.partition_indices(y_train, y_test, "noniid-nope", n_parties)


# --------------------------------------------------------------------------- #
# CIFAR
# --------------------------------------------------------------------------- #

def make_cifar100_fixture(root, n_train=300, n_test=100, seed=0):
    """CIFAR-100-format pickles under root/cifar-100/cifar-100-python/."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-100", "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        with open(os.path.join(d, split), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.int64).astype(np.uint8),
                         "fine_labels": rng.integers(0, 100, n).tolist()}, f)
    with open(os.path.join(d, "meta"), "wb") as f:
        pickle.dump({"fine_label_names": [f"class_{i}" for i in range(100)]}, f)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    make_cifar10_fixture(str(root), n_train=200, n_test=80, seed=1)
    make_cifar100_fixture(str(root))
    return root


def _cifar_cfgs(root, name, partition, users=4):
    out = []
    for cfg in (jax_cfg_default(), port_cfg_default()):
        cfg.DATASET.NAME = name
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.USERS = users
        cfg.DATASET.PARTITION = partition
        cfg.DATASET.BETA = 0.5
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
        cfg.DATALOADER.TEST.BATCH_SIZE = 6
        cfg.VERBOSE = False
        out.append(cfg)
    return out


@pytest.mark.parametrize("name,partition", [("Cifar10", "noniid-labeldir"),
                                            ("Cifar10", "homo"),
                                            ("Cifar100", "noniid-labeldir100")])
def test_cifar_loaders_match(cifar_root, name, partition):
    jcfg, tcfg = _cifar_cfgs(cifar_root, name, partition)
    dms = {}
    for key, mod, cfg in (("jax", jmanager, jcfg), ("port", tmanager, tcfg)):
        np.random.seed(1)
        random.seed(1)
        dms[key] = mod.DataManager(cfg)
        dms[key + "_state"] = _rng_states()
    _assert_rng_states_equal(dms["port_state"], dms["jax_state"])
    jdm, tdm = dms["jax"], dms["port"]
    assert (tdm.num_classes, tdm.lab2cname) == (jdm.num_classes, jdm.lab2cname)
    assert tdm.dataset.classnames == jdm.dataset.classnames
    for attr in ("fed_train_loader_x_dict", "fed_test_loader_x_dict"):
        for c in range(4):
            tl, jl = getattr(tdm, attr)[c], getattr(jdm, attr)[c]
            assert len(tl.dataset) == len(jl.dataset)
            np.testing.assert_array_equal(tl.dataset.labels, jl.dataset.labels)
            np.random.seed(c)
            got = list(tl)
            np.random.seed(c)
            want = list(jl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w) == ["img", "label", "n_valid"]  # no attrs
                assert g["img"].dtype == w["img"].dtype == np.uint8
                assert g["img"].shape[1:] == (32, 32, 3)
                np.testing.assert_array_equal(g["img"], w["img"])
                np.testing.assert_array_equal(g["label"], w["label"])
                assert g["n_valid"] == w["n_valid"]
    assert ttransforms.build_transform(tcfg) is None


@pytest.mark.parametrize("name", ["Cifar10", "Cifar100"])
@pytest.mark.parametrize("size", [48, 32, 16], ids=["up", "identity", "down"])
def test_cifar_preprocess_matches_jax_resize(name, size):
    """Both trainers' preprocessing of a uint8 NHWC batch, the port's
    matmuls against the JAX trainers' jax.image.resize."""
    img = np.random.default_rng(size).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    cfg = jax_cfg_default()
    cfg.DATASET.NAME = name
    cfg.INPUT.SIZE = (size, size)
    want_glp = np.asarray(jglp.GLPOTBase._preprocess(types.SimpleNamespace(cfg=cfg), None,
                                                     jnp.asarray(img)))
    want_pfl = np.asarray(jpfl.PromptFL._device_preprocess(
        types.SimpleNamespace(cfg=cfg, prec_node="PROMPTFL"), jnp.asarray(img)))
    np.testing.assert_array_equal(want_glp, want_pfl)
    port = types.SimpleNamespace(_cifar=ttransforms.CifarPreprocess(name, size, "cpu"))
    for got in (tglp.GLPOTBase._preprocess(port, torch.from_numpy(img), None),
                tpfl.PromptFL._preprocess(port, torch.from_numpy(img))):
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, size, size)
        np.testing.assert_allclose(got.numpy(), want_glp, atol=PREPROCESS_ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# FedChexMimic
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def chex_roots(tmp_path_factory):
    return {size: make_fedchexmimic_fixture(str(tmp_path_factory.mktemp(f"chex{size}")),
                                            n_train=6, n_test=5, size=size, seed=size)
            for size in (32, 40)}


def _chex_pair(base, site, train):
    kw = dict(base_path=base, site=site, attribute_type="race", attributes=ATTRIBUTES,
              resolution=32, depth=3, train=train)
    return jchex.FedChexMimicDataset(**kw), tchex.FedChexMimicDataset(**kw)


@pytest.mark.parametrize("size", [32, 40], ids=["no_resize", "resize_40_to_32"])
@pytest.mark.parametrize("path", ["libjpeg", "PIL"])
def test_fedchexmimic_items_match(chex_roots, size, path):
    assert tnative.decoder("jpeg") == "libjpeg", tnative.build_log()
    assert jchex.FedChexMimicDataset._get_pool().supports_jpeg
    for site in (1, 2):
        for train in (True, False):
            jds, tds = _chex_pair(chex_roots[size], site, train)
            n = len(tds)
            assert n == len(jds) == (6 if train else 5)
            np.testing.assert_array_equal(tds.labels, jds.labels)
            np.testing.assert_array_equal(tds.attrs_matrix, jds.attrs_matrix)
            for attr in ATTRIBUTES:
                assert tds.count_by_attribute(attr) == jds.count_by_attribute(attr)
            if path == "libjpeg":  # decoded on the pools' threads
                jds.prefetch(range(n))
                tds.prefetch(range(n))
            for i in range(n):
                (ti, tl, ta), (ji, jl, ja) = tds.load_item(i), jds.load_item(i)
                assert ti.dtype == ji.dtype == np.float32 and ti.shape == ji.shape == (3, 32, 32)
                assert tl == jl and ta.dtype == ja.dtype == np.int32
                np.testing.assert_array_equal(ta, ja)
                if path == "PIL" and size != 32:
                    np.testing.assert_allclose(ti, ji, atol=RESIZE_ATOL, rtol=0)
                else:
                    np.testing.assert_array_equal(ti, ji)
            assert not getattr(tds, "_tickets", {})  # every ticket collected


def test_fedchexmimic_prefetch_is_cleared(chex_roots):
    _, tds = _chex_pair(chex_roots[40], 1, True)
    tds.prefetch(range(len(tds)))
    assert len(tds._tickets) == len(tds)
    tds.clear_prefetch()
    assert not tds._tickets
    img = tds.load_item(0)[0]  # synchronous again
    assert img.shape == (3, 32, 32) and np.isfinite(img).all()


def test_jpeg_decoders_match_committed_pixels():
    """The port's decoders on the committed JPEGs, at their own size (no
    resize): the native libjpeg build, the pool, and PIL."""
    want = np.load(os.path.join(JPEG_DIR, "decoded.npz"))
    assert sorted(want.files) == sorted(f for f in os.listdir(JPEG_DIR) if f.endswith(".jpg"))
    assert {want[k].shape for k in want.files} == {(320, 320), (336, 336)}
    pool = tnative.PrefetchPool(n_threads=2)
    try:
        for name in want.files:
            path = os.path.join(JPEG_DIR, name)
            ref = want[name].astype(np.float32)
            res = ref.shape[0]
            for got in (tnative.decode_jpeg_gray(path, res), tchex.decode_gray_pil(path),
                        pool.collect(pool.submit_jpeg(path, res))):
                assert got.dtype == np.float32 and got.shape == ref.shape
                assert np.abs(got - ref).max() <= GREY_LEVELS, name
    finally:
        pool.close()
    assert tnative.decode_jpeg_gray(os.path.join(JPEG_DIR, "decoded.npz"), 32) is None


def test_jpeg_decoder_choice(chex_roots, monkeypatch):
    """Without the native build the dataset decodes with PIL (and says so);
    without PIL either, decoding raises rather than returning nothing."""
    _, tds = _chex_pair(chex_roots[40], 2, False)
    want = tds.load_item(1)[0]
    monkeypatch.setattr(tnative, "_lib", False)
    monkeypatch.setattr(tchex.FedChexMimicDataset, "_pool", None)
    assert tnative.decoder("jpeg") == "PIL" and tnative.decoder() == "numpy"
    pool = tnative.PrefetchPool()
    assert not pool.supports_jpeg
    with pytest.raises(RuntimeError, match="supports_jpeg"):
        pool.submit_jpeg("x.jpg", 32)
    tds.prefetch([0, 1])  # a no-op without the JPEG build
    np.testing.assert_allclose(tds.load_item(1)[0], want, atol=RESIZE_ATOL, rtol=0)
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert tnative.decoder("jpeg") == "none"
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        tds.load_item(1)
    with pytest.raises(ValueError, match="kind"):
        tnative.decoder("png")


def test_native_build_order_and_failure_stamp(tmp_path, monkeypatch):
    """The JPEG build is tried first; one that fails leaves a stamp with the
    compiler's output, is not retried, and the plain build serves."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_log", "")
    failing_jpeg = ("jpeg", ("-DFFM_WITH_JPEG",), ("-lffm_no_such_lib",))
    monkeypatch.setattr(tnative, "BUILDS", (failing_jpeg, ("plain", (), ())))
    assert tnative.decoder() == "native" and not tnative.jpeg_available()
    stamps = list(tmp_path.glob("*.failed"))
    assert len(stamps) == 1 and stamps[0].name.startswith("libnpz_loader-jpeg-")
    assert "ffm_no_such_lib" in stamps[0].read_text() and "ffm_no_such_lib" in tnative.build_log()
    assert tnative.library_path("plain").exists() and not tnative.library_path("jpeg").exists()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_log", "")
    monkeypatch.setattr(tnative.subprocess, "run", None)  # a second process builds nothing
    assert tnative.decoder() == "native" and "ffm_no_such_lib" in tnative.build_log()


def _decoded(driver_mod, loader):
    runner = types.SimpleNamespace(_cache_budget=4 << 30, _cached_bytes=0)
    return driver_mod.ParallelRoundRunner._decode_loader(runner, loader)


@pytest.mark.parametrize("case", ["chex_resized", "chex_at_size", "cifar10"])
def test_parallel_cache_layout_matches_jax(chex_roots, cifar_root, case):
    if case == "cifar10":
        jcfg, tcfg = _cifar_cfgs(cifar_root, "Cifar10", "homo")
        np.random.seed(1)
        jl = jmanager.DataManager(jcfg).fed_train_loader_x_dict[1]
        np.random.seed(1)
        tl = tmanager.DataManager(tcfg).fed_train_loader_x_dict[1]
    else:
        jds, tds = _chex_pair(chex_roots[40 if case == "chex_resized" else 32], 2, True)
        jl = jmanager.ClientLoader(jds, batch_size=4, is_train=True)
        tl = tmanager.ClientLoader(tds, batch_size=4, is_train=True)
    (ti, tlab, tatt), (ji, jlab, jatt) = _decoded(tdriver, tl), _decoded(jdriver, jl)
    want_dtype = np.float32 if case == "chex_resized" else np.uint8
    assert ti.dtype == ji.dtype == want_dtype and ti.shape == ji.shape
    assert ti.shape[1:] == ((32, 32, 3) if case == "cifar10" else (3, 32, 32))
    if case == "chex_resized":  # item 0 decodes with PIL before the pool prefetches the rest
        np.testing.assert_allclose(ti, ji, atol=RESIZE_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tlab, jlab)
    if case == "cifar10":
        assert tatt is None and jatt is None
    else:
        np.testing.assert_array_equal(tatt, jatt)


def test_pil_is_imported_only_to_decode():
    """Importing the port (and chip_smoke.py) imports no PIL; the
    synchronous JPEG decode imports it."""
    code = ("import sys, chip_smoke\n"
            "from fairfedmed_tpu_torch.data.datasets import fedchexmimic\n"
            "from fairfedmed_tpu_torch import federated_main, native\n"
            "assert 'PIL' not in sys.modules, 'PIL imported'\n"
            f"fedchexmimic.decode_gray_pil({os.path.join(JPEG_DIR, 'mimic_4.jpg')!r})\n"
            "assert 'PIL' in sys.modules\n")
    root = os.path.dirname(HERE)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=root), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_unported_datasets_raise_naming_the_roadmap_item():
    """Every dataset of the JAX registry is registered in the port and passes
    the trainers' gate; the host transforms are None exactly for the medical
    and in-memory datasets.  Only a name the JAX package does not know
    raises."""
    from fairfedmed_tpu.data import datasets as jdatasets  # noqa: F401  (register)
    from fairfedmed_tpu.utils.registry import DATASET_REGISTRY as JREG
    from fairfedmed_tpu_torch.data import datasets as tdatasets  # noqa: F401
    from fairfedmed_tpu_torch.utils.registry import DATASET_REGISTRY as TREG

    assert TREG.registered_names() == JREG.registered_names()
    cfg = port_cfg_default()
    cfg.INPUT.TRANSFORMS = ("random_flip", "normalize")
    on_device = ttransforms.MEDICAL_DATASETS | ttransforms.IN_MEMORY_DATASETS
    for name in JREG.registered_names():
        cfg.DATASET.NAME = name
        tglp.check_dataset(cfg)
        assert (ttransforms.build_transform(cfg) is None) == (name in on_device), name
    cfg.DATASET.NAME = "NoSuchDataset"
    with pytest.raises(KeyError, match="NoSuchDataset"):
        tglp.check_dataset(cfg)
    with pytest.raises(KeyError, match="NoSuchDataset"):
        tmanager.build_dataset(cfg)
