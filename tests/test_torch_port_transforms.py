"""The port's host transforms (``fairfedmed_tpu_torch/data/transforms.py``,
``data/autoaugment.py``) against the JAX package's, which call cv2.

Each case feeds the same seeded image through both after the same
``np.random.seed``, so both draw the same random numbers in the same order.
Tolerances, on the 0-255 scale:

* bicubic and bilinear resizes: 0.02 (the port's numpy taps against
  ``cv2.resize``; measured at most 4e-4 bicubic and 5e-5 bilinear on these
  shapes); nearest, the crops, flips, cutout, grayscale and the noise draw:
  exact;
* ``gaussian_blur``: 1e-3 (measured 8e-5);
* the hue shift: 1 grey level (cv2's HSV -> RGB rounding; RGB -> HSV is
  exact), so a ``colorjitter`` with hue holds to 1 grey level times the
  largest factor applied after it (at most 1.4^3 here); without hue 1e-3;
* the pipelines after normalize: the resize tolerance over 255 * std;
* AutoAugment and the three RandAugment classes (PIL in both packages) with
  an explicit seed: exact.
"""

import numpy as np
import pytest
import torch

from fairfedmed_tpu import config as jconfig
from fairfedmed_tpu.data import autoaugment as jaa
from fairfedmed_tpu.data import transforms as jT
from fairfedmed_tpu_torch import config as tconfig
from fairfedmed_tpu_torch.data import autoaugment as taa
from fairfedmed_tpu_torch.data import transforms as tT

torch.set_num_threads(1)

RESIZE_TOL = 0.02
BLUR_TOL = 1e-3
HUE_TOL = 1.0
SHAPES = [((213, 300), (224, 224)), ((300, 213), (224, 315)), ((480, 640), (224, 224)),
          ((24, 24), (224, 224)), ((28, 28), (32, 32)), ((37, 23), (11, 7))]


def _img(shape, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    return (rng.random((*shape, channels)) * 255).astype(np.float32)


def _both(fn_name, img, *args, seed=3, **kw):
    out = {}
    for name, mod in (("jax", jT), ("port", tT)):
        np.random.seed(seed)
        out[name] = getattr(mod, fn_name)(img.copy(), *args, **kw)
        out[name + "_next"] = np.random.rand()  # the same number of draws
    assert out["port_next"] == out["jax_next"]
    return out["port"], out["jax"]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("shapes", SHAPES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in SHAPES])
def test_resize_matches_cv2(shapes, interp, channels):
    (h0, w0), size = shapes
    img = _img((h0, w0), channels=channels)
    got, want = _both("resize", img, size, interp)
    assert got.shape == want.shape == (*size, channels)
    if interp == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("shape", [(213, 300), (300, 213), (28, 28)])
def test_resize_short_edge(shape):
    got, want = _both("resize_short_edge", _img(shape), 224, "bicubic")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


EXACT_OPS = {
    "random_flip": ((), {}),
    "random_crop": ((24,), {"padding": 4}),
    "center_crop": ((17,), {}),
    "cutout": ((), {"n_holes": 2, "length": 8}),
    "randomgrayscale": ((), {"p": 0.5}),
    "instance_norm": ((), {}),
    "gaussian_noise": ((), {"std": 0.15}),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("op", sorted(EXACT_OPS))
def test_exact_ops(op, seed):
    args, kw = EXACT_OPS[op]
    got, want = _both(op, _img((24, 30), seed), *args, seed=seed, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("op,args,kw", [
    ("random_resized_crop", ((32, 32),), {"interpolation": "bicubic"}),
    ("random_resized_crop", ((224, 224),), {"interpolation": "bilinear"}),
    # extreme aspect ratios reach torchvision's fallback crop
    ("random_resized_crop", ((32, 32),), {"scale": (0.99, 1.0), "ratio": (1.0, 1.0)}),
    ("random_translation", ((32, 32),), {"interpolation": "bicubic"}),
])
def test_resizing_random_ops(op, args, kw, seed):
    shape = (40, 300) if kw.get("ratio") else (213, 300)
    got, want = _both(op, _img(shape, seed), *args, seed=seed, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(32, 32), (224, 224), (24, 30)])
def test_gaussian_blur(shape, seed):
    got, want = _both("gaussian_blur", _img(shape, seed), 21, p=1.0, seed=seed)
    np.testing.assert_allclose(got, want, atol=BLUR_TOL, rtol=0)


def test_hsv_round_trip_matches_cv2():
    import cv2

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    rgb[0, :, 1] = rgb[0, :, 0]  # ties between channels
    rgb[1] = rgb[1, :, :1]  # grey pixels
    np.testing.assert_array_equal(tT.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    hsv[..., 0] %= 180
    diff = np.abs(tT.hsv_to_rgb_u8(hsv).astype(int) - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert diff.max() <= HUE_TOL


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("case", ["hue_only", "no_hue", "all"])
def test_colorjitter(case, seed):
    b, c, s, h = {"hue_only": (0, 0, 0, 0.1), "no_hue": (0.4, 0.4, 0.4, 0.0),
                  "all": (0.4, 0.4, 0.4, 0.1)}[case]
    got, want = _both("colorjitter", _img((24, 30), seed), b, c, s, h, seed=seed)
    tol = {"hue_only": HUE_TOL, "no_hue": 1e-3, "all": HUE_TOL * 1.4 ** 3}[case]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _cfgs(name="Caltech101", **inputs):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg_default()
        cfg.DATASET.NAME = name
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
        cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
        for k, v in inputs.items():
            setattr(cfg.INPUT, k, v)
        out.append(cfg)
    return out


PIPELINES = {
    # configs/trainers/GLP_OT/rn50.yaml's, the default run's
    "rn50": dict(INTERPOLATION="bicubic",
                 TRANSFORMS=("random_resized_crop", "random_flip", "normalize")),
    "no_crop": dict(INTERPOLATION="bilinear", TRANSFORMS=("random_flip", "normalize")),
    "crop_cutout_noise": dict(TRANSFORMS=("random_crop", "random_flip", "cutout", "normalize",
                                          "gaussian_noise")),
    "translation_gray_blur_instance": dict(
        TRANSFORMS=("random_translation", "randomgrayscale", "gaussian_blur", "instance_norm"),
        RGS_P=0.5, GB_P=0.5, GB_K=5),
    "colorjitter_no_hue": dict(TRANSFORMS=("random_resized_crop", "colorjitter", "normalize"),
                               COLORJITTER_H=0.0),
    "colorjitter_hue": dict(TRANSFORMS=("random_resized_crop", "colorjitter", "normalize")),
}


def _pipeline_tol(name, cfg):
    per_level = 1.0 / 255.0 / min(cfg.INPUT.PIXEL_STD)
    if name == "colorjitter_hue":
        return HUE_TOL * 1.4 ** 3 * per_level
    if name == "translation_gray_blur_instance":  # unnormalised, then instance norm
        return 1e-3
    return RESIZE_TOL * per_level


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_build_transform_pipelines(name, is_train):
    jcfg, tcfg = _cfgs(**PIPELINES[name])
    jt, tt = jT.build_transform(jcfg, is_train), tT.build_transform(tcfg, is_train)
    tol = _pipeline_tol(name, tcfg)
    for seed in range(3):
        img = _img((57, 80), seed).astype(np.uint8)  # decoded images are uint8 HWC
        outs = []
        for fn in (jt, tt):
            np.random.seed(seed)
            outs.append(fn(img))
        assert outs[1].shape == outs[0].shape == (3, 32, 32)
        assert outs[1].dtype == outs[0].dtype
        np.testing.assert_allclose(outs[1], outs[0], atol=tol, rtol=0)


def test_mnist_one_channel_becomes_three():
    """An MNIST item is uint8 [28, 28, 1]: the normalize broadcasts it
    against the 3-channel mean and std into [3, H, W], in both packages."""
    jcfg, tcfg = _cfgs("Mnist", INTERPOLATION="bilinear",
                       TRANSFORMS=("random_resized_crop", "normalize"))
    img = (np.random.default_rng(0).random((28, 28, 1)) * 255).astype(np.uint8)
    for is_train in (True, False):
        outs = []
        for mod, cfg in ((jT, jcfg), (tT, tcfg)):
            np.random.seed(1)
            outs.append(mod.build_transform(cfg, is_train)(img))
        assert outs[1].shape == outs[0].shape == (3, 32, 32)
        np.testing.assert_allclose(outs[1], outs[0], atol=_pipeline_tol("rn50", tcfg), rtol=0)
        assert not np.allclose(outs[1][0], outs[1][1])  # per-channel mean and std


@pytest.mark.parametrize("name", ["FairFedMed", "FedChexMimic", "WangGrant", "Cifar10",
                                  "Cifar100"])
def test_on_device_datasets_take_no_host_transform(name):
    _, tcfg = _cfgs(name, TRANSFORMS=("random_flip", "normalize"))
    assert tT.build_transform(tcfg, True) is None and tT.build_transform(tcfg, False) is None
    _, tcfg = _cfgs("Caltech101", TRANSFORMS=("random_flip",), NO_TRANSFORM=True)
    assert tT.build_transform(tcfg, True) is None


POLICIES = {
    "imagenet": lambda m, seed: m.imagenet_policy(seed),
    "cifar10": lambda m, seed: m.cifar10_policy(seed),
    "svhn": lambda m, seed: m.svhn_policy(seed),
    "randaugment": lambda m, seed: m.RandAugment(2, 10, seed=seed),
    "randaugment2": lambda m, seed: m.RandAugment2(2, seed=seed),
    "randaugment_fixmatch": lambda m, seed: m.RandAugmentFixMatch(2, seed=seed),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_autoaugment_policies_exact(policy, seed):
    jp, tp = POLICIES[policy](jaa, seed), POLICIES[policy](taa, seed)
    rng = np.random.default_rng(seed)
    for i in range(12):  # enough calls to reach most ops of each bank
        shape = (32, 32, 3) if i % 3 else (32, 32)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(tp(img), jp(img))


def test_build_transform_wires_the_policies():
    wired = {}
    for choice in ("imagenet_policy", "cifar10_policy", "svhn_policy", "randaugment",
                   "randaugment2", "randaugment_fixmatch"):
        _, tcfg = _cfgs(TRANSFORMS=(choice, "normalize"))
        tfm = tT.build_transform(tcfg, True)
        img = np.full((40, 40, 3), 100, np.uint8)
        wired[choice] = tfm(img).shape
    assert set(wired.values()) == {(3, 32, 32)}
