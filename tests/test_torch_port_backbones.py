"""The port's Baseline backbones, heads, DDAIG networks and distance
matrices (``fairfedmed_tpu_torch/models/{backbones,networks}.py``,
``evaluation/distance.py``) against the JAX package's.

Each family is initialised by the JAX package from a key, carried across as
numpy (``backbone_from_numpy``) and run on the same numpy-seeded input
through both: the features, and in train mode the new BatchNorm running
statistics, must agree; for ResNet-18, the ViT and the MLP head so must the
gradients of a weighted sum of the features.  The ViT runs at depth 2,
width 64, 4 heads on 32x32 images.  Tolerance, fp32 throughout:
rtol 1e-5 / atol 1e-5 for the heads, the grid sampler and the distances;
1e-4 for the ViT, the DDAIG generators and the ResNets in eval mode (more
arithmetic in another order), and for each ResNet gradient 1e-4 of its
largest entry; 1e-3 for the ResNets in train mode, whose
batch statistics over 8 values per channel in the last stage amplify
rounding: on ResNet-50 at 64x64 the JAX package's own fp32 features lie
8e-4 from a float64 evaluation of the same function (the port's 6e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fairfedmed_tpu.evaluation import distance as jdist
from fairfedmed_tpu.models import backbones as jbb
from fairfedmed_tpu.models import networks as jnet
from fairfedmed_tpu_torch.evaluation import (compute_distance_matrix, cosine_distance,
                                             euclidean_squared_distance)
from fairfedmed_tpu_torch.models import backbones as tbb
from fairfedmed_tpu_torch.models import networks as tnet

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TRAIN_BN = dict(rtol=1e-3, atol=1e-3)
NET = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _close_trees(got, want, **tol):
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **(tol or TOL))


def _close_grad(got, want, rel=1e-4):
    """Every gradient entry within ``rel`` of the tensor's largest magnitude
    (train-mode ResNet gradients reach tens)."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-2)


def _image(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _both(jfactory, tfactory, x, train, **tol):
    """Run a JAX backbone and its port from the JAX init; returns the
    port's (params, stats) and compares features and new statistics."""
    jinit, japply, jdim = jfactory()
    tinit, tapply, tdim = tfactory()
    assert jdim == tdim
    jp, js = jax.jit(jinit)(KEY)
    tp, ts = tbb.backbone_from_numpy(_np(jp), _np(js), "cpu")
    jf, jns = jax.jit(japply, static_argnums=3)(jp, js, jnp.asarray(x), train)
    tf, tns = tapply(tp, ts, torch.tensor(x), train)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **(tol or TOL))
    _close_trees(tns, jns, **(tol or TOL))
    return tp, ts, tapply, jp, js, japply


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "cnn3"])
def test_backbone_matches_jax(name, train):
    """ResNet-101 and -152 differ from ResNet-50 only in their block counts:
    their layout is held below."""
    x = _image(1, (2, 3, 64, 64))  # layer4 keeps 2x2, so its BatchNorm sees 8 values
    _both(lambda: jbb.build_backbone(name), lambda: tbb.build_backbone(name), x, train,
          **(TRAIN_BN if train else NET))


def test_resnet18_gradient_matches_jax():
    x = _image(2, (2, 3, 64, 64))
    w = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    tp, ts, tapply, jp, js, japply = _both(lambda: jbb.build_backbone("resnet18"),
                                           lambda: tbb.build_backbone("resnet18"), x, True,
                                           **TRAIN_BN)
    jgrad = jax.jit(jax.grad(lambda p: (japply(p, js, jnp.asarray(x), True)[0] * w).sum()))(jp)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    (tapply(tp, ts, torch.tensor(x), True)[0] * torch.tensor(w)).sum().backward()
    for t, g in zip(leaves, _leaves(jgrad)):
        _close_grad(t.grad, g)


@pytest.mark.parametrize("name", ["resnet18_ms_l1", "resnet18_efdmix_l123", "resnet50_ms_l12"])
def test_mix_variants_dormant_without_a_generator(name):
    """Without a generator (and in eval mode with one) a mixing variant
    computes the plain ResNet, as the JAX package's without an rng; with a
    generator in train mode it mixes."""
    x = _image(4, (4, 3, 64, 64))
    tp, ts, tapply, *_ = _both(lambda: jbb.build_backbone(name),
                               lambda: tbb.build_backbone(name), x, True, **TRAIN_BN)
    base = name.split("_")[0]
    plain, _ = tbb.build_backbone(base)[1](tp, ts, torch.tensor(x), True)
    dormant, _ = tapply(tp, ts, torch.tensor(x), True)
    assert torch.equal(plain, dormant)
    ev, _ = tapply(tp, ts, torch.tensor(x), False, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ev, tbb.build_backbone(base)[1](tp, ts, torch.tensor(x), False)[0])
    mixed = [tapply(tp, ts, torch.tensor(x), True, generator=torch.Generator().manual_seed(s))[0]
             for s in range(4)]
    assert all(torch.isfinite(m).all() for m in mixed)
    assert any(not torch.allclose(m, plain) for m in mixed)


def test_registries_match_jax():
    assert sorted(tbb.BACKBONE_REGISTRY) == sorted(jbb.BACKBONE_REGISTRY)
    assert sorted(tnet.NETWORK_REGISTRY) == sorted(jnet.NETWORK_REGISTRY)
    with pytest.raises(KeyError):
        tbb.build_backbone("alexnet9000")
    with pytest.raises(KeyError):
        tnet.build_network("nope")
    with pytest.raises(KeyError):
        tbb.build_head("linear", 4, (2,))


def test_port_init_has_the_jax_layout():
    """The port's own init gives the JAX tree: the same paths and shapes,
    fan-out kaiming scale on the convolutions."""
    for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "cnn3"):
        jp, js = jax.eval_shape(jbb.build_backbone(name)[0], KEY)
        tp, ts = tbb.build_backbone(name)[0](torch.Generator().manual_seed(0))
        for j, t in ((jp, tp), (js, ts)):
            jflat = {jax.tree_util.keystr(k): np.shape(v)
                     for k, v in jax.tree_util.tree_leaves_with_path(j)}
            tflat = {jax.tree_util.keystr(k): tuple(v.shape)
                     for k, v in jax.tree_util.tree_leaves_with_path(t)}
            assert jflat == tflat
    conv = tbb.build_backbone("resnet50")[0](torch.Generator().manual_seed(0))[0]["conv"]["conv1"]
    assert abs(float(conv.std()) - (2.0 / (64 * 49)) ** 0.5) < 2e-3


@pytest.mark.parametrize("train", [True, False])
def test_vit_matches_jax_with_gradient(train):
    factory = dict(image_size=32, depth=2, width=64, heads=4)
    x = _image(5, (2, 3, 32, 32))
    w = np.random.default_rng(6).normal(size=(2, 64)).astype(np.float32)
    tp, ts, tapply, jp, js, japply = _both(
        lambda: jbb.BACKBONE_REGISTRY["vit_base_patch16"](**factory),
        lambda: tbb.BACKBONE_REGISTRY["vit_base_patch16"](**factory), x, train, **NET)
    jgrad = jax.grad(lambda p: (japply(p, js, jnp.asarray(x), train)[0] * w).sum())(jp)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    (tapply(tp, ts, torch.tensor(x), train)[0] * torch.tensor(w)).sum().backward()
    for t, g in zip(leaves, _leaves(jgrad)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **NET)
    own, _ = tbb.BACKBONE_REGISTRY["vit_base_patch16"](**factory)[0](
        torch.Generator().manual_seed(0))
    assert own["blocks"]["qkv_w"].shape == (2, 64, 192) and own["pos"].shape == (1, 5, 64)
    assert float(own["pos"].abs().max()) <= 0.04  # truncated at 2 std


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "gelu"])
@pytest.mark.parametrize("bn", [True, False])
def test_mlp_head_matches_jax(bn, activation):
    jinit, japply, jdim = jbb.build_head("mlp", 64, (32, 16), activation=activation, bn=bn)
    tinit, tapply, tdim = tbb.build_head("mlp", 64, (32, 16), activation=activation, bn=bn)
    assert jdim == tdim == 16
    jp, js = jinit(KEY)
    tp, ts = tbb.backbone_from_numpy(_np(jp), _np(js), "cpu")
    x = np.random.default_rng(7).normal(size=(4, 64)).astype(np.float32)
    w = np.random.default_rng(8).normal(size=(4, 16)).astype(np.float32)
    for train in (True, False):
        jy, jns = japply(jp, js, jnp.asarray(x), train)
        ty, tns = tapply(tp, ts, torch.tensor(x), train)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _close_trees(tns, jns)
    jgrad = jax.grad(lambda p: (japply(p, js, jnp.asarray(x), True)[0] * w).sum())(jp)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    (tapply(tp, ts, torch.tensor(x), True)[0] * torch.tensor(w)).sum().backward()
    for t, g in zip(leaves, _leaves(jgrad)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


# --------------------------------------------------------------------------- #
# DDAIG networks
# --------------------------------------------------------------------------- #

def test_affine_grid_and_grid_sample_match_jax_and_torch():
    x = np.random.default_rng(14).normal(size=(2, 3, 9, 11)).astype(np.float32)
    theta = np.asarray([[[0.9, 0.1, 0.05], [-0.1, 1.1, -0.02]],
                        [[1.0, 0.0, 0.3], [0.0, 1.0, -0.4]]], np.float32)
    jgrid = jnet._affine_grid(jnp.asarray(theta), 9, 11)
    tgrid = tnet.affine_grid(torch.tensor(theta), 9, 11)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid), **TOL)
    got = tnet.grid_sample(torch.tensor(x), tgrid)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet._grid_sample(jnp.asarray(x), jgrid)),
                               **TOL)
    ref = F.grid_sample(torch.tensor(x), F.affine_grid(torch.tensor(theta), (2, 3, 9, 11),
                                                       align_corners=False),
                        align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("name", ["fcn_3x32_gctx", "fcn_3x64_gctx", "fcn_3x32_gctx_stn",
                                  "fcn_3x64_gctx_stn"])
def test_fcn_generator_matches_jax(name):
    jinit, japply = jnet.build_network(name, image_size=16)
    tinit, tapply = tnet.build_network(name, image_size=16)
    jp, js = jinit(KEY)
    if "locnet" in jp:  # a non-identity transform, so the sampling moves pixels
        w = np.random.default_rng(16).normal(scale=0.1, size=jp["locnet"]["fc_loc"]["weight"].shape)
        jp["locnet"]["fc_loc"]["weight"] = jnp.asarray(w, jnp.float32)
    tp, ts = tbb.backbone_from_numpy(_np(jp), _np(js), "cpu")
    x = np.random.default_rng(15).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    for train in (True, False):
        jx, jpo, jns = japply(jp, js, jnp.asarray(x), train=train, lmda=0.3)
        tx, tpo, tns = tapply(tp, ts, torch.tensor(x), train=train, lmda=0.3)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **NET)
        np.testing.assert_allclose(tpo.numpy(), np.asarray(jpo), **NET)
        _close_trees(tns, jns, **NET)
        assert float(tpo.abs().max()) <= 1.0
    own, _ = tinit(torch.Generator().manual_seed(0))
    assert sorted(own) == sorted(jp)


# --------------------------------------------------------------------------- #
# distance matrices
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_distance_matrix_matches_jax(metric):
    rng = np.random.default_rng(18)
    a = rng.normal(size=(5, 8)).astype(np.float32)
    b = rng.normal(size=(7, 8)).astype(np.float32)
    b[0] = 0.0  # a zero row: the clamped norm
    want = jdist.compute_distance_matrix(a, b, metric)
    got = compute_distance_matrix(torch.tensor(a), torch.tensor(b), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fn = euclidean_squared_distance if metric == "euclidean" else cosine_distance
    np.testing.assert_allclose(fn(torch.tensor(a), torch.tensor(b)).numpy(), np.asarray(want),
                               **TOL)


def test_distance_matrix_refuses_what_jax_refuses():
    a = torch.zeros(3, 4)
    for args in ((torch.zeros(3), a), (a, torch.zeros(2, 2, 4)), (a, torch.zeros(3, 5)),
                 (a, a, "manhattan")):
        with pytest.raises(ValueError):
            compute_distance_matrix(*args)
        with pytest.raises(ValueError):
            jdist.compute_distance_matrix(*(np.asarray(x) if isinstance(x, torch.Tensor) else x
                                            for x in args))
