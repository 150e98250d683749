"""The port's Dassl ops (``fairfedmed_tpu_torch/ops/dassl.py``) against the
JAX package's (``fairfedmed_tpu/ops/dassl.py``), on the cases of
``tests/test_dassl_ops.py``.

Inputs are drawn with numpy from a seed and go through both functions.  For
the stochastic ops (MixStyle, EFDMix, mixup) the test draws the JAX
function's own coin, permutation and Beta weights from the key it uses and
hands them to the port's deterministic core (``mixstyle_mix``,
``efdmix_mix``, ``mixup_mix``); the port's own draws (from a
``torch.Generator``) are checked for their properties.  Tolerance: fp32,
atol 1e-5 and rtol 1e-5 on values and gradients (the same arithmetic in
another order), exact where no arithmetic is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.ops import dassl as jops
from fairfedmed_tpu_torch.ops import dassl as tops

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(kw or TOL))


def _jax_mix_draws(rng, batch, alpha, mix, lmda_shape):
    """The coin, Beta weights and permutation ``jops.mixstyle`` /
    ``jops.efdmix`` draw from ``rng``."""
    r_coin, r_beta, r_perm = jax.random.split(rng, 3)
    lmda = jax.random.beta(r_beta, alpha, alpha, lmda_shape)
    perm = jops._mix_perm(r_perm, batch, mix)
    return bool(jax.random.uniform(r_coin) < 0.5), lmda, perm


# --------------------------------------------------------------------------- #
# mixstyle / efdmix
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mix", ["random", "crossdomain"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixstyle_core_matches_jax(mix, seed):
    x = np.random.default_rng(seed).normal(2.0, 3.0, size=(6, 4, 5, 7)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jops.mixstyle(key, jnp.asarray(x), p=1.0, alpha=0.3, mix=mix)
    _, lmda, perm = _jax_mix_draws(key, 6, 0.3, mix, (6, 1, 1, 1))
    got = tops.mixstyle_mix(_t(x), _t(lmda), _t(perm).long())
    _close(got, want)


@pytest.mark.parametrize("mix", ["random", "crossdomain"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_efdmix_core_matches_jax_with_gradient(mix, seed):
    x = np.random.default_rng(seed).normal(size=(4, 3, 4, 5)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    w = np.random.default_rng(seed + 10).normal(size=x.shape).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda a: (jops.efdmix(key, a, p=1.0, alpha=0.2, mix=mix) * w).sum())(jnp.asarray(x))
    _, lmda, perm = _jax_mix_draws(key, 4, 0.2, mix, (4, 1, 1))
    xt = _t(x).requires_grad_(True)
    got = (tops.efdmix_mix(xt, _t(lmda), _t(perm).long()) * _t(w)).sum()
    got.backward()
    _close(got, want, rtol=1e-5, atol=1e-4)
    _close(xt.grad, jgrad)


def test_mixstyle_and_efdmix_coin_and_eval():
    """The coin decides: p 0 and eval leave the input, p 1 mixes; a seeded
    generator repeats its draws; an identical batch is unchanged by mixing
    (its statistics are equal), and EFDMix keeps each row's rank order."""
    x = _t(np.random.default_rng(3).normal(size=(4, 2, 4, 4)).astype(np.float32))
    for fn in (tops.mixstyle, tops.efdmix):
        assert fn(x, torch.Generator().manual_seed(0), train=False) is x
        assert fn(x, torch.Generator().manual_seed(0), p=0.0) is x
        a = fn(x, torch.Generator().manual_seed(5), p=1.0)
        b = fn(x, torch.Generator().manual_seed(5), p=1.0)
        assert torch.equal(a, b) and not torch.equal(a, x)
        same = x[:1].repeat(4, 1, 1, 1)
        _close(fn(same, torch.Generator().manual_seed(1), p=1.0), same.numpy(), rtol=1e-4,
               atol=1e-5)
    out = tops.efdmix(x, torch.Generator().manual_seed(2), p=1.0).reshape(4, 2, -1)
    assert torch.equal(out.argsort(-1), x.reshape(4, 2, -1).argsort(-1))


def test_mix_crossdomain_perm_swaps_halves():
    perm = tops.mix_perm(torch.Generator().manual_seed(0), 8, "crossdomain").tolist()
    assert sorted(perm) == list(range(8))
    assert set(perm[:4]) == {4, 5, 6, 7} and set(perm[4:]) == {0, 1, 2, 3}
    want = np.asarray(jops._mix_perm(KEY, 7, "crossdomain"))
    got = tops.mix_perm(torch.Generator().manual_seed(0), 7, "crossdomain").tolist()
    assert set(got[:4]) == set(want[:4].tolist()) and set(got[4:]) == set(want[4:].tolist())


# --------------------------------------------------------------------------- #
# mmd
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("kernel", ["linear", "poly", "rbf"])
def test_mmd_matches_jax(kernel, normalize):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 10)).astype(np.float32)
    y = rng.normal(loc=0.5, size=(7, 10)).astype(np.float32)
    want = jops.mmd(jnp.asarray(x), jnp.asarray(y), kernel_type=kernel, normalize=normalize)
    got = tops.mmd(_t(x), _t(y), kernel_type=kernel, normalize=normalize)
    _close(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(NotImplementedError):
        tops.mmd(_t(x), _t(y), kernel_type="nope")


# --------------------------------------------------------------------------- #
# mixup / reverse_grad / losses / utils
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("preserve_order", [False, True])
def test_mixup_matches_jax(preserve_order):
    rng = np.random.default_rng(4)
    x1, x2 = (rng.normal(size=(8, 3, 4, 4)).astype(np.float32) for _ in range(2))
    y1, y2 = (np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)] for _ in range(2))
    want = jops.mixup(KEY, *(jnp.asarray(a) for a in (x1, x2, y1, y2)), beta=0.75,
                      preserve_order=preserve_order)
    lmda = jax.random.beta(KEY, 0.75, 0.75, (8, 1, 1, 1))
    if preserve_order:
        lmda = jnp.maximum(lmda, 1 - lmda)
    got = tops.mixup_mix(_t(x1), _t(x2), _t(y1), _t(y2), _t(lmda))
    for g, w in zip(got, want):
        _close(g, w)
    # the port's own draw: consistent weights in [0, 1] (>= 0.5 with preserve_order)
    xm, ym = tops.mixup(torch.ones(8, 3, 4, 4), torch.zeros(8, 3, 4, 4), torch.ones(8, 5),
                        torch.zeros(8, 5), 0.75, torch.Generator().manual_seed(0),
                        preserve_order=preserve_order)
    lam = xm[:, 0, 0, 0]
    assert torch.allclose(ym[:, 0], lam) and bool(((lam >= 0) & (lam <= 1)).all())
    if preserve_order:
        assert bool((lam >= 0.5).all())


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_reverse_grad_matches_jax(scale):
    x = np.asarray([1.0, -2.0, 3.0], np.float32)
    w = np.arange(3.0, dtype=np.float32)
    want = jax.grad(lambda t: (jops.reverse_grad(t, scale) * w).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = tops.reverse_grad(xt, scale)
    (out * _t(w)).sum().backward()
    _close(xt.grad, want, rtol=0, atol=0)
    _close(out, x, rtol=0, atol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smooth", [0.0, 0.2])
def test_label_smoothed_cross_entropy_matches_jax(smooth, reduction):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 4)).astype(np.float32)
    target = rng.integers(0, 4, 5)
    want = jops.cross_entropy(jnp.asarray(logits), jnp.asarray(target), label_smooth=smooth,
                              reduction=reduction)
    got = tops.cross_entropy(_t(logits), _t(target), label_smooth=smooth, reduction=reduction)
    _close(got, want)
    with pytest.raises(ValueError):
        tops.cross_entropy(_t(logits), _t(target), reduction="nope")


def test_prob_index_rampup_and_ema_utils_match_jax():
    p = np.asarray([[0.2, 0.8], [0.5, 0.5], [0.1, 0.9]], np.float32)
    _close(tops.sharpen_prob(_t(p), 2), jops.sharpen_prob(jnp.asarray(p), 2))
    _close(tops.create_onehot(torch.tensor([1, 0, 2]), 3),
           jops.create_onehot(jnp.asarray([1, 0, 2]), 3), rtol=0, atol=0)
    for cur in (0, 3, 10, 12):
        assert tops.sigmoid_rampup(cur, 10) == jops.sigmoid_rampup(cur, 10)
        assert tops.linear_rampup(cur, 10) == jops.linear_rampup(cur, 10)
    data, label = np.arange(4.0, dtype=np.float32), np.arange(4)
    rd, rl = tops.reverse_index(_t(data), _t(label))
    jd, jl = jops.reverse_index(jnp.asarray(data), jnp.asarray(label))
    _close(rd, jd, rtol=0, atol=0)
    _close(rl, jl, rtol=0, atol=0)
    sd, sl = tops.shuffle_index(_t(data), _t(label), torch.Generator().manual_seed(0))
    assert sorted(sl.tolist()) == [0, 1, 2, 3] and torch.equal(sd, sl.float())
    ema = {"a": np.ones(3, np.float32), "b": [np.zeros(2, np.float32)]}
    cur = {"a": np.zeros(3, np.float32), "b": [np.ones(2, np.float32)]}
    want = jops.ema_update(jax.tree_util.tree_map(jnp.asarray, ema),
                           jax.tree_util.tree_map(jnp.asarray, cur), alpha=0.9)
    got = tops.ema_update({"a": _t(ema["a"]), "b": [_t(ema["b"][0])]},
                          {"a": _t(cur["a"]), "b": [_t(cur["b"][0])]}, alpha=0.9)
    _close(got["a"], want["a"])
    _close(got["b"][0], want["b"][0])


# --------------------------------------------------------------------------- #
# dsbn / transnorm
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(16, 4), (4, 4, 5, 5)])
@pytest.mark.parametrize("domain", [0, 1])
def test_dsbn_matches_jax(shape, domain):
    x = np.random.default_rng(7).normal(2.0, 3.0, size=shape).astype(np.float32)
    jp, js = jops.dsbn_init(4, n_domain=2)
    tp, ts = tops.dsbn_init(4, n_domain=2)
    for train in (True, False):
        jout, js = jops.dsbn_apply(jp, js, jnp.asarray(x), domain, train=train)
        tout, ts = tops.dsbn_apply(tp, ts, _t(x), domain, train=train)
        _close(tout, jout)
        for k in ("mean", "var"):
            _close(ts[k], js[k])
    # the other domain keeps its init statistics
    assert bool((ts["mean"][1 - domain] == 0).all() and (ts["var"][1 - domain] == 1).all())


@pytest.mark.parametrize("adaptive_alpha", [True, False])
@pytest.mark.parametrize("shape", [(8, 3), (6, 3, 4, 4)])
def test_transnorm_matches_jax(shape, adaptive_alpha):
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    jp, js = jops.transnorm_init(3)
    tp, ts = tops.transnorm_init(3)
    for train in (True, False):
        jout, js = jops.transnorm_apply(jp, js, jnp.asarray(x), train=train,
                                        adaptive_alpha=adaptive_alpha)
        tout, ts = tops.transnorm_apply(tp, ts, _t(x), train=train,
                                        adaptive_alpha=adaptive_alpha)
        _close(tout, jout)
        for k in js:
            _close(ts[k], js[k])
    with pytest.raises(ValueError, match="even batch"):
        tops.transnorm_apply(tp, ts, torch.ones(5, 3), train=True)


# --------------------------------------------------------------------------- #
# dynamic conv
# --------------------------------------------------------------------------- #

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def test_se_attention_matches_jax():
    params = _np_tree(jops.se_attention_init(KEY, 32, 4))
    x = np.random.default_rng(9).normal(size=(2, 32, 8, 8)).astype(np.float32)
    want = jops.se_attention_apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    got = tops.se_attention_apply(_torch_tree(params), _t(x))
    _close(got, want)
    own = tops.se_attention_init(torch.Generator().manual_seed(0), 32, 4)
    assert own["fc1"]["weight"].shape == (2, 32) and own["fc2"]["bias"].shape == (4,)
    assert float(own["fc1"]["weight"].abs().max()) <= (1 / 32) ** 0.5


@pytest.mark.parametrize("cin,cout,stride", [(8, 16, 2), (8, 8, 1), (16, 8, 1)])
def test_conv2d_dynamic_matches_jax_with_gradient(cin, cout, stride):
    params = _np_tree(jops.conv2d_dynamic_init(KEY, cin, cout, 3, squeeze=4))
    x = np.random.default_rng(10).normal(size=(2, cin, 10, 10)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want, jgrad = jax.value_and_grad(
        lambda p: (jops.conv2d_dynamic_apply(p, jnp.asarray(x), stride=stride) ** 2).sum())(
        jparams)
    tparams = _torch_tree(params)
    leaves = jax.tree_util.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    out = tops.conv2d_dynamic_apply(tparams, _t(x), stride=stride)
    assert out.shape == (2, cout, 10 // stride, 10 // stride)
    loss = (out ** 2).sum()
    loss.backward()
    _close(loss, want, rtol=1e-5, atol=1e-3)
    for t, g in zip(leaves, jax.tree_util.tree_leaves(jgrad)):
        _close(t.grad, g, rtol=1e-4, atol=1e-4)
    own = tops.conv2d_dynamic_init(torch.Generator().manual_seed(0), cin, cout, 3, squeeze=4)
    assert {k: tuple(v["weight"].shape) for k, v in own.items() if k != "attention"} == \
        {k: tuple(v["weight"].shape) for k, v in params.items() if k != "attention"}
    with pytest.raises(ValueError):
        tops.conv2d_dynamic_init(torch.Generator(), cin, cout, 4)


# --------------------------------------------------------------------------- #
# log-domain sinkhorn divergence
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("max_iter,thre", [(5, 1e-3), (50, 1e-3), (3, 0.0)])
def test_sinkhorn_plan_matches_jax(max_iter, thre):
    cost = np.abs(np.random.default_rng(11).normal(size=(5, 7))).astype(np.float32)
    for differentiable in (False, True):
        want = jops._sinkhorn_plan(jnp.asarray(cost), 0.05, max_iter, thre,
                                   differentiable=differentiable)
        _close(tops.sinkhorn_plan(_t(cost), 0.05, max_iter, thre), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_ot_distance_and_divergences_match_jax(metric):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = rng.normal(loc=2.0, size=(8, 6)).astype(np.float32)
    _close(tops.ot_distance(_t(x), _t(y), metric),
           jops.ot_distance(jnp.asarray(x), jnp.asarray(y), metric), rtol=1e-5, atol=1e-4)
    eps = 0.1 if metric == "euclidean" else 0.01
    for fn in ("sinkhorn_divergence", "minibatch_energy_distance"):
        want = getattr(jops, fn)(jnp.asarray(x), jnp.asarray(y), dist_metric=metric, eps=eps)
        got = getattr(tops, fn)(_t(x), _t(y), dist_metric=metric, eps=eps)
        _close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tops.ot_distance(_t(x), _t(y), "nope")


@pytest.mark.parametrize("bp", [False, True])
def test_sinkhorn_divergence_gradient_matches_jax(bp):
    rng = np.random.default_rng(22)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = rng.normal(loc=1.0, size=(6, 4)).astype(np.float32)
    want = jax.grad(lambda a: jops.sinkhorn_divergence(
        a, jnp.asarray(y), dist_metric="euclidean", eps=0.5, bp_to_sinkhorn=bp))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    tops.sinkhorn_divergence(xt, _t(y), dist_metric="euclidean", eps=0.5,
                             bp_to_sinkhorn=bp).backward()
    _close(xt.grad, want, rtol=1e-4, atol=1e-4)
    assert float(xt.grad.abs().sum()) > 0
