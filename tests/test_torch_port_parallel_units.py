"""The pieces of the port's client-parallel rounds against the JAX package's,
on the same numbers (fp32; atol 1e-6 for the aggregation, whose sums run
in another order, and 1e-5 for the optimizers over 8 steps):

* ``FunctionalOptimizer`` against each optax transform of the JAX
  ``build_optimizer`` (coupled weight decay 5e-4, the learning rate going
  from 0.01 to 0.001 after step 4), and a step undone by ``torch.where``;
* ``ParallelRoundRunner._aggregate`` against the JAX runner's jitted
  aggregation program in each of the five modes, with and without group
  weights, ``shared_half_s`` and ``LOCAL_S``, a keep mask and a round that
  trains part of the clients;
* ``fed/parallel.py``'s helpers against ``fairfedmed_tpu/fed/parallel.py``'s;
* ``sample_clients`` against the JAX one from the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fairfedmed_tpu import config as jconfig
from fairfedmed_tpu.core.pytree import flatten_paths as jflatten
from fairfedmed_tpu.fed import parallel as jparallel
from fairfedmed_tpu.fed import parallel_driver as jdriver
from fairfedmed_tpu.fed import sampler as jsampler
from fairfedmed_tpu.train import optim as joptim
from fairfedmed_tpu_torch.core.pytree import flatten_paths, unflatten_like
from fairfedmed_tpu_torch.fed import parallel as tparallel
from fairfedmed_tpu_torch.fed import parallel_driver as tdriver
from fairfedmed_tpu_torch.fed import sampler as tsampler
from fairfedmed_tpu_torch.train import optim as toptim

torch.set_num_threads(1)

OPTIMS = [("sgd", 0.9, False), ("sgd", 0.9, True), ("sgd", 0.0, False), ("adam", 0.9, False),
          ("amsgrad", 0.9, False), ("rmsprop", 0.9, False), ("rmsprop", 0.0, False),
          ("radam", 0.9, False), ("adamw", 0.9, False)]


@pytest.mark.parametrize("name,momentum,nesterov", OPTIMS,
                         ids=[f"{n}-m{m}{'-nesterov' if v else ''}" for n, m, v in OPTIMS])
def test_functional_optimizer_matches_optax(name, momentum, nesterov):
    cfg = jconfig.get_cfg_default()
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.SGD_NESTEROV = name, 0.01, nesterov
    cfg.OPTIM.WEIGHT_DECAY, cfg.OPTIM.MOMENTUM = 5e-4, momentum
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b.c": rng.standard_normal(5).astype(np.float32)}
    noise = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(8)]
    lrs = [0.01 if i < 4 else 0.001 for i in range(8)]

    tx = joptim.build_optimizer(cfg.OPTIM)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    opt = toptim.FunctionalOptimizer(cfg.OPTIM)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.init(tp)
    for i in range(8):
        g = {k: np.asarray(jp[k]) * 0.5 + noise[i][k] for k in p0}
        js = joptim.set_learning_rate(js, lrs[i])
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {k: tp[k] * 0.5 + torch.tensor(noise[i][k]) for k in p0}
        new_p, new_s = opt.update(tp, tg, ts, lrs[i])
        assert all(new_p[k] is not tp[k] for k in tp)  # new tensors, the old ones kept
        tp, ts = new_p, new_s
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-5, rtol=0,
                                       err_msg=f"{k} step {i}")
    assert max(np.abs(tp[k].numpy() - p0[k]).max() for k in p0) > 1e-2
    assert int(ts["count"]) == 8

    # a step undone by torch.where leaves parameters and state as they were
    tg = {k: torch.ones_like(v) for k, v in tp.items()}
    new_p, new_s = opt.update(tp, tg, ts, 0.01)
    keep = torch.tensor(False)
    kept_p = {k: torch.where(keep, new_p[k], tp[k]) for k in tp}
    kept_s = {k: torch.where(keep, new_s[k], ts[k]) for k in ts}
    assert all(torch.equal(kept_p[k], tp[k]) for k in tp)
    assert all(torch.equal(kept_s[k], ts[k]) for k in ts)


# --------------------------------------------------------------------------- #
# aggregation
# --------------------------------------------------------------------------- #

N_USERS, G, RANK, AVG_PROMPT = 4, 3, 4, 1


def _trees(rng, m):
    """JAX-style nested trees: a global state, the stacked personal states of
    every user and the trained states of the ``m`` clients of a round."""
    def state(lead):
        return {"prompt_learner": {"ctx": rng.standard_normal(lead + (2, 3, 8))},
                "image_encoder_lora": {"c_fc": {
                    "lora_A": rng.standard_normal(lead + (2, 8, RANK)),
                    "lora_S": rng.standard_normal(lead + (2, G, RANK))}},
                "__bn_stats__": {"layer1": [{"bn1": {"mean": rng.standard_normal(lead + (5,))}}]}}
    f32 = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    return f32(state(())), f32(state((N_USERS,))), f32(state((m,)))


AGG_CASES = [("ema_personal", True, True, False), ("ema_personal", True, False, True),
             ("ema_personal", False, True, False), ("fedavg", False, False, False),
             ("prompt_personal", False, False, False), ("local_personal", False, False, False),
             ("fedavg_personal", False, False, True), ("fedavg_personal", False, False, False)]


@pytest.mark.parametrize("mode,group_w,shared_half_s,local_s", AGG_CASES,
                         ids=[f"{m}{'-groupw' if g else ''}{'-halfs' if h else ''}"
                              f"{'-locals' if s else ''}" for m, g, h, s in AGG_CASES])
def test_aggregation_matches_jax_runner(mode, group_w, shared_half_s, local_s):
    rng = np.random.default_rng(7)
    idxs, test_users, train_users = [2, 0], [0, 1, 2, 3], [0]
    g_tree, p_tree, t_tree = _trees(rng, len(idxs))
    weights = np.asarray([0.3, 0.7], np.float32)
    gw = rng.uniform(0.1, 0.9, (len(idxs), G)).astype(np.float32) if group_w else None
    keep = np.asarray([i in train_users and i in test_users for i in idxs])
    beta = 0.999 * (1 / 3)

    attrs = dict(num_groups=G, avg_prompt=AVG_PROMPT, local_s=local_s,
                 shared_half_s=shared_half_s, num_users=N_USERS)
    jr = jdriver.ParallelRoundRunner.__new__(jdriver.ParallelRoundRunner)
    jr.__dict__.update(attrs, _agg_fns={})
    o_stub = {"m": np.zeros((N_USERS, 2), np.float32)}
    t_stub = {"m": np.ones((len(idxs), 2), np.float32)}
    args = [jnp.asarray(weights)] + ([jnp.asarray(gw)] if group_w else []) + [
        jnp.float32(beta), jnp.asarray(idxs, jnp.int32), jnp.asarray(test_users, jnp.int32),
        jnp.asarray(keep)]
    want_g, want_p, want_o = jr._agg_fn(mode, group_w)(t_tree, g_tree, p_tree, o_stub, t_stub,
                                                        *args)

    tr = tdriver.ParallelRoundRunner.__new__(tdriver.ParallelRoundRunner)
    tr.__dict__.update(attrs)
    to_t = lambda tree: {k: torch.tensor(np.asarray(v)) for k, v in jflatten(tree).items()}  # noqa
    tr.global_t, tr.personal_t = to_t(g_tree), to_t(p_tree)
    got_g, got_p = tr._aggregate(
        mode, to_t(t_tree), torch.tensor(weights), None if gw is None else torch.tensor(gw),
        beta, torch.tensor(idxs), torch.tensor(test_users), torch.tensor(keep))
    for got, want in ((got_g, want_g), (got_p, want_p)):
        want = jflatten(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0,
                                       err_msg=k)
    np.testing.assert_array_equal(np.asarray(want_o["m"])[idxs], t_stub["m"])


def test_parallel_helpers_match_jax():
    rng = np.random.default_rng(9)
    g_tree, _, t_tree = _trees(rng, 2)
    local = _trees(rng, 2)[0]
    as_t = lambda tree: {k: torch.tensor(np.asarray(v))  # noqa: E731
                         for k, v in jflatten(tree).items()}

    def close(got, want):
        want = jflatten(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)

    close(tparallel.apply_shared_half_s(as_t(g_tree), G), jparallel.apply_shared_half_s(g_tree, G))
    close(tparallel.ema_blend(as_t(g_tree), as_t(local), 0.4),
          jparallel.ema_blend(g_tree, local, 0.4))
    per_client = [jax.tree_util.tree_map(lambda x, i=i: x[i], t_tree) for i in range(2)]
    for local_s in (False, True):  # over the client axis: the JAX one per client, stacked
        close(tparallel.personalize(as_t(g_tree), as_t(t_tree), AVG_PROMPT, local_s),
              jparallel.stack_clients([jparallel.personalize(g_tree, t, AVG_PROMPT, local_s)
                                       for t in per_client]))
        # a stacked global: each client blends with its own row of it
        other = _trees(rng, 2)[2]
        close(tparallel.personalize(as_t(other), as_t(t_tree), AVG_PROMPT, local_s),
              jparallel.stack_clients([
                  jparallel.personalize(jax.tree_util.tree_map(lambda x, i=i: x[i], other), t,
                                        AVG_PROMPT, local_s)
                  for i, t in enumerate(per_client)]))
    close(tparallel.stack_clients([as_t(t) for t in per_client]),
          jparallel.stack_clients(per_client))
    # the runner's weighted mean (group weights on the lora_S leaf only)
    w, gw = torch.tensor([0.25, 0.75]), torch.tensor([[0.2, 0.5, 0.9], [0.8, 0.5, 0.1]])
    mean = tparallel.client_weighted_mean(as_t(t_tree), w, gw, G)
    flat = {k: np.asarray(v) for k, v in jflatten(t_tree).items()}
    s_key = "image_encoder_lora.c_fc.lora_S"
    np.testing.assert_allclose(mean[s_key].numpy(), (flat[s_key] * gw.numpy()[:, None, :, None])
                               .sum(0), atol=1e-6)
    np.testing.assert_allclose(mean["prompt_learner.ctx"].numpy(),
                               (flat["prompt_learner.ctx"] * w.numpy()[:, None, None, None]).sum(0),
                               atol=1e-6)
    # flatten_paths and unflatten_like invert each other on dicts and lists
    tree = as_t(g_tree)
    nested = unflatten_like({"a": [{"b": 0}, {"c": 0}]}, {"a.0.b": 1, "a.1.c": 2})
    assert nested == {"a": [{"b": 1}, {"c": 2}]} and flatten_paths(nested) == {"a.0.b": 1,
                                                                               "a.1.c": 2}
    assert sorted(tree) == sorted(jflatten(g_tree))


@pytest.mark.parametrize("epoch,frac,train", [(0, 0.5, []), (1, 0.5, []), (3, 0.3, []),
                                              (2, 0.5, [3, 1])])
def test_sample_clients_matches_jax(epoch, frac, train):
    draws = {}
    for name, mod in (("jax", jsampler), ("port", tsampler)):
        np.random.seed(4)
        draws[name] = [mod.sample_clients(10, frac, epoch + r, idxs_users_train=train)
                       for r in range(3)]
    assert draws["port"] == draws["jax"]
    assert all(isinstance(i, (int, np.integer)) for d in draws["port"] for i in d)


def test_runner_pads_rows_like_jax():
    for n, rows in ((3, 5), (4, 4), (2, 7)):
        arr = np.arange(n * 2).reshape(n, 2)
        np.testing.assert_array_equal(tdriver._pad_rows(arr, rows), jdriver._pad_rows(arr, rows))
