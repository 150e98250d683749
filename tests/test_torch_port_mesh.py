"""The port's rank grid (``core/mesh.py``), its process-group helpers
(``fed/dist.py``) and ``fed/parallel.py:make_parallel_round`` against the JAX
package's.

* ``mesh_shape`` / ``build_mesh`` give the JAX runner's ``(clients, data)``
  mesh (``ParallelRoundRunner._mesh`` over the first ``n`` of the 8 CPU
  devices) for ``n`` 1-8 ranks, ``m`` 1-8 clients, batch 1/2/4/6/32, with
  and without a data axis, and JAX ``core.mesh.build_mesh``'s where the
  batch does not bind; the grid's ranks are the JAX mesh's device ids.
* The helpers answer as one process with no group.
* ``make_parallel_round`` on 2 gloo ranks (this file run as a script under
  ``python -m torch.distributed.run``) against JAX ``make_parallel_round``
  on ``devices[:2]``: 2 clients, 2 SGD-with-momentum steps each, group
  weights on ``lora_S``, ``shared_half_s``, EMA; every output within 1e-6
  (fp32).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
C, G, RANK, D_IN, N_CTX, STEPS, BATCH = 2, 3, 4, 8, 2, 2, 6
LR, MOMENTUM, EPOCH, MAX_EPOCH = 0.1, 0.9, 5, 50
TOL = 1e-6

torch.set_num_threads(1)


def round_inputs():
    """Two clients, a global state, their batches and weights (numpy)."""
    def client(seed):
        rng = np.random.default_rng(seed)
        return {"prompt_learner.ctx": rng.normal(size=(2, N_CTX, D_IN)).astype(np.float32),
                "adapter.lora_S": rng.normal(size=(G, RANK)).astype(np.float32),
                "adapter.lora_A": rng.normal(size=(D_IN, RANK)).astype(np.float32)}

    clients = [client(i) for i in range(C)]
    rng = np.random.default_rng(0)
    by_attr = np.array([[1, 2, 3], [4, 5, 6]], np.float64)
    counts = np.array([10.0, 30.0])
    return {"stacked": {k: np.stack([c[k] for c in clients]) for k in clients[0]},
            "global": client(99),
            "x": rng.normal(size=(C, STEPS, BATCH, D_IN)).astype(np.float32),
            "y": rng.normal(size=(C, STEPS, BATCH)).astype(np.float32),
            "weights": (counts / counts.sum()).astype(np.float32),
            "group_w": (by_attr / by_attr.sum(0, keepdims=True)).astype(np.float32),
            "beta_decay": np.float32(0.999 * EPOCH / MAX_EPOCH)}


def _loss(ctx, s, a, x, y, mean, matmul):
    w = matmul(a, s.mean(0)[:, None])
    pred = matmul(x, w)[:, 0] + ctx.mean()
    return mean((pred - y) ** 2)


def _rank_main(out_dir):
    """One rank of the port's round (run under torchrun)."""
    import torch.distributed as dist

    from fairfedmed_tpu_torch.core.mesh import build_mesh
    from fairfedmed_tpu_torch.fed.parallel import make_parallel_round

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    inp = round_inputs()
    mesh = build_mesh(C, dist.get_world_size(), BATCH, rank=rank)

    def local_step(t, o, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in t.items()}
        loss = _loss(leaves["prompt_learner.ctx"], leaves["adapter.lora_S"],
                     leaves["adapter.lora_A"], batch["x"], batch["y"], torch.mean, torch.matmul)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        trace = {k: grads[k] + MOMENTUM * o[k] for k in o}  # optax.sgd's trace
        return ({k: t[k] - LR * trace[k] for k in t}, trace, loss.detach())

    round_fn = make_parallel_round(mesh, local_step, num_groups=G, avg_prompt=1,
                                   local_s=False, shared_half_s=True)
    tt = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    stacked = {k: tt(v) for k, v in inp["stacked"].items()}
    personal, opt, new_global, loss = round_fn(
        stacked, {k: torch.zeros_like(v) for k, v in stacked.items()},
        {k: tt(v) for k, v in inp["global"].items()}, {"x": tt(inp["x"]), "y": tt(inp["y"])},
        tt(inp["weights"]), tt(inp["group_w"]), float(inp["beta_decay"]))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), loss=loss.numpy(),
             **{f"personal.{k}": v.numpy() for k, v in personal.items()},
             **{f"opt.{k}": v.numpy() for k, v in opt.items()},
             **{f"global.{k}": v.numpy() for k, v in new_global.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from fairfedmed_tpu.core import mesh as jmesh  # noqa: E402
from fairfedmed_tpu.fed import parallel as jparallel  # noqa: E402
from fairfedmed_tpu.fed import parallel_driver as jdriver  # noqa: E402
from fairfedmed_tpu_torch.core import mesh as tmesh  # noqa: E402
from fairfedmed_tpu_torch.fed import dist as tdist  # noqa: E402
from fairfedmed_tpu_torch.fed import parallel as tparallel  # noqa: E402


def _jax_runner_mesh(monkeypatch, n, m, batch, data_axis_ok):
    """The JAX runner's mesh for an ``m``-client round on ``n`` devices."""
    devices = jax.devices()[:n]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    cfg = type("Cfg", (), {"DATALOADER": type("D", (), {
        "TRAIN_X": type("T", (), {"BATCH_SIZE": batch})})})
    runner = type("R", (), {"_meshes": {}, "cfg": cfg,
                            "trainer": type("Tr", (), {"supports_data_axis": data_axis_ok})})()
    return jdriver.ParallelRoundRunner._mesh(runner, m)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_the_jax_runner(monkeypatch, n):
    assert len(jax.devices()) >= 8
    for m in range(1, 9):
        for batch in (1, 2, 4, 6, 32):
            for ok in (True, False):
                with monkeypatch.context() as mp:
                    jm = _jax_runner_mesh(mp, n, m, batch, ok)
                c, d = tmesh.mesh_shape(m, n, batch, ok)
                assert (c, d) == (jm.shape[tmesh.CLIENT_AXIS], jm.shape[tmesh.DATA_AXIS]), \
                    (n, m, batch, ok)
                grid = tmesh.build_mesh(m, n, batch, ok).ranks
                assert np.array_equal(grid, np.vectorize(lambda dev: dev.id)(jm.devices))
        jm = jmesh.build_mesh(m, devices=jax.devices()[:n])
        assert tmesh.mesh_shape(m, n) == (jm.shape[jmesh.CLIENT_AXIS], jm.shape[jmesh.DATA_AXIS])


def test_rank_mesh_rows_and_idle_ranks():
    # 4 clients over 8 ranks: 4 shards of 2 ranks, batch 32 in halves
    mesh = tmesh.build_mesh(4, 8, 32, rank=5)
    assert (mesh.c, mesh.d, mesh.coord) == (4, 2, (2, 1))
    assert list(mesh.own_clients) == [2] and mesh.batch_rows(1) == slice(16, 32)
    # 6 clients over 4 ranks: 2 shards of 3 clients; 2 ranks per shard
    mesh = tmesh.build_mesh(6, 4, 4, rank=1)
    assert (mesh.c, mesh.d, list(mesh.client_rows(1))) == (2, 2, [3, 4, 5])
    # 3 clients over 2 ranks without a data axis: rank 1 idles
    mesh = tmesh.build_mesh(3, 2, 32, data_axis_ok=False, rank=1)
    assert (mesh.c, mesh.d, mesh.coord, list(mesh.own_clients)) == (1, 1, None, [])
    assert mesh.data_group is None and mesh.client_group is None  # no process group here


def test_dist_helpers_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not tdist.is_initialized()
    assert (tdist.get_world_size(), tdist.get_rank(), tdist.get_local_rank(),
            tdist.get_local_size(), tdist.get_local_device_count(),
            tdist.get_global_device_count()) == (1, 0, 0, 1, 1, 1)
    assert tdist.is_main_process() and tdist.backend() is None
    assert tdist.init_from_env("cpu") == torch.device("cpu") and not tdist.is_initialized()
    tdist.shutdown()
    x = [torch.ones(2), torch.arange(3)]
    assert all(a is b for a, b in zip(tdist.all_reduce_sum(x, None), x))


def test_init_from_env_wants_a_card_per_rank(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        tdist.init_from_env("cuda")
    assert not tdist.is_initialized()


def test_make_parallel_round_wants_one_client_per_shard():
    mesh = tmesh.build_mesh(2, 2, rank=0)
    round_fn = tparallel.make_parallel_round(mesh, lambda t, o, b: (t, o, torch.zeros(())))
    four = {"w": torch.zeros(4, 3)}
    with pytest.raises(ValueError, match="shards"):
        round_fn(four, four, {"w": torch.zeros(3)}, {"x": torch.zeros(4, 1, 2)},
                 torch.full((4,), 0.25), None, 0.0)


def test_make_parallel_round_on_two_ranks_matches_jax(tmp_path):
    inp = round_inputs()

    def nest(flat):
        return {"prompt_learner": {"ctx": jnp.asarray(flat["prompt_learner.ctx"])},
                "adapter": {"lora_S": jnp.asarray(flat["adapter.lora_S"]),
                            "lora_A": jnp.asarray(flat["adapter.lora_A"])}}

    tx = optax.sgd(LR, momentum=MOMENTUM)

    def local_step(t, o, frozen, batch):
        loss, grads = jax.value_and_grad(
            lambda t_: _loss(t_["prompt_learner"]["ctx"], t_["adapter"]["lora_S"],
                             t_["adapter"]["lora_A"], batch["x"], batch["y"], jnp.mean,
                             jnp.matmul))(t)
        updates, o = tx.update(grads, o, t)
        return optax.apply_updates(t, updates), o, loss

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:C]).reshape(C, 1),
                             (jmesh.CLIENT_AXIS, jmesh.DATA_AXIS))
    round_fn = jparallel.make_parallel_round(mesh, local_step, num_groups=G, avg_prompt=1,
                                             local_s=False, shared_half_s=True)
    stacked = nest(inp["stacked"])
    opt = jax.vmap(tx.init)(stacked)
    new_t, new_o, new_global, loss = round_fn(
        jparallel.shard_stacked(stacked, mesh), jparallel.shard_stacked(opt, mesh), {},
        nest(inp["global"]), {"x": jnp.asarray(inp["x"]), "y": jnp.asarray(inp["y"])},
        jnp.asarray(inp["weights"]), jnp.asarray(inp["group_w"]), jnp.float32(inp["beta_decay"]))
    flat = lambda tree: {f"{a}.{b}": np.asarray(v) for a, d in tree.items()  # noqa: E731
                         for b, v in d.items()}
    want_t, want_g = flat(new_t), flat(new_global)
    want_o = flat(new_o[0].trace)

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(C), str(Path(__file__).resolve()),
                          str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    for r in range(C):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            np.testing.assert_allclose(z["loss"], np.asarray(loss), atol=TOL, rtol=0)
            for k in want_g:
                np.testing.assert_allclose(z[f"global.{k}"], want_g[k], atol=TOL, rtol=0)
                np.testing.assert_allclose(z[f"personal.{k}"], want_t[k][r:r + 1], atol=TOL,
                                           rtol=0, err_msg=k)
                np.testing.assert_allclose(z[f"opt.{k}"], want_o[k][r:r + 1], atol=TOL, rtol=0)
