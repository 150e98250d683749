"""The client-parallel local step replayed from a CUDA graph
(``fairfedmed_tpu_torch/train/graphed.py``) against the eager step.

On the CPU (no capture there): ``GraphedStep(step, "cpu")`` runs the
static-buffer plumbing with the eager step on the flat buffer's views, and
its outputs equal the plain step's bit for bit at the benchmark's tiny ViT
and RN50 configurations, as does a whole round of the runner;
``FunctionalOptimizer.update`` gives the same bits with the learning rate as
a float32 0-dim tensor as with the host float, for every optimizer; the
runner picks the eager step on the CPU, for host batches, with a data group,
with FedProx, and for OT other than None.

On the card (``gpu``): the graphed step, captured and replayed, equals the
eager step bit for bit at the two published configurations of
``benchmark/configs/`` (ViT-B/16 and RN50 FairLoRA, bf16), two clients
alternating runs of steps from a state with carried momentum and moved
BatchNorm statistics, at two later epochs' learning rates; every tensor a
call returned is unchanged after the other client's later replays.  Run it
on the card with

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_graph_step.py -q -m gpu

(``chip_smoke.py graph_step`` runs the same check and reports it).
"""

import contextlib
import io
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fairfedmed_tpu_torch.fed import parallel_driver as pdriver  # noqa: E402
from fairfedmed_tpu_torch.train import optim as toptim  # noqa: E402
from fairfedmed_tpu_torch.train.graphed import ALIGN, FlatLayout, GraphedStep  # noqa: E402
from fairfedmed_tpu_torch.train.trainers.glp_ot import GLPOTBase  # noqa: E402

torch.set_num_threads(1)

# client, batch: two clients alternating runs of steps (batch 0 of each
# gives the start state its carried momentum)
SCHEDULE = ((0, 1), (0, 2), (1, 1), (1, 2), (0, 3), (1, 3))
COPIES_IN = 4  # the schedule's calls whose state is not the previous call's output
LR_EPOCHS = (80, 82)  # later epochs' learning rates, one per client
_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


# --------------------------------------------------------------------------- #
# building a runner as the benchmark does
# --------------------------------------------------------------------------- #

def build_cell_runner(cell, device, workdir, seed, **traffic):
    """The client-parallel runner of a benchmark cell, built as
    ``benchmark/harness.py`` builds it (the configuration's launcher flags,
    a checkpoint and a fixture drawn from ``seed``), the traffic's counts
    replaced by ``traffic``."""
    from benchmark import harness, inputs
    from fairfedmed_tpu_torch import federated_main as fm

    device = torch.device(device)
    root = os.path.join(workdir, "data")
    cell_traffic = dict(cell.traffic, **traffic)
    inputs.write_fixture(root, cell_traffic, seed)
    ckpt = inputs.checkpoint_file(root, cell.config["backbone"])
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save(inputs.make_checkpoint(cell.config["arch"], seed, device, cell.config.get("init")),
               ckpt)
    args = fm.build_arg_parser().parse_args(
        harness.build_argv(cell, root, os.path.join(workdir, "out"), seed))
    args.idxs_users_train = fm._int_list(args.idxs_users_train)
    args.idxs_users_test = fm._int_list(args.idxs_users_test)
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's tables
        cfg = fm.setup_cfg(args)
        trainer = fm.build_trainer(cfg, device=device)
        users = range(cfg.DATASET.USERS)
        sets = [trainer.fed_train_loader_x_dict[i].dataset for i in users]
        runner = fm._build_runner(cfg, args, trainer, [len(d) for d in sets],
                                  [d.count_by_attribute(args.attribute_type) for d in sets])
    return runner


def tiny_cell(kind):
    """The benchmark's own tiny ``vit`` / ``rn`` cell (fp32, 32 px), at
    batch 8."""
    from benchmark import spec

    data = spec.HERE / "tests" / "data"
    bench = {"configs": [{"name": f"tiny_{kind}",
                          "file": f"benchmark/tests/data/configs/tiny_{kind}.json"}],
             "workloads": [{"name": f"tiny_{kind}_slo", "config": f"tiny_{kind}",
                            "traffic": "tiny_slo", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    cell = spec.load_cell(f"tiny_{kind}_slo", bench, root=data)
    cell.config["flags"] = {**cell.config["flags"], "--train_batch_size": "8"}
    return cell


# --------------------------------------------------------------------------- #
# the comparison
# --------------------------------------------------------------------------- #

def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(_INT[t.element_size()]) if t.is_floating_point() else t


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _flat(out) -> dict:
    """One call's (params, opt_state, metrics) as one dict."""
    p, o, m = out
    return {**{f"p:{k}": v for k, v in p.items()}, **{f"o:{k}": v for k, v in o.items()},
            "metrics": m}


def _differs(a: dict, b: dict) -> list:
    """The leaves of two calls' outputs whose bits differ, with their
    largest absolute difference."""
    return [(k, float((a[k].double() - b[k].double()).abs().max()))
            for k in a if not same_bits(a[k], b[k])]


def run_schedule(step, starts, batches, lrs):
    """The schedule's calls of ``step`` from the clients' ``starts``:
    each call's outputs as returned and as copied right after the call,
    and whether every call returned new dicts."""
    state = dict(starts)
    returned, copied, fresh = [], [], True
    for c, i in SCHEDULE:
        p, o = state[c]
        out = step(p, o, batches[c][i], lrs[c])
        fresh &= out[0] is not p and out[1] is not o
        state[c] = out[:2]
        returned.append(out)
        copied.append(_flat((_clone(out[0]), _clone(out[1]), out[2].detach().clone())))
    return returned, copied, fresh


def graph_against_eager(runner, graphed, repeat: bool = True) -> dict:
    """``graphed`` (a :class:`GraphedStep`, its first call still to come)
    against the runner's eager step over :data:`SCHEDULE`: clients 0 and
    1, their start states after one eager step on their batch 0 at their
    learning rates (so momentum is carried and BatchNorm statistics moved),
    the batches gathered from the runner's device caches.  The eager step
    runs the schedule (with ``repeat`` twice: its own repeatability), then
    the graphed one (with ``repeat`` twice: capture, then replays only).
    Returns per call the leaves that differ, the contract's checks, the
    counts of copies in and replays, and host and wall times."""
    trainer = runner.trainer
    plain = graphed.eager
    lrs = [trainer.lr_sched.lr(e) for e in LR_EPOCHS]
    streams, n_steps = runner._round_batches_device([0, 1])
    if streams is None or min(n_steps) < 4:
        raise RuntimeError(f"the fixture gives clients 0 and 1 {n_steps} cached steps, "
                           "fewer than the 4 the schedule takes")
    batches = [[streams[c](i) for i in range(4)] for c in (0, 1)]
    starts = {}
    for c in (0, 1):
        p, o, _ = plain(runner._row(runner.personal_t, c), runner._row(runner.stacked_o, c),
                        batches[c][0], lrs[c])
        starts[c] = (_clone(p), _clone(o))

    def timed(step):
        sync = runner.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_schedule(step, starts, batches, lrs)
        host = time.perf_counter() - t
        if sync:
            torch.cuda.synchronize()
        return out, host, time.perf_counter() - t

    (_, eager, _), eager_host, eager_wall = timed(plain)
    again = timed(plain)[0][1] if repeat else eager
    (returned, graph, fresh), graph_host, graph_wall = timed(graphed)  # capture included
    (_, replay, _), replay_host, replay_wall = (timed(graphed) if repeat  # replays only
                                                else ((None, graph, None), graph_host, graph_wall))
    unchanged = all(same_bits(v, snap[k]) for out, snap in zip(returned, graph)
                    for k, v in _flat(out).items())
    calls = len(SCHEDULE)
    return {
        "calls": calls, "leaves": len(eager[0]),
        "eager_repeat_differs": [_differs(a, b) for a, b in zip(eager, again)],
        "graph_differs": [_differs(g, e) for g, e in zip(graph, eager)],
        "replay_differs": [_differs(g, e) for g, e in zip(replay, eager)],
        "returned_unchanged": unchanged, "new_dicts": fresh,
        "copies_in": graphed.copies_in, "replays": sum(g.replays for g in graphed.graphs.values()),
        "graphs": len(graphed.graphs), "static_bytes": graphed.layout.nbytes,
        "moved": max(float((e[k].double() - starts[0][0][k[2:]].double()).abs().max())
                     for e in eager[:1] for k in e if k.startswith("p:")),
        "eager_host_ms_per_call": 1e3 * eager_host / calls,
        "eager_wall_ms_per_call": 1e3 * eager_wall / calls,
        "capture_and_replay_wall_ms": 1e3 * graph_wall,
        "replay_host_ms_per_call": 1e3 * replay_host / calls,
        "replay_wall_ms_per_call": 1e3 * replay_wall / calls,
    }


def assert_graph_equals_eager(res: dict) -> None:
    differs = [d for d in res["graph_differs"] + res["replay_differs"] if d]
    assert not differs, (res["eager_repeat_differs"], differs)
    assert res["returned_unchanged"] and res["new_dicts"], res
    assert res["moved"] > 0, res


# --------------------------------------------------------------------------- #
# CPU: the plumbing, the learning rate, the selector
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny_runners(tmp_path_factory):
    out = {}
    for kind in ("vit", "rn"):
        out[kind] = build_cell_runner(tiny_cell(kind), "cpu",
                                      str(tmp_path_factory.mktemp(f"graph_{kind}")), 2 ** 31 + 5,
                                      train_per_site=32, test_per_site=4)
    return out


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_flat_state_step_equals_plain_step(kind, tiny_runners):
    runner = tiny_runners[kind]
    assert not isinstance(runner._steps[(None, None)], GraphedStep)  # eager on the CPU
    graphed = GraphedStep(runner._steps[(None, None)], "cpu")
    res = graph_against_eager(runner, graphed, repeat=False)
    assert_graph_equals_eager(res)
    # a copy in only where the clients switch; one layout, one batch signature
    assert res["copies_in"] == COPIES_IN and res["graphs"] == 1
    assert res["replays"] == len(SCHEDULE)
    if kind == "rn":
        assert any(k.startswith("__bn_stats__.") for k in runner.personal_t)


def test_flat_layout_aligns_every_leaf():
    trees = {"params": {"a": torch.zeros(3, 5), "b": torch.zeros((), dtype=torch.int32),
                        "c": torch.zeros(7)},
             "opt": {"count": torch.zeros((), dtype=torch.int32), "t:a": torch.zeros(3, 5)}}
    layout = FlatLayout(trees)
    buf = torch.arange(layout.nbytes, dtype=torch.int64).to(torch.uint8)
    views = layout.views(buf)
    for name, tree in trees.items():
        assert list(views[name]) == list(tree)  # the trees' own key order
        for k, v in tree.items():
            w = views[name][k]
            assert w.shape == v.shape and w.dtype == v.dtype and w.is_contiguous()
            assert (w.data_ptr() - buf.data_ptr()) % ALIGN == 0
            assert w.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
    # no two leaves overlap
    spans = sorted((w.data_ptr(), w.data_ptr() + w.numel() * w.element_size())
                   for tree in views.values() for w in tree.values())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_graphed_step_refuses_a_fedprox_context(tiny_runners):
    runner = tiny_runners["vit"]
    graphed = GraphedStep(runner._steps[(None, None)], "cpu")
    p, o = runner._row(runner.personal_t, 0), runner._row(runner.stacked_o, 0)
    with pytest.raises(ValueError, match="FedProx"):
        graphed(p, o, {}, 1e-3, ctx_global=torch.zeros(1))


OPTIMS = [("sgd", 0.9, False), ("sgd", 0.9, True), ("sgd", 0.0, False), ("adam", 0.9, False),
          ("amsgrad", 0.9, False), ("rmsprop", 0.9, False), ("rmsprop", 0.0, False),
          ("radam", 0.9, False), ("adamw", 0.9, False)]


@pytest.mark.parametrize("name,momentum,nesterov", OPTIMS,
                         ids=[f"{n}-m{m}{'-nesterov' if v else ''}" for n, m, v in OPTIMS])
def test_update_with_a_device_scalar_lr_equals_the_float_lr(name, momentum, nesterov):
    cfg = types.SimpleNamespace(NAME=name, WEIGHT_DECAY=5e-4, MOMENTUM=momentum,
                                SGD_NESTEROV=nesterov, ADAM_BETA1=0.9, ADAM_BETA2=0.999,
                                RMSPROP_ALPHA=0.99)
    opt = toptim.FunctionalOptimizer(cfg)
    gen = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(3, 4, generator=gen), "b.c": torch.randn(5, generator=gen),
         "s": torch.randn((), generator=gen)}
    floats = tensors = (p, opt.init(p))
    lr_t = torch.zeros((), dtype=torch.float32)
    for i in range(8):
        lr = 0.01 * (1 + np.cos(np.pi * (40 + 7 * i) / 97)) / 2  # not a float32 value
        g = {k: v * 0.5 + torch.randn(v.shape, generator=gen) for k, v in floats[0].items()}
        floats = opt.update(*floats[:1], g, floats[1], lr)
        lr_t.fill_(lr)
        tensors = opt.update(*tensors[:1], g, tensors[1], lr_t)
        for tree_f, tree_t in zip(floats, tensors):
            assert list(tree_f) == list(tree_t)
            for k in tree_f:
                assert same_bits(tree_f[k], tree_t[k]), (name, i, k)
        tensors = floats  # both go on from the same state
    assert int(floats[1]["count"]) == 8


@pytest.mark.parametrize("device,graphable,fedprox_mu,data_group,want", [
    ("cuda", True, None, None, True),
    ("cpu", True, None, None, False),
    ("cuda", False, None, None, False),
    ("cuda", True, 0.5, None, False),
    ("cuda", True, None, object(), False),
], ids=["card", "cpu", "not_graphable", "fedprox", "data_group"])
def test_graphs_step_selector(device, graphable, fedprox_mu, data_group, want):
    trainer = types.SimpleNamespace(parallel_step_graphable=graphable)
    assert pdriver.graphs_step(torch.device(device), trainer, fedprox_mu, data_group) is want
    # a trainer that says nothing is not graphed
    assert not pdriver.graphs_step(torch.device(device), object(), fedprox_mu, data_group)


@pytest.mark.parametrize("ot,want", [("None", True), ("Sinkhorn", False), ("COT", False)])
def test_only_a_step_without_ot_is_graphable(ot, want):
    trainer = types.SimpleNamespace(
        cfg=types.SimpleNamespace(TRAINER=types.SimpleNamespace(GLP_OT=types.SimpleNamespace(OT=ot))))
    assert GLPOTBase.parallel_step_graphable.fget(trainer) is want


class _Counting:
    """A step wrapper that counts its calls."""

    def __init__(self, step):
        self.step, self.calls = step, 0

    def __call__(self, *args):
        self.calls += 1
        return self.step(*args)


def test_host_batches_take_the_eager_step(tiny_runners):
    runner = tiny_runners["vit"]
    plain = runner._steps[(None, None)]
    eager = _Counting(plain)
    graphed = GraphedStep(eager, "cpu")
    saved = runner._steps[(None, None)]
    try:
        runner._steps[(None, None)] = graphed
        assert runner._local_step(None, None, cached=True) is graphed
        assert runner._local_step(None, None, cached=False) is eager
        # a whole round on host batches (the device caches refused) runs the
        # eager step and never the graphed one
        budget, caches = runner._cache_budget, (runner._data_cache, runner._train_host)
        runner._cache_budget, runner._data_cache, runner._train_host = 0, {}, {}
        try:
            runner.run_round(1, [0, 1], 10, test_users=[0, 1, 2])
        finally:
            runner._cache_budget = budget
            runner._data_cache, runner._train_host = caches
        assert eager.calls > 0 and not graphed.graphs
    finally:
        runner._steps[(None, None)] = saved


def test_a_round_with_the_flat_state_equals_the_plain_round(tiny_runners):
    """A whole deferred round (two clients trained, aggregated, the
    optimizer state scattered) with the graph's plumbing equals the plain
    round bit for bit."""
    runner = tiny_runners["vit"]
    plain = runner._steps[(None, None)]
    saved = (runner.global_t, runner.personal_t, runner.stacked_o, runner.trainer._lr_steps)
    out = {}
    for name in ("plain", "flat"):
        runner.global_t, runner.personal_t, runner.stacked_o, runner.trainer._lr_steps = saved
        runner._steps[(None, None)] = plain if name == "plain" else GraphedStep(plain, "cpu")
        np.random.seed(11)
        handle = runner.run_round(3, [0, 2], 10, test_users=[0, 1, 2], deferred=True)
        out[name] = {"global": runner.global_t, "personal": runner.personal_t,
                     "opt": runner.stacked_o, "metrics": {"m": handle["metrics"]}}
    runner._steps[(None, None)] = plain
    runner.global_t, runner.personal_t, runner.stacked_o, runner.trainer._lr_steps = saved
    for part in out["plain"]:
        for k, v in out["plain"][part].items():
            assert same_bits(v, out["flat"][part][k]), (part, k)


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_returned_metrics_hold_no_copy_of_the_state(kind, tiny_runners):
    """A step's metrics, which ``run_round`` keeps for every step of the
    round, own a storage the size of the metrics alone: keeping them keeps
    no copy of the parameters or the optimizer state alive."""
    runner = tiny_runners[kind]
    graphed = GraphedStep(runner._steps[(None, None)], "cpu")
    streams, _ = runner._round_batches_device([0])
    p, o = runner._row(runner.personal_t, 0), runner._row(runner.stacked_o, 0)
    kept = []
    for i in range(3):
        p, o, m = graphed(p, o, streams[0](i), 1e-3)
        kept.append(m)
    state = p[next(iter(p))].untyped_storage().data_ptr()
    for m in kept:
        assert m.untyped_storage().nbytes() == m.numel() * m.element_size()
        assert m.untyped_storage().data_ptr() != state


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vit_slo_fairlora", "rn50_slo_fairlora"])
def test_graphed_step_equals_eager_on_the_card(name, card, tmp_path):
    from benchmark import spec

    runner = build_cell_runner(spec.load_cell(name), card, str(tmp_path), 2 ** 31 + 29,
                               train_per_site=128, test_per_site=8)
    graphed = runner._steps[(None, None)]
    assert isinstance(graphed, GraphedStep) and not graphed.graphs
    res = graph_against_eager(runner, graphed)
    assert_graph_equals_eager(res)
    assert res["copies_in"] == 2 * COPIES_IN and res["graphs"] == 1
